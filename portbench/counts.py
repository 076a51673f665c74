"""Work counts of the model's published shapes, and the card's peaks.

Counted from the layer list of ``portbench/reference`` (Table 2 of
MobileNetV2), never from the program's launches, so a change of the
program's implementation leaves this yardstick alone.  Per layer and
sample: the int8 input read once (and the residual added to it, where
there is one), the int8 output written once; per call the int8 weights and
int32 bias read once; operations are 2 x MACs.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: int8 tensor-core operations and HBM3
# bandwidth, at the card's full 700 W power limit
PEAK_INT8_OPS_S = 1979e12
PEAK_BYTES_S = 3.35e12


def layer_ops(lyr, batch: int) -> float:
    return 2.0 * lyr.macs * batch


def layer_bytes(lyr, batch: int) -> float:
    n_in = lyr.cin * lyr.in_hw[0] * lyr.in_hw[1]
    n_out = lyr.cout * lyr.out_hw[0] * lyr.out_hw[1]
    act = n_in + n_out + (n_out if lyr.residual_from else 0)
    params = 0
    if lyr.weight_shape is not None:
        w = 1
        for d in lyr.weight_shape:
            w *= d
        params = w + 4 * lyr.cout
    return float(batch * act + params)


def least_s(lyr, batch: int) -> float:
    """The least time of one call of ``lyr`` at ``batch``: operations at the
    int8 peak or bytes at the memory peak, whichever is longer."""
    return max(layer_ops(lyr, batch) / PEAK_INT8_OPS_S,
               layer_bytes(lyr, batch) / PEAK_BYTES_S)


def least_s_of(lyrs, kinds, batch: int) -> float:
    return sum(least_s(lyr, batch) for lyr in lyrs if lyr.kind in kinds)


def total_macs(lyrs) -> int:
    return sum(lyr.macs for lyr in lyrs)
