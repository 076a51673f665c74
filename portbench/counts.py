"""Work counts of the model's published shapes, and the card's peaks.

Counted from the layer list of the architecture's reference
(``portbench/reference/<arch>.py``), never from the program's launches, so
a change of the program's implementation leaves this yardstick alone.  Per
layer and sample: each int8 activation element the layer states it reads
(``elems_read``: its input, and a second tensor such as a residual) read
once, each it writes (``elems_written``) written once; per call the int8
weights and int32 bias read once; operations are 2 x MACs.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense: int8 tensor-core operations and HBM3
# bandwidth, at the card's full 700 W power limit
PEAK_INT8_OPS_S = 1979e12
PEAK_BYTES_S = 3.35e12


def layer_ops(lyr, batch: int) -> float:
    return 2.0 * lyr.macs * batch


def layer_bytes(lyr, batch: int) -> float:
    act = lyr.elems_read + lyr.elems_written
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
