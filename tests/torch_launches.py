"""The CNN engine's kernel calls, recorded as a forward makes them (no tests
here; the card's tests and ``chip_smoke.py`` import it).

:func:`recorded` swaps, for the length of its block, each kernel wrapper
that ``repro_torch.core.executor`` calls by name for a pass-through that
records the call.  :func:`census` walks one forward of a
``CompiledSplitExecutor`` under it and gives each call the block group it
belongs to, from the ``executor.block`` spans the walk records.
:func:`engine_launches` keys each call by its own arguments, and
:func:`on_cpu` runs it again on CPU copies of them (its plain version).
So the list of launches is the engine's own, and nothing outside the
engine repeats its choice of kernel, shape or layout.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

import torch

import repro_torch.core.executor as ex
from repro_torch import trace

# the kernel wrappers the engine calls by name
WRAPPERS = ("qgemm", "dwconv_bands_unpadded", "dwconv_shards", "se_pool",
            "se_gate", "band_windows", "band_take")
# the dispatch id of a census's spans: a Session's dispatch ids are >= 0
CENSUS_KEY = -1


@dataclasses.dataclass
class Call:
    """One call of a kernel wrapper: its name (the wrapper that counts the
    launch: ``dwconv3x3_bands`` or ``dwconv5x5_bands_unpadded`` for a band
    stack, ``dwconv3x3`` or ``dwconv5x5_shards`` for a flat layer's shards,
    by the weight's shape; the others as called), the wrapper, its
    arguments and keyword arguments, the host clock at the call and, in a
    census, the attributes of its block group's ``executor.block`` span
    (``first`` and ``last`` layer, ``mode``, ``kind``)."""

    name: str
    fn: object
    args: tuple
    kwargs: dict
    t_ns: int
    block: dict | None = None


def _name(wrapper: str, args: tuple) -> str:
    if wrapper == "dwconv_bands_unpadded":
        return ("dwconv5x5_bands_unpadded" if args[1].shape[-1] == 5
                else "dwconv3x3_bands")
    if wrapper == "dwconv_shards":
        return "dwconv5x5_shards" if args[2].shape[-1] == 5 else "dwconv3x3"
    return wrapper


@contextlib.contextmanager
def recorded():
    """Within the block, every call the engine makes of a kernel wrapper
    runs the wrapper as before and is appended, in order, to the list this
    yields (a :class:`Call` each)."""
    calls: list[Call] = []
    saved = {name: getattr(ex, name) for name in WRAPPERS}

    def recorder(wrapper, fn):
        def call(*args, **kwargs):
            calls.append(Call(_name(wrapper, args), fn, args, kwargs,
                              time.perf_counter_ns()))
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(ex, name, recorder(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(ex, name, fn)


def census(engine, x, mode: str = "int8") -> list[Call]:
    """Every kernel wrapper call of one walk of ``engine``'s forward of the
    batch ``x`` (a float32 tensor on the engine's device) in ``mode``,
    with ``_full_fp32`` held for float, in order, each with its block
    group's span attributes."""
    t0 = time.perf_counter_ns()
    fp32 = ex._full_fp32 if mode == "float" else contextlib.nullcontext
    with recorded() as calls, fp32():
        engine._forward(x, mode, CENSUS_KEY)
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    spans = [s for s in trace.spans(t0, time.perf_counter_ns())
             if s[0] == "executor.block" and s[1] == CENSUS_KEY]
    # each span starts where the one before it ends: a call belongs to the
    # first span that ends after it
    ends = [s[3] for s in spans]
    for c in calls:
        c.block = spans[bisect.bisect_left(ends, c.t_ns)][4]
    return calls


def layout(x) -> str:
    """The memory a stack lies in: ``nchw``, or ``nhwc`` (a qgemm output
    viewed as (N, C, H, W))."""
    return "nchw" if x.is_contiguous() else "nhwc"


def source(x, bsz: int) -> str:
    """What a ``band_windows`` call of batch ``bsz`` stages from, as the
    kernel reads it: ``input``, one sample a row of ``x`` (the block's
    input, rows global), or a stack of bands in its ``layout``."""
    return "input" if x.shape[0] == bsz else layout(x)


def engine_launches(calls) -> list[tuple[str, str, tuple]]:
    """(kernel, layer, shape) of each call of a :func:`census`, read from
    the call's own arguments.  A qgemm shape is (M, K, N); a band stack's
    (windows, C, R, W, stride), width unpadded; a flat depthwise layer's
    (batch, C, H, W, stride, shards), input unpadded, with each worker
    shard's (c_lo, c_hi, start, stop); a pool's (windows, C, R, W, rows),
    rows a band owns (one band of all H rows a sample where the layer is
    flat); a gate's (windows, C, R, W, batch); a stage's windows (batch,
    bands, C, source rows, W, R, pad columns, :func:`source`, NHWC out); a
    block's output take (batch, bands, C, r, W, H_out, source layout,
    residual).  The layer is the call's block group, ``first..last`` (one
    layer: its name)."""
    out = []
    for c in calls:
        a, kw, block = c.args, c.kwargs, c.block
        layer = (block["first"] if block["first"] == block["last"]
                 else f"{block['first']}..{block['last']}")
        if c.name == "qgemm":
            shape = (*a[0].shape, a[1].shape[1])
        elif c.name in ("dwconv3x3", "dwconv5x5_shards"):
            shape = (*a[0].shape, kw["stride"],
                     tuple((lo, hi - 1, start, stop)
                           for lo, hi, start, stop, _ in a[1].rows))
        elif c.name.startswith("dwconv"):
            shape = (*a[0].shape, kw["stride"])
        elif c.name == "se_pool":
            shape = (*a[0].shape, tuple(a[1]))
        elif c.name == "se_gate":
            shape = (*a[0].shape, a[1].shape[0])
        elif c.name == "band_windows":
            x, table, bsz = a
            shape = (bsz, table.shape[0], *x.shape[1:], table.shape[1],
                     kw.get("pw", 0), source(x, bsz),
                     kw.get("channels_last", False))
        else:
            x, rows, bsz = a[:3]
            shape = (bsz, x.shape[0] // bsz, *x.shape[1:], rows.shape[0],
                     layout(x), len(a) > 3)
        out.append((c.name, layer, shape))
    return out


def on_cpu(call):
    """The call's wrapper on CPU copies of its arguments: its plain
    version, on the engine's own operands."""
    return call.fn(*(a.cpu() if isinstance(a, torch.Tensor) else a
                     for a in call.args), **call.kwargs)
