"""Roofline analysis of a counted step, the counterpart of
``repro/launch/analysis.py``:

    compute term    = FLOPs / PEAK_FLOPS              (per device)
    memory term     = bytes / HBM_BW                  (per device)
    collective term = collective bytes / LINK_BW      (per device)

The reference walks the compiled XLA HLO text with loop trip counts.  Torch
makes no HLO, so :func:`count_step` runs the step once, eagerly, on fake
tensors (``FakeTensorMode``: shapes and dtypes, no storage, no compute)
under a ``TorchDispatchMode`` that sees every aten op of this rank,
forward and backward.  Eager torch unrolls its Python loops, so no trip
counts are needed.  It counts:

  * FLOPs: the formulas of ``torch.utils.flop_counter`` (FlopCounterMode's
    registry: 2 * |result| * |contracted| for a matmul), over mm / bmm /
    addmm / baddbmm / convolution / attention ops.
  * Bytes: each aten op's operand bytes plus result bytes (each distinct
    operand once; views, which move nothing, and collectives skipped).
    This is an op-boundary model: every op reads its inputs from and
    writes its outputs to memory.  It counts more than the reference's
    fusion-boundary model, where a fused chain of elementwise ops moves
    only its ends.
  * Collective bytes: the operand bytes of each ``c10d_functional`` op
    (DTensor's redistributions) and each ``c10d`` op (``dist.all_reduce``
    and the like), under the reference's names (``all-gather``,
    ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``).  Operand bytes, not the reference's
    ring-traffic factors: an all-gather counts the shard a rank sends.
  * Peak memory: the most bytes of fake storages live at once (fake
    tensors allocate nothing, so this is a count, not an allocator's
    high-water mark).  A storage counts until Python frees its last
    tensor, and tensors held in reference cycles (autograd's graph) go
    when the cyclic collector runs, so this one is an estimate: it moved
    by up to 2x between torch 2.11 and 2.13, where the FLOPs, bytes and
    collective bytes were equal to the byte.

One loop is not unrolled: the sLSTM's loop over time
(``nn.recurrent.run_steps``, the reference's ``lax.scan``), 4096 to 32768
identical steps whose ops would take minutes to dispatch.  Its step runs
once and counts as many times as the loop has steps, forward and backward
(the backward's ``select_backward`` of each step and the sums of their
full-length gradients included), as the reference's HLO walk multiplies a
loop body by its trip count.

The constants are the NVIDIA H100 SXM datasheet's, not measurements.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# NVIDIA H100 SXM datasheet figures (per card)
PEAK_FLOPS = 989e12          # dense bf16 FLOP/s
HBM_BW = 3.35e12             # HBM3 bytes/s
LINK_BW = 450e9              # NVLink 4 bytes/s, one direction

# the reference's HLO names of the collectives that DTensor
# (``_c10d_functional`` and its autograd twin) and ``torch.distributed``
# (``c10d``) dispatch; any other op of those namespaces counts under its
# own name
_COLL = {
    "all_gather_into_tensor": "all-gather",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce",
    "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "alltoall_base_": "all-to-all",
}
_COLL_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d")
# ops that move no bytes of their own: allocation without a write, and the
# waits and barriers of collectives
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "wait_tensor", "barrier", "lift_fresh"}


@dataclasses.dataclass
class _Totals:
    flops: float = 0.0
    bytes: float = 0.0
    coll: dict[str, float] = dataclasses.field(default_factory=dict)
    peak_mem: float = 0.0
    arg_bytes: float = 0.0       # the step's inputs on this rank (dry-run)
    # aten ops counted, by name (the port's lowered form: --print-hlo)
    ops: collections.Counter = dataclasses.field(
        default_factory=collections.Counter)


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors of a nested tuple / list / dict of arguments, each once;
    a DTensor's local shard for the DTensor."""
    from torch.distributed.tensor import DTensor
    out: list = []
    seen: set = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if isinstance(x, DTensor):
                x = x.to_local()
            if id(x) not in seen:
                seen.add(id(x))
                out.append(x)
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)

    walk(tree)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    """Whether ``func``'s result aliases an operand without writing it."""
    for ret in func._schema.returns:
        info = ret.alias_info
        if info is not None and not info.is_write:
            return True
    return False


class _Counter(TorchDispatchMode):
    """Counts FLOPs, bytes, collective bytes and live fake storage of every
    aten op dispatched while it is active."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.t = _Totals()
        self._live: dict[int, list] = {}
        self._cur = 0
        self.scale = 1           # each op counts this many times
        self._funcs: dict = {}

    @contextlib.contextmanager
    def scaled(self, k: int):
        """Count each op of the block ``k`` times (0: not at all)."""
        prev, self.scale = self.scale, self.scale * k
        try:
            yield
        finally:
            self.scale = prev

    def track(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage live until the last tracked tensor on it
        is freed."""
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        if key not in self._live:
            self._live[key] = [st.nbytes(), 0]
            self._cur += st.nbytes()
            self.t.peak_mem = max(self.t.peak_mem, self._cur)
        self._live[key][1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        ent = self._live.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self._cur -= ent[0]
            del self._live[key]

    def _info(self, func) -> tuple:
        """(name, counted, collective kind, view, FLOP formula) of an op."""
        info = self._funcs.get(func)
        if info is None:
            name, ns = func._overloadpacket.__name__, func.namespace
            info = (f"{ns}.{name}", ns != "prim" and name not in _FREE,
                    _COLL.get(name, name) if ns in _COLL_NAMESPACES
                    else None,
                    _is_view(func),
                    self.flop_registry.get(func._overloadpacket))
            self._funcs[func] = info
        return info

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name, counted, coll, view, flops = self._info(func)
        k = self.scale
        if counted and k:
            self.t.ops[name] += k
            if coll is not None:
                self.t.coll[coll] = self.t.coll.get(coll, 0.0) + k * sum(
                    _nbytes(t) for t in _tensors((args, kwargs)))
            elif not view:
                # an in-place op's operand is its result: read and written
                self.t.bytes += k * (sum(_nbytes(t) for t in _tensors(
                    (args, kwargs))) + sum(_nbytes(t) for t in _tensors(out)))
                if flops is not None:
                    self.t.flops += k * flops(*args, **kwargs, out_val=out)
        if not view:
            # a view's storage is its base's, which is tracked and which
            # the view keeps alive
            for t in _tensors(out):
                self.track(t)
        return out


class _Steps(torch.autograd.Function):
    """``nn.recurrent.run_steps`` as the counter counts it: the step runs
    once on the first slice and counts as many times as ``xs`` has steps;
    its backward likewise (recomputed uncounted, then differentiated
    counted, the slice's ``select_backward`` included), plus the sums that
    accumulate the steps' gradients of ``xs`` and of the constants.  Shapes
    are right; values are one step's (the tensors are fake)."""

    @staticmethod
    def forward(ctx, counter, step, nc, xs, *rest):
        ctx.counter, ctx.step, ctx.nc = counter, step, nc
        ctx.save_for_backward(xs, *rest)
        n = xs.shape[1]
        with counter.scaled(n):
            carry, y = step(tuple(rest[:nc]), xs[:, 0], *rest[nc:])
        # the stack of n step outputs: n reads and n writes of y
        return (*carry, y.unsqueeze(1).expand(-1, n, *y.shape[1:])
                .contiguous())

    @staticmethod
    def backward(ctx, *grads):
        counter, nc = ctx.counter, ctx.nc
        xs, *rest = ctx.saved_tensors
        n = xs.shape[1]
        ins = [t.detach().requires_grad_(t.is_floating_point())
               for t in (xs, *rest)]
        with torch.enable_grad():
            with counter.scaled(0):
                carry, y = ctx.step(tuple(ins[1:1 + nc]), ins[0][:, 0],
                                    *ins[1 + nc:])
            want = [t for t in ins if t.requires_grad]
            with counter.scaled(n):
                got = torch.autograd.grad(
                    [*carry, y], want, [*grads[:nc], grads[nc][:, 0]],
                    allow_unused=True, materialize_grads=True)
        out = dict(zip(map(id, want), got))
        with counter.scaled(n - 1):
            # each later step's gradient of xs and of each constant summed
            # into the first's (carries pass from step to step instead)
            for i, t in enumerate(ins):
                if t.requires_grad and not 1 <= i <= nc:
                    out[id(t)] + out[id(t)].detach()
        return (None, None, None, *(out.get(id(t)) for t in ins))


@contextlib.contextmanager
def _counted_steps(counter: _Counter):
    """``nn.recurrent.run_steps`` through :class:`_Steps` for the block."""
    from ..nn import recurrent

    def hook(step, carry, xs, consts):
        out = _Steps.apply(counter, step, len(carry), xs, *carry, *consts)
        return tuple(out[:-1]), out[-1]

    token = recurrent.STEPS_HOOK.set(hook)
    try:
        yield
    finally:
        recurrent.STEPS_HOOK.reset(token)


def _fake_mode_of(tree):
    from torch._subclasses.fake_tensor import FakeTensor
    for t in _tensors(tree):
        if isinstance(t, FakeTensor):
            return t.fake_mode
    return None


def count_step(fn, *args, **kwargs) -> _Totals:
    """Run ``fn(*args, **kwargs)`` once on fake tensors and count it (the
    module docstring).  The arguments may be fake tensors (or DTensors of
    them: their fake mode is used) or real ones, which are read as fake
    ones of their shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = _fake_mode_of((args, kwargs)) or \
        FakeTensorMode(allow_non_fake_inputs=True)
    counter = _Counter()
    for t in _tensors((args, kwargs)):
        counter.track(t)
    with mode, counter, _counted_steps(counter):
        out = fn(*args, **kwargs)
    del out
    return counter.t


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    flops: float                 # per-device counted FLOPs
    hbm_bytes: float             # per-device bytes (op-boundary model)
    coll_bytes: dict[str, float]
    model_flops: float           # analytic 6*N*D (or decode equivalent) /chip
    peak_mem_bytes: float        # per-device live fake storage, at most
    xla_flops: float = 0.0       # the reference's cost_analysis; none here
    xla_bytes: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return sum(self.coll_bytes.values()) / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_frac(self) -> float:
        """MODEL_FLOPS / counted FLOPs — how much counted compute is
        useful."""
        return self.model_flops / max(self.flops, 1.0)

    @property
    def roofline_frac(self) -> float:
        """Useful-compute time over the achievable step time max(terms) —
        the MFU the counted step would deliver at best."""
        t_star = self.model_flops / PEAK_FLOPS
        t_bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_star / max(t_bound, 1e-30)

    def to_dict(self) -> dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "model_flops": self.model_flops,
            "peak_mem_bytes": self.peak_mem_bytes,
            "xla_flops": self.xla_flops, "xla_bytes": self.xla_bytes,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_frac": self.useful_flops_frac,
            "roofline_frac": self.roofline_frac,
        }


def model_flops_for(cfg, shape) -> float:
    """Analytic MODEL_FLOPS per global step: 6*N*D train (fwd+bwd), 2*N*D
    forward-only; D = processed tokens; MoE uses active params."""
    n = cfg.n_active_params()
    if shape.mode == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.mode == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch   # decode: one token per sequence


def summarize(totals: _Totals, cfg, shape, mesh_desc: str,
              n_chips: int) -> RooflineReport:
    """The report of one cell from :func:`count_step`'s totals."""
    return RooflineReport(
        arch=cfg.name, shape=shape.name, mesh=mesh_desc,
        flops=totals.flops, hbm_bytes=totals.bytes,
        coll_bytes=dict(totals.coll),
        model_flops=model_flops_for(cfg, shape) / n_chips,
        peak_mem_bytes=float(totals.peak_mem))
