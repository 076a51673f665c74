"""Sharding rules on DTensor, ported from ``repro/parallel/sharding.py``:
the paper's fine-grained output-neuron splitting mapped to mesh axes.

Params and activations carry *logical axis names*; a rules table maps
logical names to mesh axes for each execution mode.  Column-parallel
linears ('ff', 'heads', 'vocab' on the output dim) are the paper's Alg. 1/2
kernel- and column-wise splits; 'embed' sharded over the data axes is the
ZeRO-style weight distribution that bounds each rank's parameter bytes.

``routing`` selects the paper-faithful coordinator pattern (activations
replicated at every layer boundary: everything flows "through the
coordinator") or the ``direct`` mode (activations stay sharded; the
reduce-scatter / all-gather pairs are direct worker-to-worker forwarding,
the paper's future work).

Where the reference has GSPMD, the port has DTensor: a ``PartitionSpec``
becomes one placement per mesh dim (``Shard(d)`` on each mesh axis that a
tensor dim names, ``Replicate()`` elsewhere; a dim sharded over
("pod", "data") is ``Shard(d)`` on both, pod major, as the spec orders
them), ``device_put`` is :func:`shard_tree` (``distribute_tensor``) and
``with_sharding_constraint`` is :func:`shard_act` (``redistribute``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any

import torch

from ..launch.mesh import axis_names, axis_sizes

Spec = tuple  # one entry a tensor dim: a tuple of mesh axis names, or None


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh and, for one tensor, its spec and its DTensor placements."""
    mesh: Any
    spec: Spec
    placements: tuple


@dataclasses.dataclass(frozen=True)
class Sds:
    """Shape, dtype and divisibility-fitted sharding of a tensor that is
    not allocated (the reference's ``ShapeDtypeStruct``)."""
    shape: tuple[int, ...]
    dtype: torch.dtype
    sharding: Sharding

    def meta(self) -> torch.Tensor:
        """The tensor on the meta device: shape and dtype, no storage."""
        return torch.empty(self.shape, dtype=self.dtype, device="meta")


def _tuple(axes) -> tuple | None:
    if axes is None:
        return None
    return (axes,) if isinstance(axes, str) else tuple(axes)


@dataclasses.dataclass(frozen=True)
class MeshRules:
    """Logical-axis -> mesh-axis mapping (None = replicate)."""

    mesh: Any                  # a DeviceMesh, a MeshShape, or None
    rules: dict[str, Any]

    @staticmethod
    def _dedup(axes_list: list) -> list:
        """A mesh axis may appear only once in a spec; on conflict the
        earlier (leftmost) dim keeps it."""
        seen: set[str] = set()
        out = []
        for axes in axes_list:
            if axes is None:
                out.append(None)
                continue
            tup = tuple(a for a in _tuple(axes) if a not in seen)
            seen.update(tup)
            out.append(tup if tup else None)
        return out

    def spec(self, names: tuple[str | None, ...]) -> Spec:
        return tuple(self._dedup([self.rules.get(n) if n else None
                                  for n in names]))

    def _axis_size(self, axes) -> int:
        if axes is None:
            return 1
        sizes = axis_sizes(self.mesh)
        n = 1
        for a in _tuple(axes):
            n *= sizes[a]
        return n

    def fit_spec(self, names: tuple[str | None, ...],
                 shape: tuple[int, ...]) -> Spec:
        """Like :meth:`spec`, but drops mesh axes on dims they don't
        divide (argument shardings must divide exactly)."""
        out = []
        for n, dim in zip(names, shape):
            axes = self.rules.get(n) if n else None
            if axes is not None and dim % self._axis_size(axes) != 0:
                axes = None
            out.append(axes)
        return tuple(self._dedup(out))

    def spec_placements(self, spec: Spec) -> tuple:
        """One DTensor placement per mesh dim for ``spec``."""
        from torch.distributed.tensor import Replicate, Shard
        order = axis_names(self.mesh)
        out: list = [Replicate()] * len(order)
        for d, axes in enumerate(spec):
            idx = [order.index(a) for a in axes or ()]
            if idx != sorted(idx):
                raise ValueError(f"spec {spec}: the axes of dim {d} are not "
                                 f"in mesh order {order}")
            for i in idx:
                out[i] = Shard(d)
        return tuple(out)

    def placements(self, names: tuple[str | None, ...],
                   shape: tuple[int, ...]) -> tuple:
        """The placements of a tensor of ``shape`` named ``names``, with the
        fit rule applied."""
        return self.spec_placements(self.fit_spec(names, shape))

    def sharding(self, names: tuple[str | None, ...]) -> Sharding:
        assert self.mesh is not None
        spec = self.spec(names)
        return Sharding(self.mesh, spec, self.spec_placements(spec))

    def fit_sharding(self, names: tuple[str | None, ...],
                     shape: tuple[int, ...]) -> Sharding:
        assert self.mesh is not None
        spec = self.fit_spec(names, shape)
        return Sharding(self.mesh, spec, self.spec_placements(spec))

    def sds(self, shape: tuple[int, ...], dtype,
            names: tuple[str | None, ...]) -> Sds:
        """A stand-in with a divisibility-fitted sharding."""
        shape = tuple(shape)
        return Sds(shape, dtype, self.fit_sharding(names, shape))


def make_rules(mesh, mode: str = "train", routing: str = "direct",
               seq_parallel: bool = True) -> MeshRules:
    """The rules table for a mesh (a ``DeviceMesh``, a ``MeshShape`` or
    None).

    mode: 'train' (FSDP over data + TP over model) or 'serve' (TP only;
    MoE experts over data).
    routing: 'direct' | 'coordinator' (paper-faithful baseline).
    """
    if mode not in ("train", "serve"):
        raise ValueError(f"unknown mode {mode!r}")
    if routing not in ("direct", "coordinator"):
        raise ValueError(f"unknown routing {routing!r}")
    ax = set(axis_names(mesh)) if mesh is not None else set()
    data_axes = tuple(a for a in ("pod", "data") if a in ax) or None
    model = "model" if "model" in ax else None
    # FSDP over the data axes in both modes: d_model always divides the
    # mesh (head dims often don't), so this axis reliably bounds each
    # rank's parameter bytes
    fsdp = data_axes
    rules: dict[str, Any] = {
        # --- parameter logical axes ---
        "embed": fsdp,            # FSDP: shard d_model dim of weights on data
        "ff": model,              # column-parallel output dim (paper Alg. 2)
        "ff_in": model,           # row-parallel input dim (down-projection)
        "heads": model,           # kernel-wise q-group split (MQA archs)
        "kv_heads": model,        # kernel-wise kv-head split (GQA/MHA archs)
        "vocab": model,           # output-neuron split of the LM head
        "experts": model if mode == "train" else data_axes,
        "expert_ff": model if mode == "serve" else None,
        "rnn": model,             # RG-LRU channels are independent neurons
        "layers": None,           # the stacked layer axis is never sharded
        # --- activation logical axes ---
        "batch": data_axes,
        "seq": model if seq_parallel else None,
        "act_embed": None,
        "act_heads": model,
        "act_ff": model,
        "kv_seq": model,          # decode KV cache sharded along sequence
        "moe_groups": data_axes,
        "act_experts": model if mode == "train" else data_axes,
    }
    if routing == "coordinator":
        # paper-faithful: every layer-boundary activation is replicated;
        # weights stay split
        rules.update({"act_heads": None, "act_ff": None, "seq": None,
                      "kv_seq": None})
    return MeshRules(mesh=mesh, rules=rules)


# --- thread-local rules context (models call shard_act without plumbing) ---
_ctx = threading.local()


@contextlib.contextmanager
def use_rules(rules: MeshRules | None):
    prev = getattr(_ctx, "rules", None)
    _ctx.rules = rules
    try:
        yield
    finally:
        _ctx.rules = prev


def current_rules() -> MeshRules | None:
    return getattr(_ctx, "rules", None)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard_act(x, names: tuple[str | None, ...]):
    """Redistribute ``x`` to the rules' placements for ``names`` if a rules
    context with a mesh is active; a plain tensor is returned as it is."""
    r = current_rules()
    if r is None or r.mesh is None:
        return x
    if x.dim() != len(names):
        raise ValueError(f"rank mismatch: {tuple(x.shape)} vs names {names}")
    if not is_dtensor(x):
        return x
    want = r.placements(tuple(names), tuple(x.shape))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def map_names(fn, names_tree, *trees):
    """``fn(names, *leaves)`` over a tree of logical-name tuples (dicts and
    lists of tuples) and trees of the same structure."""
    if isinstance(names_tree, dict):
        return {k: map_names(fn, names_tree[k], *(t[k] for t in trees))
                for k in names_tree}
    if isinstance(names_tree, list):
        return [map_names(fn, n, *(t[i] for t in trees))
                for i, n in enumerate(names_tree)]
    return fn(names_tree, *trees)


def param_shardings(spec_tree, rules: MeshRules, shapes=None):
    """Map a tree of logical-name tuples to :class:`Sharding`s.  When
    ``shapes`` (a matching tree of tensors, meta tensors or :class:`Sds`) is
    given, the shardings are divisibility-fitted per dim."""
    if shapes is None:
        return map_names(lambda names: rules.sharding(tuple(names)),
                         spec_tree)
    return map_names(lambda names, s: rules.fit_sharding(
        tuple(names), tuple(s.shape)), spec_tree, shapes)


def shard_tensor(t, sharding: Sharding):
    """``distribute_tensor`` of ``t``, which every rank holds alike: each
    rank keeps its shard (``src_data_rank=None``: nothing is sent), in its
    own storage, so the full tensor can be freed."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    out = distribute_tensor(t, sharding.mesh, list(sharding.placements),
                            src_data_rank=None)
    local = out.to_local()
    if local.untyped_storage().nbytes() > local.numel() * \
            local.element_size():
        out = DTensor.from_local(local.clone(), sharding.mesh,
                                 sharding.placements, run_check=False,
                                 shape=out.shape, stride=out.stride())
    return out


def shard_tree(tree, shardings):
    """Place each tensor of ``tree`` with its :class:`Sharding` (the
    reference's ``device_put``; :func:`shard_tensor`).  A leaf that is not
    a tensor, or whose sharding is None, stays as it is."""
    def walk(t, sh):
        if isinstance(t, dict):
            return {k: walk(t[k], sh[k]) for k in t}
        if isinstance(t, list):
            return [walk(a, b) for a, b in zip(t, sh)]
        if not isinstance(t, torch.Tensor) or sh is None:
            return t
        return shard_tensor(t, sh)

    return walk(tree, shardings)


# --- local compute on a mesh ------------------------------------------------
#
# DTensor's own sharding propagation picks each op's strategy by searching
# redistribution costs; on a 3-D mesh with a dim sharded over two mesh axes
# that search took 245-628 s for one forward of a 4-layer smoke model (torch
# 2.13, 8 gloo ranks).  So a mesh step computes on local shards between
# explicit redistributions, which follow the rules: the helpers below.


def local(t):
    """The local shard of a DTensor, or ``t`` itself."""
    return t.to_local() if is_dtensor(t) else t


def like(t, fn):
    """``fn`` of ``t``'s local shard, as a DTensor placed as ``t`` (an
    elementwise ``fn`` keeps the shards' meaning); ``fn(t)`` for a plain
    tensor."""
    if not is_dtensor(t):
        return fn(t)
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(fn(t.to_local()), t.device_mesh, t.placements,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def rows_placements(rules: MeshRules, shape) -> tuple:
    """Placements of an activation split by batch rows only (the rules'
    ``batch`` axes on dim 0, replicated along every other mesh axis)."""
    return rules.placements(("batch",) + (None,) * (len(shape) - 1),
                            tuple(shape))


def partial_over(placements) -> tuple:
    """``Partial()`` on each mesh dim where ``placements`` shard, else
    ``Replicate()``: the placements of a sum each rank took over its own
    shard."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return tuple(Partial() if isinstance(p, Shard) else Replicate()
                 for p in placements)


def replicated(t, grad_placements=None):
    """The full tensor of the DTensor ``t`` as a local tensor (all-gather
    along every mesh dim that shards it).  Its gradient comes back in
    ``grad_placements`` (default: replicated), e.g. ``Partial`` where each
    rank's use of it differs."""
    from torch.distributed.tensor import Replicate
    if not is_dtensor(t):
        return t
    mesh = t.device_mesh
    full = t.redistribute(mesh, [Replicate()] * mesh.ndim)
    return full.to_local(grad_placements=grad_placements)


def sum_over(t_local, mesh, placements):
    """The sum over the ranks that shard ``placements`` of each rank's
    ``t_local`` (an all-reduce along those mesh dims), differentiable."""
    from torch.distributed.tensor import DTensor
    pl = partial_over(placements)
    return DTensor.from_local(t_local, mesh, pl, run_check=False) \
        .full_tensor()


def reduce_over(t_local, mesh, placements, op):
    """``op`` (a ``dist.ReduceOp``) over the ranks that shard
    ``placements`` of each rank's ``t_local``, in place; no gradient."""
    import torch.distributed as dist
    from torch.distributed.tensor import Shard
    for d, p in enumerate(placements):
        if isinstance(p, Shard) and mesh.size(d) > 1:
            dist.all_reduce(t_local, op=op, group=mesh.get_group(d))
    return t_local


def _with(placements, dim: int, p) -> tuple:
    out = list(placements)
    out[dim] = p
    return tuple(out)


def grads_summed(x, mesh, placements, dim: int):
    """``x`` (a local tensor placed by ``placements``, whole along mesh dim
    ``dim``) as it is, its gradient summed over that mesh dim: the input of
    a product whose weight that dim splits (each rank's gradient is a
    part)."""
    from torch.distributed.tensor import DTensor, Partial
    dt = DTensor.from_local(x, mesh, placements, run_check=False)
    return dt.to_local(grad_placements=_with(placements, dim, Partial()))


def summed(x, mesh, placements, dim: int):
    """The sum over mesh dim ``dim`` of each rank's part ``x`` (an
    all-reduce), placed by ``placements`` elsewhere; its gradient passes
    through, as every rank uses the sum alike."""
    from torch.distributed.tensor import DTensor, Partial
    dt = DTensor.from_local(x, mesh, _with(placements, dim, Partial()),
                            run_check=False)
    return dt.redistribute(mesh, placements).to_local()


def row_range(n: int, mesh, placements, dim: int = 0) -> tuple[int, int]:
    """[start, stop) of this rank's rows of an ``n``-row tensor placed by
    ``placements`` (tensor dim ``dim`` split evenly, mesh dims in
    order)."""
    from torch.distributed.tensor import Shard
    start, size = 0, n
    for d, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            size //= mesh.size(d)
            start += mesh.get_local_rank(d) * size
    return start, start + size
