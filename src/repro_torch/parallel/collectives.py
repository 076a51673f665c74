"""Explicit collectives on ``torch.distributed``, ported from
``repro/parallel/collectives.py``.

``compressed_psum``: int8-quantized gradient all-reduce: each rank
quantizes with a per-tensor symmetric scale and the ranks sum the
dequantized, int-valued payload ``q * s`` in float32 (the wire format is
conceptually int8 plus one float32 scale).  On a real pod this is the
cross-DCN ('pod' axis) reducer, where 4x byte savings matter most; the
train step's ``compress_grads`` flag reproduces the same numerics.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..nn.layers import map_defs
from ..parallel import sharding as sh


def _quantize(g, bits: int):
    """(int32 payload, float32 scale): the scale is the largest magnitude
    over qmax, the payload rounded half to even (``jnp.round``)."""
    qmax = 2.0 ** (bits - 1) - 1
    gf = g.float()
    scale = torch.clamp(torch.max(torch.abs(gf)), min=1e-12) / qmax
    q = torch.round(gf / scale).clamp(-qmax, qmax).to(torch.int32)
    return q, scale


def compressed_psum(x, group=None, bits: int = 8):
    """All-reduce ``x`` over ``group`` (a process group; None: the world)
    with int-N payload compression.  Returns the SUM (as ``lax.psum``), in
    float32."""
    q, s = _quantize(x, bits)
    out = q.float() * s
    dist.all_reduce(out, group=group)
    return out


def make_compressed_grad_sync(mesh, axis_name: str = "data", bits: int = 8):
    """Gradient synchronizer over one mesh axis: a tree of each rank's
    gradients -> the tree of their compressed sums (divide by the axis size
    outside for the mean).  A DTensor leaf contributes its local shard."""
    group = mesh.get_group(axis_name)

    def sync(tree):
        return map_defs(lambda g: compressed_psum(sh.local(g), group, bits),
                        tree)

    return sync


# -- the model axis's collectives on local tensors, with their gradients ------
#
# A mesh layer that splits a block's compute over the model axis moves its
# activations between the axis's ranks with these: plain
# ``torch.distributed`` calls on local tensors, no DTensor round trip, each
# an autograd Function whose backward is its forward's adjoint, so that
# train (autograd records) and prefill and decode (nothing records) run
# the same calls.  ``group``: the model axis's process group of ``m``
# ranks.  Over a group of one rank each is the identity it computes, and
# no call is made (as DTensor makes none along a mesh dim of size one).

def _alone(group) -> bool:
    return dist.get_world_size(group) == 1

def _all_gather(out, x, group) -> None:
    # torch 2.13 renames all_gather_into_tensor to all_gather_single
    (getattr(dist, "all_gather_single", None)
     or dist.all_gather_into_tensor)(out, x, group=group)


def _reduce_scatter(out, x, group) -> None:
    (getattr(dist, "reduce_scatter_single", None)
     or dist.reduce_scatter_tensor)(out, x, group=group)


def _summed(x, group):
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, m):
        ctx.group = group
        out = x.new_empty((m,) + tuple(x.shape))
        _all_gather(out, x.contiguous()[None], group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.new_empty((1,) + tuple(grad.shape[1:]))
        _reduce_scatter(out, grad.contiguous(), ctx.group)
        return out[0], None, None


class _ScatterSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.m = group, x.shape[0]
        out = x.new_empty((1,) + tuple(x.shape[1:]))
        _reduce_scatter(out, x.contiguous(), group)
        return out[0]

    @staticmethod
    def backward(ctx, grad):
        out = grad.new_empty((ctx.m,) + tuple(grad.shape))
        _all_gather(out, grad.contiguous()[None], ctx.group)
        return out, None


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, parts: bool):
        ctx.group, ctx.parts = group, parts
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return (_summed(grad, ctx.group) if ctx.parts else grad), None, None


class _GradsSummed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


def gather(x, group, m: int):
    """Each rank's ``x`` stacked along a new leading dim, (m, *x.shape),
    rank r's at [r] (an all-gather).  Each rank's use of the whole is a
    part of the work: the gradient is summed over the ranks and each keeps
    its own slice (a reduce-scatter)."""
    return x[None] if _alone(group) else _Gather.apply(x, group, m)


def scatter_sum(x, group):
    """The sum over the ranks of ``x`` (m, ...), of which this rank keeps
    slice [r] (a reduce-scatter); its gradient is all-gathered back."""
    return x[0] if _alone(group) else _ScatterSum.apply(x, group)


def sum_alike(x, group):
    """The sum over the ranks of each one's part ``x`` (an all-reduce),
    which every rank then uses alike: the gradient passes through."""
    return x if _alone(group) else _Sum.apply(x, group, False)


def sum_parts(x, group):
    """The sum over the ranks of each one's part ``x`` (an all-reduce),
    which each rank then uses for its own part of the work: the gradient
    is summed over the ranks too."""
    return x if _alone(group) else _Sum.apply(x, group, True)


def grads_summed(x, group):
    """``x`` as it is, whole on every rank, its gradient summed over the
    ranks (an all-reduce in the backward): the input of work that the
    ranks split, each rank's gradient a part.  Where nothing records,
    ``x`` itself."""
    if _alone(group) or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _GradsSummed.apply(x, group)
