"""Device meshes on ``torch.distributed``, ported from
``repro/launch/mesh.py``.

A mesh is a ``DeviceMesh`` with named dims over the default process group,
which the caller has initialised (``torch.distributed.init_process_group``
with its address, world size and rank: nothing here discovers a cluster).
It runs on CUDA with NCCL unless the caller asks for ``device="cpu"``,
which uses gloo.  :class:`MeshShape` is sizes and names only, the
counterpart of jax's ``AbstractMesh``: sharding rules can be built and
checked for the production shapes without a process group.

Defined as functions, so that importing this module touches no device or
process-group state.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's dim sizes and names, with no devices behind them."""
    sizes: tuple[int, ...]
    axes: tuple[str, ...]

    def __post_init__(self):
        if len(self.sizes) != len(self.axes):
            raise ValueError(f"mesh shape {self.sizes} and axes {self.axes} "
                             f"differ in length")

    @property
    def axis_names(self) -> tuple[str, ...]:
        return self.axes

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axes, self.sizes))


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a :class:`MeshShape`."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_names(mesh) -> tuple[str, ...]:
    if isinstance(mesh, MeshShape):
        return mesh.axes
    return tuple(mesh.mesh_dim_names)


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...], *,
              device=None):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    default process group, on CUDA (NCCL) unless ``device="cpu"`` (gloo,
    or the ``fake`` group that the dry-run initialises).
    Raises when CUDA is absent and the CPU was not asked for, when the
    process group is not initialised, and when ``prod(shape)`` is not the
    world size."""
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or len(set(axes)) != len(axes):
        raise ValueError(f"mesh shape {shape} needs as many distinct axis "
                         f"names, got {axes}")
    kind = "cuda" if device is None else torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"a mesh runs on cuda or cpu, not {device!r}")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' for a gloo "
                           "mesh on the CPU")
    if not dist.is_initialized():
        raise RuntimeError("initialise the process group first "
                           "(torch.distributed.init_process_group with an "
                           "address, world size and rank)")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {shape} holds {math.prod(shape)} ranks, the "
                         f"world has {world}")
    backend = str(dist.get_backend()).lower()
    want = "nccl" if kind == "cuda" else "gloo"
    # a fake group (launch/dryrun.py: no process behind the other ranks)
    # serves a CPU mesh of placeholder ranks
    if want not in backend and not (kind == "cpu" and backend == "fake"):
        raise ValueError(f"a {kind} mesh needs the {want} backend, the "
                         f"process group has {backend}")
    if kind == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(kind, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """Single pod: 16x16 = 256 ranks ("data", "model").  Multi-pod: 2 pods
    of 256 = 512 ranks ("pod", "data", "model"); the pod axis carries only
    data-parallel gradient reduction.  Needs a world of that size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def data_axis_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    n = 1
    for a in ("pod", "data"):
        n *= sizes.get(a, 1)
    return n
