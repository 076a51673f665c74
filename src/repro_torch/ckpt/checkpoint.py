"""Fault-tolerant checkpointing of a tree of tensors, ported from
``repro/ckpt/checkpoint.py``: atomic, async-capable, and in the reference's
on-disk layout, so each package reads what the other writes.

Layout: ``<dir>/step_<N>/`` with one ``shard_<p>.npz`` per host process plus
``manifest.json`` (entries with global shapes and dtypes, step).  Entry
keys are tree paths joined by ``/`` (``params/stacks/0/0_attn/wq``,
``opt/m/...``, ``opt/step``), written with ``|`` in the npz.  Writes go to
``step_<N>.tmp``, which is renamed only after every shard and the manifest
are fsynced — a crashed writer never corrupts the latest checkpoint, and
``latest_step`` ignores ``.tmp`` leftovers.

Each leaf reaches the host by one copy, made before ``save_checkpoint``
returns, so an async save may run beside steps that update the state in
place.  bfloat16 leaves are written as the reference writes them (2-byte
``|V2`` records, ``"bfloat16"`` in the manifest) and restored by the
manifest's dtype, bit for bit; the reference's own restore returns those
records as raw bytes.

On a mesh the leaves are DTensors: every rank gathers each leaf whole and
rank 0 writes it, so the files are the ones a single-device run writes
(``n_processes`` 1).  ``restore_checkpoint(..., shardings=)`` places each
leaf on a mesh, which need not be the one it was saved from: this is how a
run restarts on another mesh (elastic rescale).
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist

from ..core.executor import resolve_device
from ..nn.layers import unflatten
from ..parallel import sharding as sh

_SEP = "/"
_BF16 = "bfloat16"


def _flatten(tree, prefix: str = "") -> dict:
    """{path: leaf} in ``jax.tree_util`` order (dict keys sorted), which is
    the order of ``nn.layers.leaves``."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}{_SEP}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}{_SEP}"))
        return out
    return {prefix[:-1]: tree}


def _to_host(leaf: torch.Tensor) -> np.ndarray:
    """One host copy of a tensor as numpy (bfloat16 as 2-byte records); a
    DTensor's whole tensor (a collective: every rank calls it)."""
    t = leaf.detach()
    if sh.is_dtensor(t):
        t = t.full_tensor()
    t = t.to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def save_checkpoint(ckpt_dir: str, step: int, tree, *, process_index: int = 0,
                    n_processes: int = 1, blocking: bool = True):
    """Atomically persist a tree of tensors.  Returns a
    join()able thread when ``blocking=False`` (the files are written off the
    caller's thread; the leaves are on the host before it returns).

    A tree of DTensors is saved by every rank of their mesh together: each
    gathers the whole leaves and rank 0 writes them; the others return
    None, after the files are in place when ``blocking``."""
    flat = _flatten(tree)
    on_mesh = any(sh.is_dtensor(v) for v in flat.values())
    arrays, meta = {}, {"step": step, "n_processes": n_processes,
                        "entries": {}}
    for key, val in flat.items():
        arr = _to_host(val)
        arrays[key] = arr
        dtype = _BF16 if val.dtype == torch.bfloat16 else str(arr.dtype)
        meta["entries"][key] = {"shape": list(arr.shape), "dtype": dtype}
    if on_mesh and dist.get_rank() != 0:
        if blocking:
            dist.barrier()
        return None

    def _write():
        tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
        final = os.path.join(ckpt_dir, f"step_{step}")
        os.makedirs(tmp, exist_ok=True)
        shard_path = os.path.join(tmp, f"shard_{process_index}.npz")
        with open(shard_path, "wb") as f:
            np.savez(f, **{k.replace(_SEP, "|"): v for k, v in arrays.items()})
            f.flush()
            os.fsync(f.fileno())
        if process_index == 0:
            mpath = os.path.join(tmp, "manifest.json")
            with open(mpath, "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)

    if blocking:
        _write()
        if on_mesh:
            dist.barrier()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp") and \
                os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
            steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A restored array as a tensor of the manifest's dtype."""
    if dtype == _BF16:
        return torch.from_numpy(np.ascontiguousarray(arr).view(
            np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != dtype:
        raise ValueError(f"stored {arr.dtype}, the manifest says {dtype}")
    return torch.from_numpy(np.array(arr, copy=True))


def restore_checkpoint(ckpt_dir: str, step: int, template, *, device=None,
                       shardings=None):
    """Restore into the structure of ``template``: each leaf a tensor of
    the manifest's dtype on ``device`` (CUDA unless the caller asks for the
    CPU), where the template's tensors must lie.  Raises if an entry is
    missing or its shape differs from the template's.

    With ``shardings`` (a tree like ``template`` of
    ``parallel.sharding.Sharding``, e.g. ``trainer.state_shardings`` of
    ``abstract_train_state``), each leaf is placed with
    ``distribute_tensor`` on its sharding's mesh, on that mesh's device; a
    0-d leaf stays a plain tensor there (the optimizer step).  The
    template's leaves then give the structure and shapes only."""
    if shardings is not None:
        if device is not None:
            raise ValueError("pass shardings or device, not both")
        flat_sh = _flatten(shardings)
        mesh = next(s.mesh for s in flat_sh.values() if s is not None)
        dev = (torch.device("cuda", torch.cuda.current_device())
               if mesh.device_type == "cuda" else torch.device("cpu"))
    else:
        dev = resolve_device(device)
    final = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(final, "manifest.json")) as f:
        meta = json.load(f)
    flat: dict[str, np.ndarray] = {}
    for name in sorted(os.listdir(final)):
        if name.startswith("shard_") and name.endswith(".npz"):
            with np.load(os.path.join(final, name)) as z:
                for k in z.files:
                    flat[k.replace("|", _SEP)] = z[k]
    missing = set(meta["entries"]) - set(flat)
    if missing:
        raise IOError(f"checkpoint step {step} incomplete: missing "
                      f"{sorted(missing)[:5]}")
    out = []
    for key, tmpl in _flatten(template).items():
        if key not in flat:
            raise KeyError(f"checkpoint missing entry {key!r}")
        if shardings is None and tmpl.device != dev:
            raise ValueError(f"{key}: template on {tmpl.device}, restoring "
                             f"to {dev}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(tmpl.shape):
            raise ValueError(f"{key}: shape {arr.shape} != template "
                             f"{tuple(tmpl.shape)}")
        t = _tensor(arr, meta["entries"][key]["dtype"]).to(dev)
        if shardings is not None and t.dim() > 0:
            t = sh.shard_tensor(t, flat_sh[key])
        out.append(t)
    return unflatten(template, out)
