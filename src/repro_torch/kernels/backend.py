"""Builder and loader of the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` for Hopper
(``sm_90a``) into ``lib<name>.so``, a shared library with a plain C
interface that :mod:`ctypes` loads (no PyTorch headers, so a build takes
seconds).  All sources compile at once, one ``nvcc`` process each, into
``_build/<digest>/`` beside the package; the digest covers every source and
the flags, so an edited source builds afresh and an unchanged one is reused.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero status into an
exception, so a refused launch never passes silently.

This module replaces the reference's ``repro/kernels/backend.py``, which
chose between compiled and interpreted Pallas.  Here nothing is chosen: a
CUDA tensor launches the kernel, a CPU tensor takes the plain version, and
no flag or environment variable changes that.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def sources() -> dict[str, Path]:
    """Kernel name -> its ``.cu`` source."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _digest() -> str:
    h = hashlib.sha256(repr(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def build() -> dict[str, Path]:
    """Compile every kernel source not yet built, all in parallel, and
    return kernel name -> shared library path."""
    out_dir = BUILD_ROOT / _digest()
    libs = {name: out_dir / f"lib{name}.so" for name in sources()}
    todo = {n: p for n, p in libs.items() if not p.is_file()}
    if not todo:
        return libs
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for name, lib in todo.items():
        # build under a temporary name, then rename: a concurrent loader
        # never sees a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(sources()[name])]
        procs.append((name, lib, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, lib, tmp, cmd, proc in procs:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode == 0:
            os.replace(tmp, lib)
        else:
            os.unlink(tmp)
            errors.append(f"{' '.join(cmd)}\n{log}")
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return libs


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so`` (built on first use)."""
    return ctypes.CDLL(str(build()[name]))


@functools.cache
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (a host query, no sync);
    the schedule pickers size their grids by it."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(name: str, status: int, what: str) -> None:
    """Raise if a C entry point of ``lib<name>.so`` reported a CUDA error."""
    if status != 0:
        err = getattr(library(name), f"{name}_error_string")
        err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {status} at launch "
                           f"({err(status).decode()})")
