"""PyTorch/CUDA port of the split CNN inference system in ``repro``.

The layout mirrors ``repro`` module by module; every module names its
reference by path.  The port imports torch and numpy, never JAX nor
``repro``.  Its entry points run on CUDA unless the caller passes
``device="cpu"``.  The Pallas kernels of the main path are hand-written
CUDA kernels in ``csrc/`` (see :mod:`repro_torch.kernels.backend`).
"""
