"""Hand-written CUDA kernels of the port (``csrc/``), each with its plain
torch version beside it.  See :mod:`.backend` for how they build."""
