"""Plain torch version of the qgemm kernel (int8 W8A8 GEMM + fused epilogue).

Port of ``repro/kernels/qgemm/ref.py``.  CUDA has no int32 matmul, so the
product is taken in float64, which is exact here: every partial sum is an
integer of magnitude at most K * 127**2 (about 2.1e7 at the classifier's
K = 1280), far inside float64's 2**53.  It runs on CPU and CUDA tensors, so
the CPU tests and the card's kernel checks hold the kernel to the same
arithmetic.
"""
from __future__ import annotations

import torch

from ...core.quantize import epilogue


def qgemm_ref(x_q, w_q, scale, bias, *, activation: str | None = None,
              out_scale: float | None = None):
    """x_q: (M, K) int8; w_q: (K, N) int8; scale: (N,) f32; bias: (N,) f32
    (real-domain) or int32 (``b_q``, added to the int32 accumulator)."""
    acc = (x_q.to(torch.float64) @ w_q.to(torch.float64)).to(torch.int32)
    return epilogue(acc, scale, bias, activation, out_scale)
