"""The squeeze-and-excitation kernels of EfficientNet's MBConv blocks: the
global pool over a stack of spatial bands, and the gate multiply."""
from .se import se_gate, se_pool

__all__ = ["se_gate", "se_pool"]
