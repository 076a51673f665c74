from . import lm
from .mobilenetv2 import mobilenet_v2, mobilenet_v2_paper, mobilenet_v2_smoke

__all__ = ["lm", "mobilenet_v2", "mobilenet_v2_paper", "mobilenet_v2_smoke"]
