from . import lm
from .efficientnet import efficientnet_b0, efficientnet_b0_smoke
from .mobilenetv2 import mobilenet_v2, mobilenet_v2_paper, mobilenet_v2_smoke

__all__ = ["efficientnet_b0", "efficientnet_b0_smoke", "lm", "mobilenet_v2",
           "mobilenet_v2_paper", "mobilenet_v2_smoke"]
