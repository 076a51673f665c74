"""Band staging of the spatial split: the windows each stage of a fused
spatial block reads, and the block's output rows."""
from .bands import band_take, band_windows

__all__ = ["band_take", "band_windows"]
