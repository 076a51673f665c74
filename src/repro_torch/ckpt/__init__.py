"""Checkpoints of training state (:mod:`.checkpoint`), ported from
``repro/ckpt``."""
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
