"""Training and serving steps of the LM stack, ported from ``repro/train``:
AdamW (:mod:`.optimizer`), the single-device train step (:mod:`.trainer`)
and the prefill and decode steps (:mod:`.serve`)."""
from . import optimizer, serve, trainer
