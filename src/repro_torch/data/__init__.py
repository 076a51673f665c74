"""Synthetic training data (:mod:`.pipeline`), copied from ``repro/data``."""
from .pipeline import Prefetcher, SyntheticLM
