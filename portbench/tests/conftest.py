"""Fixtures of the benchmark's CPU tests (helpers: ``tiny_bench``)."""
from __future__ import annotations

import sys

import pytest

from .tiny_bench import ROOT, copy_bench

for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark with the tiny cells and the toy architecture
    added, as files and ``BENCHMARK.json`` entries alone."""
    return copy_bench(tmp_path)
