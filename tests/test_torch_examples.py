"""The port's CNN examples (``examples/torch``) run to the end on the CPU:
each is started as a user would start it, with ``--smoke --device cpu``,
and must exit 0 (each exits non-zero when one of its checks fails)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart.py", "heterogeneous_cluster.py",
            "split_mobilenetv2_serve.py", "multi_tenant_serve.py")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(name):
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch" / name), "--smoke",
         "--device", "cpu"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
