"""Benchmark of the PyTorch/CUDA port (``repro_torch``) on NVIDIA GPUs.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

``BENCHMARK.json`` at the checkout's root lists the cells and metrics; each
configuration, cell, traffic kind and metric is a file of its own under
this folder, found by its name (see ``portbench/harness.py``).
"""
