"""The system under test: the port's model, split plan and ``Session``
(``repro_torch``), built from a configuration and the benchmark's float
weights and calibration images.

The run's architecture module (``portbench/programs/<arch>.py``, held on
``run.program``) builds the program's model with the program's own code
and the benchmark's weights, held against the reference's layer list
(``run.layers``).  The split is fixed by the configuration
(``split_model(model, ratings, mode=...)``), so no planner search runs in
set-up.  The program calibrates and quantizes on its own, from the
calibration images.
"""
from __future__ import annotations


def session(run, max_batch: int):
    """An int8 ``Session`` of the run's configuration and split, calibrated
    by the program on the run's calibration images."""
    from repro_torch.api import Session
    from repro_torch.core import split_model
    cfg = run.cfg
    model = run.program.program_model(cfg["model"], run.weights, run.layers)
    split = cfg["split"]
    plan = split_model(model, split["ratings"], mode=split["mode"])
    return Session(plan, precision=cfg["precision"],
                   calibration=list(run.calibration), device=run.device,
                   max_batch=max_batch)
