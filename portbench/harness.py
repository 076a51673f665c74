"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result's JSON line.

Everything a cell needs is found by name under ``<root>/portbench``:

- ``workloads/<cell>.json``: its configuration, traffic kind and
  parameters, trace span, limits, chips and why;
- ``configs/<config>.json``: the model (its ``arch``), input, split,
  precision;
- ``reference/<arch>.py``: the architecture's plain reference (``layers``,
  ``Reference``), and ``programs/<arch>.py``: its program side
  (``program_model``), found by the configuration's ``model.arch``;
- ``traffic/<kind>.py``: the code of the traffic kind (``setup``,
  ``drive``, ``teardown``);
- ``endtoend/<metric>.py`` and ``metrics/<metric>.py``: a reader of each
  end-to-end and per-layer metric (``read(run)``, None where it finds
  nothing to read);

and ``<root>/BENCHMARK.json`` says which metrics a cell reports.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np

from . import inputs
from .trace import Tracer

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
_T_IMPORT = time.perf_counter()


class Refused(RuntimeError):
    """A run that must print no result."""


def process_age_s() -> float:
    """Seconds since this process started (``/proc``), else since this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's, Flax's or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


class Bench:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def path(self, kind: str, name: str, suffix: str) -> Path:
        return self.root / "portbench" / kind / f"{name}{suffix}"

    def data(self, kind: str, name: str) -> dict:
        return json.loads(self.path(kind, name, ".json").read_text())

    def code(self, kind: str, name: str):
        """The module of ``portbench/<kind>/<name>.py`` (names may hold
        dots), loaded as a member of the ``portbench.<kind>`` package and
        entered in ``sys.modules`` under that name (a dataclass looks its
        module up there)."""
        path = self.path(kind, name, ".py")
        mod_name = f"portbench.{kind}.{name.replace('.', '__')}"
        spec = importlib.util.spec_from_file_location(mod_name, path)
        if spec is None or not path.is_file():
            raise FileNotFoundError(f"no file {path} for {kind} {name!r}")
        module = importlib.util.module_from_spec(spec)
        module.__package__ = f"portbench.{kind}"
        sys.modules[mod_name] = module
        spec.loader.exec_module(module)
        return module

    def cell(self, name: str) -> dict:
        for entry in self.spec["workloads"]:
            if entry["name"] == name:
                return entry
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def end_to_end(self, cell: str) -> list[dict]:
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list[dict]:
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]


class Run:
    """What a traffic kind and the metric readers see of a run."""

    def __init__(self, **kw):
        self.session = self.server = None
        self.batch = None
        self.window = None
        self.trace = None
        self.setup_s = None
        self.__dict__.update(kw)


def gaps(ids, outs, ref_codes: dict, n_pool: int) -> dict:
    """How the window's answers differ from the reference's answers for
    their images, code for code (request r carries image r % n_pool)."""
    if not len(ids):
        return {}
    want = np.stack([ref_codes[int(i) % n_pool] for i in ids])
    got = outs.astype(np.int16)
    d = np.abs(got - want)
    return {"mean_code_gap": float(d.mean()),
            "codes_off_pct": 100.0 * float(np.mean(d > 0)),
            "answers_off_pct": 100.0 * float(np.mean(d.max(axis=1) > 0)),
            "top1_off_pct": 100.0 * float(np.mean(
                got.argmax(axis=1) != want.argmax(axis=1))),
            "max_code_gap": int(d.max())}


def judge(ids, outs, ref_codes: dict, attempted: int, limits: dict):
    """The numbers compared, each with its limit, whether all hold, and
    the other readings of the gap.  ``mean_code_gap``: the mean distance,
    in int8 codes, between the window's answers and the reference's
    answers for their images, over every code of every answer;
    ``missing``: requests attempted in the window whose answer never
    came, or came twice."""
    g = gaps(ids, outs, ref_codes, limits["pool"])
    unique = len(np.unique(ids))
    missing = attempted - unique + (len(ids) - unique)
    gap = g.get("mean_code_gap")
    checks = {"mean_code_gap": {"value": gap,
                                "limit": limits["mean_code_gap"]},
              "missing": {"value": int(missing), "limit": 0}}
    correct = (gap is not None and gap <= limits["mean_code_gap"]
               and missing <= 0)
    return checks, correct, g


def prepare(workload: str, seed: int, seconds: float, trace: bool,
            device=None, root: Path = ROOT) -> Run:
    """Everything of a run up to its window: the cell's files, the
    architecture's reference and program modules (``run.ref``,
    ``run.program``; a missing one raises before any set-up), weights and
    images from ``seed``, the traffic kind's set-up (the program's session
    or server, calibrated and warm)."""
    import torch
    bench = Bench(root)
    entry = bench.cell(workload)
    wl = bench.data("workloads", workload)
    for key in ("config", "traffic", "chips"):
        if wl[key] != entry[key]:
            raise ValueError(f"{workload}: {key} {wl[key]!r} in its file, "
                             f"{entry[key]!r} in BENCHMARK.json")
    cfg = bench.data("configs", entry["config"])
    arch = cfg["model"]["arch"]
    ref = bench.code("reference", arch)
    program = bench.code("programs", arch)
    dev = torch.device(device or "cuda")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    model = cfg["model"]
    lyrs = ref.layers(model)
    shape = tuple(model["input"])
    run = Run(bench=bench, workload=workload, kind=bench.code("traffic",
                                                              wl["kind"]),
              ref=ref, program=program, cfg=cfg, params=wl["params"],
              trace_params=wl["trace"], limits=wl["limits"], device=dev,
              seconds=seconds, layers=lyrs,
              weights=inputs.weights(lyrs, seed, dev),
              calibration=inputs.calibration(shape, cfg["calibration_images"],
                                             seed, dev),
              pool=inputs.pool(shape, wl["params"]["pool"], seed, dev),
              rng=inputs.order_rng(seed), tracer=Tracer(trace, dev))
    run.kind.setup(run)
    run.tracer.warm()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return run


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device=None, root: Path = ROOT):
    """Run ``workload`` once.  Returns the result's dict (keys in the
    order printed) and the ``Run``."""
    import torch
    run = prepare(workload, seed, seconds, trace, device, root)
    bench, kind, dev = run.bench, run.kind, run.device
    run.setup_s = process_age_s()
    t_window = time.perf_counter()
    run.window = win = kind.drive(run)
    t_closed = time.perf_counter()
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    found = forbidden_modules()
    if found:
        raise Refused(f"modules of JAX or the JAX package loaded: {found}")
    kind.teardown(run)
    run.session = run.server = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, after the window and with the program's state freed
    ids, outs = win.outputs()
    n_pool = len(run.pool)
    used = sorted({int(i) % n_pool for i in ids})
    net = run.ref.Reference(run.cfg["model"], run.weights, run.calibration,
                            dev)
    codes = net(run.pool[used]) if used else []
    run.ref_codes = dict(zip(used, codes))
    run.ids, run.outs = ids, outs
    limits = dict(run.limits, pool=n_pool)
    checks, correct, readings = judge(ids, outs, run.ref_codes,
                                      win.attempted, limits)
    run.readings = readings
    win.notes.append(f"gap to the reference: {json.dumps(readings)}")
    win.notes.append(f"answers a second: {win.per_second()}")
    win.notes.append(f"seconds: set-up {run.setup_s}, window "
                     f"{t_closed - t_window}, reference and comparison "
                     f"{time.perf_counter() - t_closed} ({len(used)} images, "
                     f"{len(ids)} answers)")

    if trace:
        run.trace = run.tracer
        wanted = bench.per_layer(workload)
        folder = "metrics"
    else:
        wanted = bench.end_to_end(workload)
        folder = "endtoend"
    metrics = {}
    for m in wanted:
        value = bench.code(folder, m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
               "kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
               "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(win.attempted),
              "failed": int(win.failed), "metrics": metrics,
              "device": dev_rec}
    if trace and run.tracer.done:
        dev_rec["busy_s"] = run.tracer.busy_s
        dev_rec["window_s"] = run.tracer.window_s
        result["breakdown"] = run.tracer.breakdown()
        win.notes.append(f"trace: {run.tracer.dispatches} dispatches, "
                         f"{run.tracer.requests} requests, "
                         f"{len(run.tracer.events)} device events, aligned "
                         f"{run.tracer.aligned}")
    result["checks"] = checks
    return result, run
