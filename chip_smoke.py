#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` with nvcc, then:

1. prints the card's name and power limit (``nvidia-smi``);
2. lists every kernel launch that one forward of each main-path plan makes
   (``path_launches``), holds each kernel against its plain torch version on
   the card at every distinct shape of those launches (int8 output
   bit-exact, float32 output within the tolerance below), and times kernel
   (profiler device time and CUDA events), plain version and a library call
   there; all shapes go to ``chiprun_out/chip_smoke_shapes.json``;
3. serves int8 MobileNetV2 at the paper's full width (112x112x3, 1000
   classes, 54 layers) split spatially across 8 workers of unequal ratings
   through ``Session.submit_many`` on the card, and requires the output to
   equal a CPU session of the port bit for bit and the wrappers' launch
   counters to equal the launches listed for the plan;
4. does the same with a kernel-mode and a neuron-mode plan (the flat
   depthwise and im2col paths);
5. serves the float model on the card, allclose to the CPU;
6. prints a JSON line of every kernel: its launches in the three main-path
   runs, its largest error against its plain version, and the sums over
   those launches of its time, its bound, and the plain and library times
   at each launch's shape;
7. prints ``{"ok": true, "device": {...}}`` as the last line.

Any failure raises and exits non-zero, as does a machine without CUDA or a
directory without the repository's ``src``.  Weights are random, made from
seed 0; inputs from numpy seeds.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, int8 ops/s
PEAK_BYTES_S = 3.35e12
PEAK_INT8_OPS_S = 1979e12
BATCH = 8
RATINGS = [1.0, 0.8, 1.2, 0.6, 1.4, 0.9, 1.1, 0.7]
# float32 kernel output repeats the plain version's rounded multiply and add
# exactly; the tolerance only admits a last-bit difference
F32_RTOL, F32_ATOL = 1e-6, 1e-6
# float session: cuDNN on the card and the CPU's convolution sum in other
# orders over 54 layers; relative to the largest logit
FLOAT_RTOL = 1e-4


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms of one call of ``fn`` on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_trace(fn, iters: int = 1):
    """Run ``fn`` ``iters`` times under ``torch.profiler`` after one warm
    call; returns the (name, device microseconds) of every kernel and copy
    on the card, and the host wall microseconds of the traced calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA], wall_us


# -- main-path launches -------------------------------------------------------

def path_launches(engine, batch: int) -> list[tuple[str, str, tuple]]:
    """(kernel, layer, shape) of every kernel launch that one int8 forward
    of ``batch`` samples makes through ``engine``, in the order of
    ``CompiledSplitExecutor._forward``.  A qgemm shape is (M, K, N); a
    depthwise shape (windows, C, R, Wp, stride).  Each main-path run holds
    the count of these against the wrappers' launch counters."""
    from repro_torch.core.executor import _kernel_eligible_dwconv
    plan = engine.plan
    model = plan.model
    out = []
    for idxs in plan.block_groups:
        if plan.splits[idxs[0]].mode == "spatial":
            # one launch per stage over every band of every sample
            bb = engine._banded_block(idxs)
            n_win = batch * len(bb.bands)
            for st in bb.stages:
                layer = model.layers[st.index]
                c_in, _, w_in = layer.in_shape
                wp = w_in + 2 * layer.padding[1]
                r = int(st.src_rows.shape[1])
                if _kernel_eligible_dwconv(layer):
                    out.append(("dwconv3x3_bands", layer.name,
                                (n_win, c_in, r, wp, layer.stride[0])))
                elif layer.kind == "conv":
                    (kh, kw), (sh, sw) = layer.kernel, layer.stride
                    m = n_win * ((r - kh) // sh + 1) * ((wp - kw) // sw + 1)
                    out.append(("qgemm", layer.name,
                                (m, c_in * kh * kw, layer.out_shape[0])))
            continue
        # a flat layer: one launch per worker shard
        i = idxs[-1]
        layer, split = model.layers[i], plan.splits[i]
        if layer.kind == "linear":
            k = math.prod(layer.in_shape)
            out += [("qgemm", layer.name, (batch, k, sh.stop - sh.start))
                    for sh in split.shards if sh.n_positions]
            continue
        c_in, h_in, w_in = layer.in_shape
        spans = [g.c_hi - g.c_lo + 1 for g in engine._geometry[i]
                 if g is not None]
        if layer.kind == "conv":
            kh, kw = layer.kernel
            hw = layer.out_shape[1] * layer.out_shape[2]
            out += [("qgemm", layer.name, (batch * hw, c_in * kh * kw, n))
                    for n in spans]
        elif _kernel_eligible_dwconv(layer):
            out += [("dwconv3x3", layer.name,
                     (batch, n, h_in + 2, w_in + 2, layer.stride[0]))
                    for n in spans]
    return out


# -- phase 2: kernels against their plain versions ---------------------------

def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / PEAK_INT8_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _operands(kernel, shape, gen, dev, int_bias):
    """Random int8 operands of one launch, with a multiplier that keeps
    acc*scale near 1 so requantization spans the int8 range; returns the
    wrapper's positional operands and keyword options."""
    import torch
    if kernel == "qgemm":
        m, k, n = shape
        x = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                          dtype=torch.int8)
        w = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                          dtype=torch.int8)
        n_ch, fan_in = n, k
        kw = {}
    else:
        nb, c, r, wp, stride = shape
        x = torch.randint(-127, 128, (nb, c, r, wp), generator=gen,
                          device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (c, 3, 3), generator=gen, device=dev,
                          dtype=torch.int8)
        n_ch, fan_in = c, 9
        kw = {"stride": stride}
    scale = (torch.rand(n_ch, generator=gen, device=dev) + 0.5) / (
        127.0 * 127.0 * fan_in ** 0.5)
    if int_bias:
        bias = torch.randint(-2000, 2000, (n_ch,), generator=gen, device=dev,
                             dtype=torch.int32)
        kw.update(activation="relu6", out_scale=6.0 / 127)
    else:
        bias = torch.rand(n_ch, generator=gen, device=dev) - 0.5
        kw.update(activation="relu", out_scale=None)
    return (x, w, scale, bias), kw


def counters():
    """Each kernel's wrapper, which also holds its launch count."""
    from repro_torch.kernels.dwconv.dwconv import dwconv3x3, dwconv3x3_bands
    from repro_torch.kernels.qgemm.qgemm import qgemm
    return {"qgemm": qgemm, "dwconv3x3_bands": dwconv3x3_bands,
            "dwconv3x3": dwconv3x3}


def _plain(kernel):
    from repro_torch.kernels.dwconv.ref import dwconv3x3_ref
    from repro_torch.kernels.qgemm.ref import qgemm_ref
    return qgemm_ref if kernel == "qgemm" else dwconv3x3_ref


def _library(kernel, args, kw):
    """(name, call) of one PyTorch call computing the same product or
    convolution on the same inputs (no fused epilogue): ``torch._int_mm``
    where its shape limits allow, else ``torch.matmul`` or a grouped
    ``F.conv2d`` on float32 copies made before timing."""
    import torch
    import torch.nn.functional as F
    x, w = args[0], args[1]
    if kernel == "qgemm":
        m, k = x.shape
        n = w.shape[1]
        if m > 16 and k % 8 == 0 and n % 8 == 0:
            wt = w.t().contiguous().t()     # column-major, as cuBLASLt wants
            return "torch._int_mm", lambda: torch._int_mm(x, wt)
        # exact here: every |sum| < 1280 * 127^2 < 2^24
        xf, wf = x.float(), w.float()
        return "torch.matmul f32", lambda: torch.matmul(xf, wf)
    xf, wf = x.float(), w.float()[:, None]
    return "F.conv2d f32", lambda: F.conv2d(xf, wf, stride=kw["stride"],
                                            groups=x.shape[1])


def check_launch(kernel, shape, gen, dev) -> tuple[dict, tuple]:
    """Hold one kernel against its plain version at one launch shape, with
    the int32 bias and int8 output (bit-exact) and with the float bias and
    float32 output (within F32_RTOL/F32_ATOL); time kernel, plain version
    and library call with CUDA events.  Returns the record and the int8
    case's (operands, options) for the device-time trace."""
    import torch
    fn, plain = counters()[kernel], _plain(kernel)
    args, kw = _operands(kernel, shape, gen, dev, int_bias=True)
    got, ref = fn(*args, **kw), plain(*args, **kw)
    err = float((got.int() - ref.int()).abs().max())
    if not torch.equal(got, ref):
        raise AssertionError(f"{kernel} {shape}: differs from plain by {err}")
    fargs, fkw = _operands(kernel, shape, gen, dev, int_bias=False)
    fgot, fref = fn(*fargs, **fkw), plain(*fargs, **fkw)
    ferr = float((fgot - fref).abs().max())
    if not torch.allclose(fgot, fref, rtol=F32_RTOL, atol=F32_ATOL):
        raise AssertionError(f"{kernel} {shape} f32: max err {ferr}")
    if kernel == "qgemm":
        m, k, n = shape
        n_bytes, n_ops = m * k + k * n + 8 * n + m * n, 2.0 * m * n * k
    else:
        nb, c, r, wp, stride = shape
        n_out = nb * c * ((r - 3) // stride + 1) * ((wp - 3) // stride + 1)
        n_bytes, n_ops = nb * c * r * wp + 9 * c + 8 * c + n_out, 18.0 * n_out
    lib_name, lib = _library(kernel, args, kw)
    rec = dict(kernel=kernel, shape=list(shape), max_abs_err=max(err, ferr),
               event_ms=time_ms(lambda: fn(*args, **kw), 20),
               plain_ms=time_ms(lambda: plain(*args, **kw), 5, warmup=1),
               library=lib_name, library_ms=time_ms(lib, 20))
    rec["bound_ms"], rec["bound_by"] = bound_ms(n_bytes, n_ops)
    return rec, (fn, args, kw)


OUR_KERNELS = ("qgemm_kernel", "dwconv3x3_kernel")    # names in csrc/*.cu


def trace_device_ms(kernel_calls, per_shape: int = 5) -> list[float | None]:
    """Device ms of one launch of each (wrapper, operands, options) in
    ``kernel_calls``: one profiler trace of ``per_shape`` launches each,
    split in launch order.  None for all when the trace does not hold
    exactly one of this repository's kernels per launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn, args, kw in kernel_calls:
            for _ in range(per_shape):
                fn(*args, **kw)
        torch.cuda.synchronize()
    ours = sorted((e.time_range.start, e.time_range.elapsed_us())
                  for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and any(k in e.name for k in OUR_KERNELS))
    if len(ours) != per_shape * len(kernel_calls):
        print(f"device trace: {len(ours)} kernel events for "
              f"{per_shape * len(kernel_calls)} launches; no device times")
        return [None] * len(kernel_calls)
    return [sum(us for _, us in ours[j * per_shape:(j + 1) * per_shape])
            / per_shape / 1e3 for j in range(len(kernel_calls))]


# whole-layer launches the main path does not make (it splits both layers
# per worker), kept beside the path's own shapes as a yardstick
OFF_PATH = [("qgemm", "classifier whole layer", (BATCH, 1280, 1000)),
            ("dwconv3x3", "b1_dw one sample, all channels",
             (1, 96, 58, 58, 2))]


def kernel_phase(engines: dict, dev) -> tuple[dict, list[dict]]:
    """Every distinct (kernel, shape) that the main-path plans launch, plus
    ``OFF_PATH``: held against the plain version and timed.  Returns each
    plan's launch list and one record per distinct launch shape, with the
    layers and the launches per forward of each plan."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(0)
    launches = {mode: path_launches(eng, BATCH)
                for mode, eng in engines.items()}
    recs: dict[tuple, dict] = {}
    for mode, items in launches.items():
        for kernel, layer, shape in items:
            r = recs.setdefault((kernel, shape), dict(
                layers=[], per_forward={}, on_path=True))
            if layer not in r["layers"]:
                r["layers"].append(layer)
            r["per_forward"][mode] = r["per_forward"].get(mode, 0) + 1
    for kernel, layer, shape in OFF_PATH:
        recs.setdefault((kernel, shape), dict(layers=[layer], per_forward={},
                                              on_path=False))
    calls = []
    for (kernel, shape), r in recs.items():
        rec, call = check_launch(kernel, shape, gen, dev)
        r.update(rec)
        calls.append(call)
    for r, ms in zip(recs.values(), trace_device_ms(calls)):
        r["device_ms"] = ms
    del calls
    torch.cuda.empty_cache()
    return launches, list(recs.values())


def launch_ms(rec) -> float:
    """A launch's time on the card: the profiler's device time where the
    trace gave one, else the CUDA-event time of back-to-back calls."""
    return rec["device_ms"] if rec["device_ms"] is not None else rec[
        "event_ms"]


def per_forward(recs, kernel, mode) -> dict:
    """One forward's worth (batch BATCH, plan ``mode``) of ``kernel``:
    launches and the sums over them of each per-launch time."""
    rows = [r for r in recs if r["kernel"] == kernel and mode in
            r["per_forward"]]
    tot = {"launches": sum(r["per_forward"][mode] for r in rows),
           "shapes": len(rows)}
    for key, get in (("ms", launch_ms), ("plain_ms", lambda r: r["plain_ms"]),
                     ("bound_ms", lambda r: r["bound_ms"]),
                     ("library_ms", lambda r: r["library_ms"])):
        tot[key] = sum(r["per_forward"][mode] * get(r) for r in rows)
    return tot


# -- phases 3-5: the main path ------------------------------------------------

def serve_path(mode, model, qmodel, xs, dev, expect):
    """Drive one int8 plan on the card; hold it against the port on the CPU.
    ``expect`` is the launches per kernel that ``path_launches`` counted for
    one forward of this plan: the run must make exactly those.  Returns the
    launches of this run and the per-request ms."""
    from repro_torch.api import Session
    from repro_torch.core import split_model
    plan = split_model(model, RATINGS, mode=mode)
    sess = Session(plan, precision="int8", qmodel=qmodel, device=dev,
                   max_batch=BATCH)
    sess.warmup()
    wrappers = counters()
    for fn in wrappers.values():
        fn.launches = 0
    ys = sess.submit_many(xs)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    if launches != expect:
        raise AssertionError(f"{mode} path launched {launches}, its plan "
                             f"counts {expect}")
    for name in ("qgemm", "dwconv3x3" if mode != "spatial" else
                 "dwconv3x3_bands"):
        if launches[name] <= 0:
            raise AssertionError(f"{mode} path launched no {name}")
    cpu = Session(plan, precision="int8", qmodel=qmodel, device="cpu",
                  max_batch=BATCH)
    ys_cpu = cpu.submit_many(xs)
    if ys.shape != (len(xs), *model.out_shape) or ys.dtype.name != "int8":
        raise AssertionError(f"{mode}: output {ys.shape} {ys.dtype}")
    if not (ys == ys_cpu).all():
        raise AssertionError(f"{mode}: card output != CPU output in "
                             f"{int((ys != ys_cpu).sum())} places")
    if not ys.any():
        raise AssertionError(f"{mode}: output is all zeros")
    batch_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        sess.submit_many(xs)
        batch_ms.append((time.perf_counter() - t0) * 1e3 / len(xs))
    one_ms = []
    for x in xs:
        t0 = time.perf_counter()
        sess.run(x)
        one_ms.append((time.perf_counter() - t0) * 1e3)
    rec = dict(mode=mode, launches=launches, bit_exact_vs_cpu=True,
               ms_per_request_batch8=statistics.median(batch_ms),
               ms_request_batch1=statistics.median(one_ms),
               batch8_profile=profile_batch(sess, xs))
    print(f"path {json.dumps(rec)}")
    return rec


def profile_batch(sess, xs) -> dict:
    """Where one batch's device time goes: device time per kernel name
    (top ten), the batch's host wall time, and the share of that wall time
    the card sat idle."""
    events, wall_us = device_trace(lambda: sess.submit_many(xs))
    by_name: dict[str, float] = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(device_us=busy, launches=len(events), wall_us=wall_us,
                idle_share=(1 - busy / wall_us) if events else None,
                top=[dict(name=n[:80], us=us) for n, us in top])


def float_path(model, xs, dev):
    import numpy as np
    from repro_torch.api import Session
    from repro_torch.core import split_model
    plan = split_model(model, RATINGS, mode="spatial")
    ys = Session(plan, precision="float", device=dev,
                 max_batch=BATCH).submit_many(xs)
    ys_cpu = Session(plan, precision="float", device="cpu",
                     max_batch=BATCH).submit_many(xs)
    if not np.isfinite(ys).all():
        raise AssertionError("float path: non-finite output")
    atol = FLOAT_RTOL * float(np.abs(ys_cpu).max())
    err = float(np.abs(ys - ys_cpu).max())
    if not np.allclose(ys, ys_cpu, rtol=FLOAT_RTOL, atol=atol):
        raise AssertionError(f"float path: max err {err} > {atol}")
    print(f"path {json.dumps(dict(mode='spatial float', max_abs_err=err))}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.api import Session
    from repro_torch.core import CompiledSplitExecutor, split_model
    from repro_torch.kernels import backend
    from repro_torch.models import mobilenet_v2_paper

    t0 = time.perf_counter()
    backend.build()
    print(f"build {json.dumps(dict(seconds=time.perf_counter() - t0))}")
    dev = "cuda"
    card = card_line()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    model = mobilenet_v2_paper(seed=0)
    if (len(model.layers), model.input_shape, model.out_shape) != (
            54, (3, 112, 112), (1000, 1, 1)):
        raise AssertionError("mobilenet_v2_paper is not the paper's model")
    modes = ("spatial", "kernel", "neuron")
    engines = {mode: CompiledSplitExecutor(split_model(model, RATINGS,
                                                       mode=mode), device=dev)
               for mode in modes}
    plan_launches, recs = kernel_phase(engines, dev)
    del engines
    # printed: the spatial plan's named layers, the flat plans' b1_dw
    # shards and the off-path yardsticks; every shape is in the JSON file
    named = {"stem", "b1_expand", "b16_project", "head_conv", "classifier",
             "b1_dw", "b14_dw"}
    for r in recs:
        if not r["on_path"] or named & set(r["layers"]) and (
                "spatial" in r["per_forward"] or "b1_dw" in r["layers"]):
            print(f"kernel {json.dumps(r)}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_shapes.json").write_text(json.dumps(
        dict(card=card, batch=BATCH, shapes=recs), indent=1))

    rng = np.random.default_rng(0)
    calib = [rng.standard_normal(model.input_shape).astype(np.float32)
             for _ in range(2)]
    qmodel = Session(split_model(model, RATINGS, mode="spatial"),
                     calibration=calib, device="cpu").qmodel
    xs = rng.standard_normal((BATCH, *model.input_shape)).astype(np.float32)
    names = ("qgemm", "dwconv3x3_bands", "dwconv3x3")
    paths = []
    for mode in modes:
        expect = {k: sum(1 for kk, _, _ in plan_launches[mode] if kk == k)
                  for k in names}
        paths.append(serve_path(mode, model, qmodel, xs, dev, expect))
    float_path(model, xs, dev)

    source = {"qgemm": "src/repro_torch/csrc/qgemm.cu",
              "dwconv3x3_bands": "src/repro_torch/csrc/dwconv.cu",
              "dwconv3x3": "src/repro_torch/csrc/dwconv.cu"}
    replaces = {"qgemm": "src/repro/kernels/qgemm/qgemm.py:63",
                "dwconv3x3_bands": "src/repro/kernels/dwconv/dwconv.py:133",
                "dwconv3x3": "src/repro/kernels/dwconv/dwconv.py:96"}
    # each kernel's numbers cover the launches of all three main-path
    # runs: launches from the counters, each time the sum over those
    # launches of its per-launch time at the launch's own shape
    line = []
    for name in names:
        fwd = {mode: per_forward(recs, name, mode) for mode in modes}
        for p in paths:
            if fwd[p["mode"]]["launches"] != p["launches"][name]:
                raise AssertionError(f"{name}: {p['mode']} counts differ")
            print("forward " + json.dumps(dict(kernel=name, mode=p["mode"],
                                               **fwd[p["mode"]])))
        rows = [r for r in recs if r["kernel"] == name and r["on_path"]]
        by_bytes = sum(r["bound_ms"] * sum(r["per_forward"].values())
                       for r in rows if r["bound_by"] == "bytes")
        line.append(dict(
            name=name, route="cuda", source=source[name],
            replaces=replaces[name],
            launches=sum(p["launches"][name] for p in paths),
            max_abs_err=max(r["max_abs_err"] for r in rows),
            **{key: sum(f[key] for f in fwd.values())
               for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
            bound_by=("bytes" if 2 * by_bytes >= sum(f["bound_ms"] for f in
                                                    fwd.values())
                      else "operations"),
            ms_from="profiler" if all(r["device_ms"] is not None
                                      for r in rows) else "events",
            launches_by_path={p["mode"]: p["launches"][name] for p in paths}))
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
