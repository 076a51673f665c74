#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` with nvcc, then:

1. prints the card's name and power limit (``nvidia-smi``);
2. lists every kernel launch that one forward of each main-path plan makes
   (``path_launches``: one ``dwconv3x3`` launch over all worker shards of
   each flat depthwise layer, one ``dwconv3x3_bands`` launch over all bands
   of each spatial depthwise stage, both on unpadded input), holds each
   kernel against its plain torch version on the card at every distinct
   shape of those launches, in the form the engine calls it (int8 output
   bit-exact, float32 output within the tolerance below), and times kernel
   (profiler device time, summed over every kernel a wrapper enqueues for
   one launch, and CUDA events), plain version and a library call there;
   prints each shape's schedule (tile, splits, grid) beside its time; all
   shapes go to ``chiprun_out/chip_smoke_shapes.json``.  This step runs
   after step 6, over the engine's and the workers' launches together;
3. serves int8 MobileNetV2 at the paper's full width (112x112x3, 1000
   classes, 54 layers) split spatially across 8 workers of unequal ratings
   through ``Session.submit_many`` on the card, and requires the output to
   equal a CPU session of the port bit for bit, the wrappers' launch
   counters to equal the launches listed for the plan, and no weight to be
   copied into the kernel's layout (``qgemm.weight_copies`` 0);
4. does the same with a kernel-mode and a neuron-mode plan (the flat
   depthwise and im2col paths);
5. serves the float model on the card, allclose to the CPU;
6. the planner stack and the distributed runtime:
   (a) ``Planner`` on ``Cluster.heterogeneous_demo(8)`` must reproduce
       the committed ``mnv2_112@8`` outcome of ``BENCH_executor.json``
       (spatial, layer fusion, 7 workers, pipelined; its latency is the
       planner's simulated MCU latency), and ``plan.compile`` on the card
       serves a batch bit-exact with a CPU ``Session`` (``planner`` line);
   (b) that session's ``distributed(spawn="process")``: 7 worker
       processes on the card (logs in ``chiprun_out/workers``; a worker
       that exits during setup fails the run at once with its log tail)
       serve BATCH requests bit-exact with the card's ``Session``,
       realizing every dependency edge the simulator predicts;
   (c) the kernel-mode split of the 8 workers above over in-process
       workers, held the same way, whose launch counters must equal the
       launches the setup payloads list; each run prints a
       ``distributed`` line (setup s, ms per request on the host clock,
       the workers' summed compute ms per request from the coordinator's
       timeline, launches per request by kernel);
   (d) an in-process ``ElasticCoordinator`` over ``mobilenet_v2_smoke``
       on 4 workers: one worker is killed with a request in flight; every
       output must equal the card's ``Session`` on its topology, the
       replan must reship less than a full setup and hit the warm segment
       cache at rate 1.0 (``elastic`` line);
   every (kernel, shape) the workers launch, read from the setup
   payloads' segment specs, is held against its plain version and timed
   with the engine's shapes in step 2 (``path: "distributed"`` in
   ``chiprun_out/chip_smoke_shapes.json``; ``dist_shapes`` lines sum
   each run);
7. the LM serving path, ``qwen3-14b`` at its published width:
   (a) 2 layers in float32 with TF32 off: prefill and 4 greedy decode
       steps through the serve steps must give the full forward's
       last-position logits (rtol 2e-3, atol 2e-4) and the same tokens;
   (b) all 40 layers in bf16 serve 8 prompts of 2048 tokens: prefill, then
       32 greedy decode steps, whose attention against the cache is the
       flash-decode kernel (its counter must equal 32 x 40 launches and the
       other kernels' 0) and which may make no synchronising call
       (``torch.cuda.set_sync_debug_mode("error")``); prints prefill ms,
       decode ms per step and tokens/s beside the step's bound, the card's
       busy and idle share over the last 2 steps (``torch.profiler``) and
       the peak memory; logits must be finite;
   (c) holds flash-decode against its plain version on layer 0's live
       cache and on one layer's cache at decode_32k's context (S 32768,
       ragged lengths; not on the path), in bf16 within a tolerance
       scaled to the output's largest magnitude and again with peaked
       logits, and times kernel (its split and merge kernels), plain
       version and ``F.scaled_dot_product_attention`` there, beside the
       bound and its schedule;
   the LM records go to ``chiprun_out/chip_smoke_lm.json``;
8. prints a JSON line of every kernel: its launches in the counted runs
   (the three engine plans and the in-process distributed run), its
   largest error against its plain version, and the sums over those
   launches of its time, its bound, and the plain and library times at
   each launch's shape;
9. prints ``{"ok": true, "device": {...}}`` as the last line.

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
# torch kernels that open and close a trace that counts this repository's
# kernels (pad_trace)
PAD_KERNELS = 64


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


def pad_trace() -> None:
    """Launch PAD_KERNELS small torch kernels (none of this repository's)
    and wait for them.  Traces of this script have dropped kernels (a run
    lost 5 of every trace of 240 launches), so a trace that counts this
    repository's kernels begins and ends with these."""
    import torch
    x = torch.zeros(1024, device="cuda")
    for _ in range(PAD_KERNELS):
        x.add_(1)
    torch.cuda.synchronize()


def trace_calls(fn, n: int, pad: bool = False):
    """Run ``fn`` ``n`` times under the profiler (no warm-up call), between
    two ``pad_trace`` calls when ``pad``.  Returns (name, device us) of
    every event on the card, the host wall us of the traced calls, and the
    last call's result."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if pad:
            pad_trace()
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        if pad:
            pad_trace()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA], wall_us, out


# -- main-path launches -------------------------------------------------------

def path_launches(engine, batch: int) -> list[tuple[str, str, tuple]]:
    """(kernel, layer, shape) of every kernel launch that one int8 forward
    of ``batch`` samples makes through ``engine``, in the order of
    ``CompiledSplitExecutor._forward``.  A qgemm shape is (M, K, N); a band
    stack's (windows, C, R, W, stride), width unpadded; a flat depthwise
    layer's (batch, C, H, W, stride, shards), input unpadded, with each
    worker shard's (c_lo, c_hi, start, stop): one launch over all of them.
    Each main-path run holds the count of these against the wrappers'
    launch counters."""
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
                    # the kernel pads the width itself
                    out.append(("dwconv3x3_bands", layer.name,
                                (n_win, c_in, r, w_in, layer.stride[0])))
                elif layer.kind == "conv":
                    (kh, kw), (sh, sw) = layer.kernel, layer.stride
                    m = n_win * ((r - kh) // sh + 1) * ((wp - kw) // sw + 1)
                    out.append(("qgemm", layer.name,
                                (m, c_in * kh * kw, layer.out_shape[0])))
            continue
        # a flat layer: one launch per worker shard (qgemm), or one over
        # all of them (depthwise)
        i = idxs[-1]
        layer, split = model.layers[i], plan.splits[i]
        if layer.kind == "linear":
            k = math.prod(layer.in_shape)
            out += [("qgemm", layer.name, (batch, k, sh.stop - sh.start))
                    for sh in split.shards if sh.n_positions]
            continue
        c_in, h_in, w_in = layer.in_shape
        geoms = [g for g in engine._geometry[i] if g is not None]
        spans = [g.c_hi - g.c_lo + 1 for g in geoms]
        if layer.kind == "conv":
            kh, kw = layer.kernel
            hw = layer.out_shape[1] * layer.out_shape[2]
            out += [("qgemm", layer.name, (batch * hw, c_in * kh * kw, n))
                    for n in spans]
        elif _kernel_eligible_dwconv(layer):
            shards = tuple((g.c_lo, g.c_hi, g.start, g.stop) for g in geoms)
            out.append(("dwconv3x3", layer.name,
                        (batch, c_in, h_in, w_in, layer.stride[0], shards)))
    return out


# -- phase 2: kernels against their plain versions ---------------------------

def bound_ms(n_bytes: float, n_ops: float,
             peak_ops: float = PEAK_INT8_OPS_S) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / peak_ops
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
        # stored (N, K) and passed as its (K, N) view, as the engine does
        w = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                          dtype=torch.int8).t()
        n_ch, fan_in = n, k
        kw = {}
    else:
        nb, c, r, wp, stride = shape[:5]
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
    from repro_torch.kernels.decode_attn.decode_attn import decode_attn
    from repro_torch.kernels.dwconv.dwconv import dwconv3x3, dwconv3x3_bands
    from repro_torch.kernels.qgemm.qgemm import qgemm
    return {"qgemm": qgemm, "dwconv3x3_bands": dwconv3x3_bands,
            "dwconv3x3": dwconv3x3, "decode_attn": decode_attn}


def dw_pad(kernel, shape) -> tuple[int, int]:
    """Zero rows and columns the depthwise kernel reads around its input at
    a launch shape: a flat layer's SAME border, a band stack's width, none
    for the pre-padded whole-sample yardstick."""
    if kernel == "dwconv3x3_bands":
        return (0, 1)
    return (1, 1) if len(shape) == 6 else (0, 0)


def launch_fns(kernel, shape):
    """(kernel call, its plain version) of one launch shape, each taking
    (x, w, scale, bias, **options): the wrapper form the engine calls there
    (a flat layer's shard table built here) and the plain torch loop it
    replaces."""
    from repro_torch.kernels.dwconv import ops, ref
    from repro_torch.kernels.dwconv.dwconv import dwconv3x3
    from repro_torch.kernels.qgemm.qgemm import qgemm
    from repro_torch.kernels.qgemm.ref import qgemm_ref
    if kernel == "qgemm":
        return qgemm, qgemm_ref
    if kernel == "dwconv3x3_bands":
        return ops.dwconv_bands_unpadded, ref.dwconv_bands_unpadded_ref
    if len(shape) == 5:
        return dwconv3x3, ref.dwconv3x3_ref
    table = ops.shard_table(shape[5])
    return (lambda x, *a, **kw: ops.dwconv_shards(x, table, *a, **kw),
            lambda x, *a, **kw: ref.dwconv_shards_ref(x, table.rows, *a,
                                                      **kw))


def _library(kernel, shape, args, kw):
    """(name, call) of one PyTorch call computing the same product or
    convolution on the same inputs (no fused epilogue): ``torch._int_mm``
    where its shape limits allow, else ``torch.matmul``, or a grouped
    ``F.conv2d`` over the whole layer or stack (padding as the kernel
    reads it), on float32 copies made before timing."""
    import torch
    import torch.nn.functional as F
    x, w = args[0], args[1]
    if kernel == "qgemm":
        m, k = x.shape
        n = w.shape[1]
        if m > 16 and k % 8 == 0 and n % 8 == 0:
            # w is column-major already, as cuBLASLt wants
            return "torch._int_mm", lambda: torch._int_mm(x, w)
        # exact here: every |sum| < 1280 * 127^2 < 2^24
        xf, wf = x.float(), w.float()
        return "torch.matmul f32", lambda: torch.matmul(xf, wf)
    xf, wf = x.float(), w.float()[:, None]
    pad = dw_pad(kernel, shape)
    return "F.conv2d f32", lambda: F.conv2d(xf, wf, stride=kw["stride"],
                                            padding=pad, groups=x.shape[1])


def schedule(kernel, shape) -> dict:
    """The grid a wrapper launches at ``shape``: its split choice and tile
    (``qgemm_schedule``), or the depthwise kernel's (``dwconv_schedule``)."""
    import torch
    from repro_torch.kernels import backend
    n_sm = backend.sm_count(torch.device("cuda", 0))
    if kernel == "qgemm":
        from repro_torch.kernels.qgemm.qgemm import BN, qgemm_schedule
        m, k, n = shape
        bm, splits, k_chunk = qgemm_schedule(m, n, k, n_sm)
        return dict(tile=[bm, BN], splits=splits, k_chunk=k_chunk,
                    grid=[-(-m // bm), -(-n // BN), splits])
    from repro_torch.kernels.dwconv.dwconv import dwconv_schedule
    nb, c, h, w, stride = shape[:5]
    spans = ([hi - lo + 1 for lo, hi, _, _ in shape[5]] if len(shape) == 6
             else [c])
    sch = dwconv_schedule(nb, spans, h, w, stride, dw_pad(kernel, shape),
                          n_sm)
    return dict(rows_tile=sch.rows_tile, c_tile=sch.c_tile, smem=sch.smem,
                shards=len(spans), grid=[nb, sch.tiles])


def check_launch(kernel, shape, gen, dev) -> tuple[dict, tuple]:
    """Hold one kernel against its plain version at one launch shape, with
    the int32 bias and int8 output (bit-exact) and with the float bias and
    float32 output (within F32_RTOL/F32_ATOL); time kernel, plain version
    and library call with CUDA events.  Returns the record and the int8
    case's (kernels a launch enqueues, call, operands, options) for the
    device-time trace."""
    import torch
    fn, plain = launch_fns(kernel, shape)
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
        # the input as the kernel reads it (unpadded but for the padded
        # yardstick) once, taps, scale and bias, every output once
        c = shape[1]
        n_out = got.numel()
        n_bytes = args[0].numel() + 9 * c + 8 * c + n_out
        n_ops = 18.0 * n_out
    lib_name, lib = _library(kernel, shape, args, kw)
    rec = dict(kernel=kernel, shape=list(shape), max_abs_err=max(err, ferr),
               event_ms=time_ms(lambda: fn(*args, **kw), 20),
               plain_ms=time_ms(lambda: plain(*args, **kw), 5, warmup=1),
               library=lib_name, library_ms=time_ms(lib, 20),
               schedule=schedule(kernel, shape))
    rec["bound_ms"], rec["bound_by"] = bound_ms(n_bytes, n_ops)
    return rec, (counters()[kernel].kernels_per_launch, fn, args, kw)


# name prefixes of the kernels in csrc/*.cu: every kernel a wrapper
# enqueues starts with its wrapper's name
OUR_KERNELS = ("qgemm_", "dwconv3x3_", "decode_attn_")


TRACE_CHUNK = 48        # launch shapes one profiler trace holds
TRACE_TRIES = 3         # traces of a chunk before its shapes go without


def _trace_chunk(kernel_calls, per_shape: int) -> list[float] | None:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        pad_trace()
        for _, fn, args, kw in kernel_calls:
            for _ in range(per_shape):
                fn(*args, **kw)
        pad_trace()
    ours = sorted((e.time_range.start, e.time_range.elapsed_us())
                  for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and any(k in e.name for k in OUR_KERNELS))
    counts = [per_shape * k for k, _, _, _ in kernel_calls]
    if len(ours) != sum(counts):
        print(f"device trace: {len(ours)} kernel events for {sum(counts)} "
              f"kernels of {per_shape * len(kernel_calls)} launches")
        return None
    out, i = [], 0
    for c in counts:
        out.append(sum(us for _, us in ours[i:i + c]) / per_shape / 1e3)
        i += c
    return out


def trace_device_ms(kernel_calls, per_shape: int = 5) -> list[float | None]:
    """Device ms of one launch of each (kernels per launch, call, operands,
    options) in ``kernel_calls``: profiler traces of ``per_shape`` launches
    each, TRACE_CHUNK shapes a trace padded by ``pad_trace``, split in
    launch order; a launch's time is the sum of the kernels its wrapper
    enqueues.  A trace that does not hold exactly that many of this
    repository's kernels per launch is taken again, up to TRACE_TRIES
    times; a chunk that never gets one has no device times (None), and its
    shapes fall back to CUDA events."""
    out = []
    for i in range(0, len(kernel_calls), TRACE_CHUNK):
        chunk = kernel_calls[i:i + TRACE_CHUNK]
        got = None
        for _ in range(TRACE_TRIES):
            got = _trace_chunk(chunk, per_shape)
            if got is not None:
                break
        out += got if got is not None else [None] * len(chunk)
    return out


# launches the main path does not make, kept beside the path's own shapes
# as yardsticks: the classifier unsplit, and b1_dw on one pre-padded sample
# through the reference's contract (``dwconv3x3``)
OFF_PATH = [("qgemm", "classifier whole layer", (BATCH, 1280, 1000)),
            ("dwconv3x3", "b1_dw one sample, all channels",
             (1, 96, 58, 58, 2))]


def kernel_phase(runs: dict, dev) -> list[dict]:
    """Every distinct (kernel, shape) that the runs launch, plus
    ``OFF_PATH``: held against the plain version and timed.  ``runs`` maps
    each run to every launch it made, (kernel, layer, shape): one forward
    of an engine plan (``path_launches``), or all requests of a distributed
    run (``dist_launches``).  Returns one record per distinct launch shape,
    with its layers, its launches in each run (``per_run``) and the paths
    that made it (``path``: ``engine``, ``distributed``, both joined by
    ``+``, or ``none`` for ``OFF_PATH``)."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(0)
    # the one-launch depthwise form is held on the plans' own shard tables;
    # the neuron plan's must include a channel split between two shards
    if not any(a[1] == b[0] for kernel, _, shape in runs["neuron"]
               if kernel == "dwconv3x3" and len(shape) == 6
               for a, b in zip(shape[5], shape[5][1:])):
        raise AssertionError("no neuron shard table splits a channel")
    recs: dict[tuple, dict] = {}
    for run, items in runs.items():
        path = "distributed" if run in DIST_RUNS else "engine"
        for kernel, layer, shape in items:
            r = recs.setdefault((kernel, shape), dict(
                layers=[], per_run={}, path=path, on_path=True))
            if layer not in r["layers"]:
                r["layers"].append(layer)
            if path not in r["path"]:
                r["path"] += "+" + path
            r["per_run"][run] = r["per_run"].get(run, 0) + 1
    for kernel, layer, shape in OFF_PATH:
        recs.setdefault((kernel, shape), dict(layers=[layer], per_run={},
                                              path="none", on_path=False))
    calls = []
    for (kernel, shape), r in recs.items():
        rec, call = check_launch(kernel, shape, gen, dev)
        r.update(rec)
        calls.append(call)
    for r, ms in zip(recs.values(), trace_device_ms(calls)):
        r["device_ms"] = ms
    del calls
    torch.cuda.empty_cache()
    return list(recs.values())


def launch_ms(rec) -> float:
    """A launch's time on the card: the profiler's device time where the
    trace gave one, else the CUDA-event time of back-to-back calls."""
    return rec["device_ms"] if rec["device_ms"] is not None else rec[
        "event_ms"]


def per_run(recs, kernel, run) -> dict:
    """One run's worth of ``kernel`` (a forward of batch BATCH of an engine
    plan, or all requests of a distributed run): launches and the sums over
    them of each per-launch time."""
    rows = [r for r in recs if r["kernel"] == kernel and run in
            r["per_run"]]
    tot = {"launches": sum(r["per_run"][run] for r in rows),
           "shapes": len(rows)}
    for key, get in (("ms", launch_ms), ("plain_ms", lambda r: r["plain_ms"]),
                     ("bound_ms", lambda r: r["bound_ms"]),
                     ("library_ms", lambda r: r["library_ms"])):
        tot[key] = sum(r["per_run"][run] * get(r) for r in rows)
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
    wrappers["qgemm"].weight_copies = 0
    ys = sess.submit_many(xs)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    if wrappers["qgemm"].weight_copies:
        raise AssertionError(f"{mode} path copied "
                             f"{wrappers['qgemm'].weight_copies} weights")
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
    if wrappers["qgemm"].weight_copies:
        raise AssertionError(f"{mode} path copied "
                             f"{wrappers['qgemm'].weight_copies} weights")
    rec = dict(mode=mode, launches=launches, bit_exact_vs_cpu=True,
               weight_copies=0,
               ms_per_request_batch8=statistics.median(batch_ms),
               ms_request_batch1=statistics.median(one_ms),
               batch8_profile=profile_batch(sess, xs))
    print(f"path {json.dumps(rec)}")
    return rec


def profile_batch(sess, xs) -> dict:
    """Where one batch's device time goes: device time per kernel name
    (top ten), the batch's host wall time, and the share of that wall time
    the card sat idle."""
    sess.submit_many(xs)
    events, wall_us, _ = trace_calls(lambda: sess.submit_many(xs), 1)
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


# -- distributed phases: planner, coordinator + workers, elastic ---------------

RAM_CAP = 512 * 1024               # the planner's per-worker RAM cap (MCU)
PLANNER_PIN = "mnv2_112@8"         # BENCH_executor.json's committed outcome
DIST_RUNS = ("dist_spatial_process", "dist_kernel_inprocess", "elastic")
DIST_TIMEOUT_S = 600
ELASTIC_WORKERS = 4


def planner_phase(model, qmodel, xs, dev):
    """Plan ``mobilenet_v2_paper`` on ``Cluster.heterogeneous_demo(8)``
    under the MCU RAM cap: the plan must be the committed one
    (``BENCH_executor.json``, ``PLANNER_PIN``).  Its latency is the
    planner's simulated MCU latency, a model output.  ``plan.compile`` on
    the card then serves a batch of BATCH bit-exact with a CPU ``Session``
    of the same split.  Returns the plan and its card session."""
    import numpy as np
    from repro_torch.api import Cluster, Objective, Planner, Session
    want = json.loads((ROOT / "BENCH_executor.json").read_text())[
        "planner"][PLANNER_PIN]
    t0 = time.perf_counter()
    plan = Planner(model, Cluster.heterogeneous_demo(8)).plan(
        Objective(minimize="latency", ram_cap_bytes=RAM_CAP))
    search_s = time.perf_counter() - t0
    got = dict(plan_latency_s=round(plan.latency_s, 9),
               max_peak_ram=int(plan.max_peak_ram), mode=plan.mode,
               fusion=plan.fusion, transport=plan.transport,
               overlap_saved_s=round(plan.overlap_saved_s, 9),
               n_workers=plan.n_workers)
    if got != {k: want[k] for k in got}:
        raise AssertionError(f"planner: {got} is not {PLANNER_PIN} {want}")
    sess = plan.compile(qmodel=qmodel, device=dev, max_batch=BATCH)
    ys = sess.submit_many(xs)
    cpu = Session(plan.split, qmodel=qmodel, device="cpu", max_batch=BATCH)
    if not np.array_equal(ys, cpu.submit_many(xs)):
        raise AssertionError("planner: plan.compile on the card != CPU")
    rec = dict(pin=PLANNER_PIN, **got, simulated_mcu_latency_s=plan.latency_s,
               search_s=search_s,
               candidates_evaluated=plan.search_stats["candidates_evaluated"],
               session_transport=sess.stats().transport, batch=len(xs),
               bit_exact_vs_cpu=True)
    print(f"planner {json.dumps(rec)}")
    return plan, sess


def dist_launches(split, qmodel) -> list[tuple[str, str, tuple]]:
    """(kernel, layer, shape) of every kernel launch one request makes on
    the workers of ``split``, read from their setup payloads' segment
    specs (``segment_launches``)."""
    from repro_torch.runtime.shards import build_worker_setup, segment_launches
    out = []
    for w in range(split.n_workers):
        meta, arrays = build_worker_setup(split, qmodel, "int8", w)
        for spec in meta["segments"]:
            out += [(k, split.model.layers[i].name, shape)
                    for k, shape, i in segment_launches(spec, arrays)]
    return out


def _log_tails(coord, n_bytes: int = 1500) -> str:
    """The end of each spawned worker's log (``log_dir``)."""
    if not coord.log_dir:
        return ""
    out = []
    for path in sorted(Path(coord.log_dir).glob("worker*.log")):
        out.append(f"--- {path.name}\n"
                   + path.read_bytes()[-n_bytes:].decode(errors="replace"))
    return "\n".join(out)


async def _start(coord) -> None:
    """Start ``coord``.  A spawned worker that exits before it is ready
    fails the start at once (the coordinator alone would wait out its
    setup timeout for it)."""
    import asyncio
    start = asyncio.ensure_future(coord.start())
    while not start.done():
        await asyncio.wait({start}, timeout=0.5)
        dead = [w for w, h in coord.handles.items()
                if h.proc is not None and h.proc.returncode is not None]
        if dead and not start.done():
            start.cancel()
            await asyncio.gather(start, return_exceptions=True)
            raise RuntimeError(f"worker(s) {dead} exited during setup")
    start.result()


def distributed_run(name, coord, xs, want, split, per_request) -> dict:
    """Serve ``xs`` through ``coord`` (started here, closed after) and hold
    its output to ``want`` bit for bit and its realized dependency edges to
    the simulator's.  The launch counters are set to 0 once the workers are
    ready and read after the last request: in-process workers must have
    made exactly ``per_request`` (from the payloads) x requests; a
    coordinator with worker processes launches no kernel itself."""
    import asyncio

    import numpy as np
    from repro_torch.core.simulator import dependency_edges

    async def drive():
        try:
            await _start(coord)
            wrappers = counters()
            for fn in wrappers.values():
                fn.launches = 0
            wrappers["qgemm"].weight_copies = 0
            ys, compute_ms = [], []
            t0 = time.perf_counter()
            for x in xs:
                ys.append(await coord.infer(x))
                compute_ms.append(
                    float(coord.last_timeline.compute_busy_s.sum()) * 1e3)
            wall = time.perf_counter() - t0
            launches = {k: fn.launches for k, fn in wrappers.items()}
            return (ys, compute_ms, wall, launches, set(coord.measured_edges),
                    coord.setup_s, wrappers["qgemm"].weight_copies)
        except Exception as e:
            raise RuntimeError(f"distributed {name}: {e}\n"
                               f"{_log_tails(coord)}") from e
        finally:
            await coord.close()

    ys, compute_ms, wall, launches, edges, setup_s, copies = asyncio.run(
        asyncio.wait_for(drive(), DIST_TIMEOUT_S))
    ys = np.stack(ys)
    if ys.shape != want.shape or ys.dtype != want.dtype:
        raise AssertionError(f"{name}: output {ys.shape} {ys.dtype}")
    if not np.array_equal(ys, want):
        raise AssertionError(f"{name}: distributed output != the card's "
                             f"Session in {int((ys != want).sum())} places")
    predicted = dependency_edges(split)
    if not predicted <= edges:
        raise AssertionError(f"{name}: {len(predicted - edges)} predicted "
                             f"edges not realized")
    expect = {k: sum(kk == k for kk, _, _ in per_request) * len(xs)
              for k in launches}
    inproc = coord.spawn == "inprocess"
    if inproc and launches != expect:
        raise AssertionError(f"{name}: workers launched {launches}, their "
                             f"payloads list {expect}")
    if not inproc and any(launches.values()):
        raise AssertionError(f"{name}: the coordinator launched {launches}")
    if copies:
        raise AssertionError(f"{name}: {copies} weight copies")
    rec = dict(
        run=name, mode=split.mode, workers=split.n_workers,
        spawn=coord.spawn, requests=len(xs), bitexact=True,
        edges_realized=len(predicted & edges), edges_predicted=len(predicted),
        setup_s=setup_s, ms_per_request=wall * 1e3 / len(xs),
        worker_compute_ms_per_request=statistics.mean(compute_ms),
        launches=launches,
        launches_per_request={k: v / len(xs) for k, v in expect.items()
                              if k in ("qgemm", "dwconv3x3")},
        launches_per_request_from="counters" if inproc else "payloads")
    print(f"distributed {json.dumps(rec)}")
    return rec


def distributed_phase(model, qmodel, xs, plan, psess, dev):
    """The planner's plan over worker subprocesses on the card, then the
    kernel-mode split of RATINGS over in-process workers (whose launches
    the counters see).  Returns the two records and each run's launches
    (every request's, for the shape checks)."""
    from repro_torch.api import Session
    from repro_torch.core import split_model
    want = psess.submit_many(xs)
    per_request = dist_launches(plan.split, qmodel)
    logs = ROOT / "chiprun_out" / "workers"
    spatial = distributed_run(
        "dist_spatial_process",
        psess.distributed(spawn="process", log_dir=str(logs)), xs, want,
        plan.split, per_request)
    ksplit = split_model(model, RATINGS, mode="kernel")
    ksess = Session(ksplit, qmodel=qmodel, device=dev, max_batch=BATCH)
    k_per_request = dist_launches(ksplit, qmodel)
    kernel = distributed_run(
        "dist_kernel_inprocess", ksess.distributed(spawn="inprocess"), xs,
        ksess.submit_many(xs), ksplit, k_per_request)
    for name, n in kernel["launches_per_request"].items():
        if n <= 0:
            raise AssertionError(f"in-process kernel run: no {name} launch")
    return [spatial, kernel], {
        "dist_spatial_process": per_request * len(xs),
        "dist_kernel_inprocess": k_per_request * len(xs)}


def elastic_phase(dev):
    """An in-process ``ElasticCoordinator`` over ``mobilenet_v2_smoke`` on
    ELASTIC_WORKERS workers of the card: a worker is killed while a request
    is in flight; the request is served on the replanned survivors.  Every
    output must equal the card's ``Session`` on its topology; the replan
    must reship less than a full setup and hit the warm segment cache at
    rate 1.0.  Returns the record and the launches of one request on each
    topology."""
    import asyncio

    import numpy as np
    from repro_torch.api import Objective, Session
    from repro_torch.core import WorkerParams, split_model
    from repro_torch.models import mobilenet_v2_smoke
    from repro_torch.runtime import ElasticCluster, ElasticCoordinator
    model = mobilenet_v2_smoke(seed=0)
    rng = np.random.default_rng(4)
    calib = [rng.standard_normal(model.input_shape).astype(np.float32)
             for _ in range(2)]
    qmodel = Session(split_model(model, np.ones(2)), calibration=calib,
                     device="cpu").qmodel
    xs = rng.standard_normal((4, *model.input_shape)).astype(np.float32)
    cluster = ElasticCluster(
        model, [WorkerParams() for _ in range(ELASTIC_WORKERS)],
        objective=Objective(modes=("spatial",)), heartbeat_timeout=1e9)

    async def drive():
        async with ElasticCoordinator(cluster, qmodel, spawn="inprocess",
                                      device=dev) as ec:
            before = [await ec.infer(x) for x in xs[:2]]
            split0, victim = ec.split, ec.physical_ids[0]
            t0 = time.perf_counter()
            pending = asyncio.ensure_future(ec.infer(xs[2]))
            await asyncio.sleep(0)
            await ec.inject_failure(0)
            after = [await pending]
            recovery_s = time.perf_counter() - t0
            after.append(await ec.infer(xs[3]))
            gone = victim not in cluster.plan_worker_ids
            report = ec.reports[-1] if ec.reports else None
            split1 = ec.split
        leaked = [t for t in asyncio.all_tasks()
                  if t is not asyncio.current_task() and not t.done()]
        return before, after, split0, split1, report, recovery_s, gone, \
            len(leaked)

    before, after, split0, split1, report, recovery_s, gone, leaked = \
        asyncio.run(asyncio.wait_for(drive(), DIST_TIMEOUT_S))
    if report is None or not gone:
        raise AssertionError("elastic: the kill did not replan")
    for tag, split, ys, x in (("before", split0, before, xs[:2]),
                              ("after", split1, after, xs[2:])):
        want = Session(split, qmodel=qmodel, device=dev,
                       max_batch=4).submit_many(x)
        if not np.array_equal(np.stack(ys), want):
            raise AssertionError(f"elastic {tag} the kill: != Session")
    if not (report["reshipped_bytes"] < report["full_setup_bytes"]
            and report["hit_rate"] == 1.0 and not leaked):
        raise AssertionError(f"elastic: report {report}, leaked {leaked}")
    rec = dict(model="mobilenet_v2_smoke", spawn="inprocess",
               workers_before=split0.n_workers,
               workers_after=split1.n_workers,
               reshipped_bytes=report["reshipped_bytes"],
               full_setup_bytes=report["full_setup_bytes"],
               warm_hit_rate=report["hit_rate"],
               cache_hits=report["cache_hits"],
               expected_cache_hits=report["expected_cache_hits"],
               replan_downtime_s=report["downtime_s"],
               recovery_s=recovery_s, bitexact=True, leaked_tasks=leaked)
    print(f"elastic {json.dumps(rec)}")
    return rec, dist_launches(split0, qmodel) + dist_launches(split1, qmodel)


# -- LM phases: qwen3-14b prefill -> greedy decode ----------------------------

LM_ARCH = "qwen3-14b"
LM_BATCH, LM_PROMPT, LM_TOKENS = 8, 2048, 32
LM_PROFILED_STEPS = 2              # the last decode steps, under the profiler
# prefill + decode against the full forward: tests/test_models.py:65
LM_RTOL, LM_ATOL = 2e-3, 2e-4
# flash-decode kernel against its plain version: 1e-5 in float32, as
# tests/test_kernels.py:118; with a bf16 operand, rtol 2e-2 and an atol of
# 2e-2 x the plain output's largest magnitude (a few bf16 steps there).  The
# outputs average v over thousands of slots and are ~0.01, so a fixed 3e-2
# (tests/test_kernels.py:130) would pass half the right answer.
DECODE_F32_TOL = 1e-5
DECODE_BF16_REL = 2e-2
DECODE_PEAK = 8.0
# one layer's cache at decode_32k's context (B, S, K, G, hd), bf16, ragged
YARDSTICK = (8, 32768, 8, 5, 128)
PEAK_BF16_OPS_S = 989e12
PEAK_F32_OPS_S = 67e12


def lm_check_fp32(dev) -> dict:
    """Phase (a): qwen3-14b at full width, 2 layers, float32 with TF32 off.
    Prefill and each of 4 greedy decode steps must give the full (train
    mode) forward's last-position logits within LM_RTOL/LM_ATOL, and the
    same greedy token."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.executor import _full_fp32
    from repro_torch.models import lm
    from repro_torch.train.serve import make_decode_step, make_prefill_step
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=2,
                              dtype="float32")
    b, s, n = 2, 16, 4
    max_seq = s + n + 1
    errs, tokens = [], []
    with _full_fp32():
        params = lm.init_model(cfg, 0, device=dev)
        rng = np.random.default_rng(1)
        seq = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).to(
            dev)
        cache = lm.init_cache(cfg, b, max_seq, device=dev)
        logits, cache = make_prefill_step(cfg, b, max_seq, device=dev)(
            params, cache, seq)
        decode = make_decode_step(cfg, b, max_seq, device=dev)
        for i in range(n + 1):
            full = lm.forward(params, {"tokens": seq}, cfg, mode="train")
            ref = full[:, -1]
            errs.append(float((logits - ref).abs().max()))
            if not torch.allclose(logits, ref, rtol=LM_RTOL, atol=LM_ATOL):
                raise AssertionError(f"fp32 step {i}: cache path differs "
                                     f"from the full forward by {errs[-1]}")
            tok = torch.argmax(logits, -1)[:, None]
            if not torch.equal(tok[:, 0], torch.argmax(ref, -1)):
                raise AssertionError(f"fp32 step {i}: greedy tokens differ")
            if i == n:
                break
            tokens.append(tok[:, 0].tolist())
            seq = torch.cat([seq, tok], dim=1)
            logits, cache = decode(params, cache, tok)
    del params, cache
    torch.cuda.empty_cache()
    rec = dict(phase="a", arch=cfg.name, n_layers=cfg.n_layers,
               dtype="float32", batch=b, prompt=s, decode_steps=n,
               max_abs_err=max(errs), rtol=LM_RTOL, atol=LM_ATOL,
               greedy_tokens=tokens)
    print(f"lm {json.dumps(rec)}")
    return rec


def _decode_step_bytes(cfg, params_bytes: int, embed_bytes: int,
                       batch: int, length: int) -> int:
    """Bytes one decode step must move: every weight but the embedding
    table read once (the embedding only for the batch's rows), and each
    layer's K and V read up to ``length`` and one slot of each written."""
    kv = 2 * cfg.n_kv_heads * cfg.resolved_head_dim * 2       # bf16 K + V
    per_row = embed_bytes // cfg.padded_vocab
    return (params_bytes - embed_bytes + batch * per_row
            + cfg.n_layers * batch * (length + 1) * kv)


def lm_serve(dev) -> tuple[dict, dict]:
    """Phase (b): qwen3-14b at full width and depth in bf16 (random weights,
    seed 0) serves LM_BATCH prompts of LM_PROMPT tokens: one prefill, then
    LM_TOKENS greedy decode steps through the serve steps, the last
    LM_PROFILED_STEPS of them under the profiler.  Returns the record and
    layer 0's live cache for phase (c)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.nn.layers import leaves
    from repro_torch.train.serve import make_decode_step, make_prefill_step
    cfg = get_config(LM_ARCH)
    b, s, n = LM_BATCH, LM_PROMPT, LM_TOKENS
    max_seq = s + n + 1
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_model(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params))
    params_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    embed_bytes = params["embed"].numel() * params["embed"].element_size()
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))).to(
        dev)
    cache = lm.init_cache(cfg, b, max_seq, device=dev)
    prefill = make_prefill_step(cfg, b, max_seq, device=dev)
    decode = make_decode_step(cfg, b, max_seq, device=dev)
    prefill(params, cache, prompts)        # warm-up; refilled below
    torch.cuda.synchronize()

    wrappers = counters()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    logits, cache = prefill(params, cache, prompts)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    gen, lengths = [torch.argmax(logits, -1)[:, None]], []

    def step():
        lengths.append(min(cache["pos"] + 1, max_seq))
        out, _ = decode(params, cache, gen[-1])
        gen.append(torch.argmax(out, -1)[:, None])
        return out

    timed = n - LM_PROFILED_STEPS
    t0 = time.perf_counter()
    # a decode step must never make the host wait on the card
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(timed):
            step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    events, wall_us, logits = trace_calls(step, LM_PROFILED_STEPS)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    expect = {name: 0 for name in wrappers}
    expect["decode_attn"] = n * cfg.n_layers
    if launches != expect:
        raise AssertionError(f"LM path launched {launches}, expected "
                             f"{expect}")
    if not bool(torch.isfinite(logits).all()) or logits.shape != (
            b, cfg.padded_vocab):
        raise AssertionError(f"LM logits {tuple(logits.shape)} not finite")
    tokens = torch.cat(gen, dim=1).cpu()
    if tokens.shape != (b, n + 1):
        raise AssertionError(f"generated {tuple(tokens.shape)}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    by_name: dict[str, float] = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us
    busy_us = sum(by_name.values())
    # every kernel of the wrapper's launches: split and merge
    attn_us = [us for name, us in events if "decode_attn_" in name]
    kpl = wrappers["decode_attn"].kernels_per_launch
    n_attn = LM_PROFILED_STEPS * cfg.n_layers * kpl
    # the trace may drop a kernel event (see kernel_device_ms; one run saw
    # 158 of 160): at most one a traced step, the time averaged over those
    # it saw.  The launches themselves are counted exactly above.
    if not n_attn - LM_PROFILED_STEPS <= len(attn_us) <= n_attn:
        raise AssertionError(f"profiled {len(attn_us)} decode_attn kernels "
                             f"for {LM_PROFILED_STEPS * cfg.n_layers} "
                             f"launches")
    step_ms = decode_s * 1e3 / timed
    bound = [_decode_step_bytes(cfg, params_bytes, embed_bytes, b, ln)
             / PEAK_BYTES_S * 1e3 for ln in lengths[:timed]]
    nonembed = n_params - params["embed"].numel()
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    prefill_ops = (2.0 * nonembed * b * s
                   + 4.0 * b * h * hd * s * (s + 1) / 2 * cfg.n_layers)
    rec = dict(
        phase="b", arch=cfg.name, n_layers=cfg.n_layers, dtype=cfg.dtype,
        params=n_params, params_gb=params_bytes / 1e9,
        cache_gb=sum(t.numel() * t.element_size()
                     for t in leaves(cache["stacks"])) / 1e9,
        init_s=init_s, batch=b, prompt=s, decode_steps=n, max_seq=max_seq,
        prefill_ms=prefill_ms,
        prefill_bound_ms=prefill_ops / PEAK_BF16_OPS_S * 1e3,
        decode_ms_per_step=step_ms, decode_steps_timed=timed,
        tokens_per_s=b / step_ms * 1e3,
        decode_bound_ms_per_step=statistics.mean(bound),
        decode_bound_by="bytes",
        profiled_steps=LM_PROFILED_STEPS,
        profiled_wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
        device_busy_share=busy_us / wall_us,
        device_idle_share=1 - busy_us / wall_us,
        device_events=len(events),
        decode_attn_in_path_ms=sum(attn_us) / len(attn_us) * kpl / 1e3,
        decode_attn_events_dropped=n_attn - len(attn_us),
        top=[dict(name=k[:80], ms=v / 1e3) for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:8]],
        launches=launches, peak_memory_gb=peak_gb,
        first_tokens=tokens[0, :8].tolist(), logits_finite=True)
    print(f"lm {json.dumps(rec)}")
    blk = cache["stacks"][0]["0_attn"]
    live = dict(k=blk["k"][0].clone(), v=blk["v"][0].clone(),
                item=blk["k"].element_size(), pos=cache["pos"],
                lengths=lengths, cfg=cfg)
    return rec, live


def kernel_device_ms(fn, prefix: str, per_call: int,
                     n: int = 6) -> float | None:
    """Device ms of one call of ``fn``, which enqueues ``per_call`` kernels
    whose names start with ``prefix``: their sum over ``n`` calls traced by
    the profiler, over n, in a trace padded by ``pad_trace``.  A trace
    has dropped a kernel (one of five was missing in a run of this
    script), so it needs all but one of them, and then averages over the
    kernels it saw.  A trace with fewer (one run's held none at all) is
    taken again, up to TRACE_TRIES times; then the call has no device time
    (None), and its caller uses the CUDA-event time."""
    fn()
    for _ in range(TRACE_TRIES):
        events = [us for name, us in trace_calls(fn, n, pad=True)[0]
                  if prefix in name]
        if len(events) >= n * per_call - 1:
            return sum(events) / len(events) * per_call / 1e3
        print(f"device trace: {len(events)} {prefix} kernels of "
              f"{n * per_call}")
    return None


def _decode_bound(lens, k_, g, hd, item_q, item_kv) -> tuple[float, str]:
    """Least time of one flash-decode: K and V read up to each length, q
    read and the output written once; 4 * G * hd operations per slot."""
    slots = float(sum(lens)) * k_
    n_bytes = (2 * slots * hd * item_kv + 2 * len(lens) * k_ * g * hd
               * item_q + 4 * len(lens))
    peak = PEAK_BF16_OPS_S if item_kv == 2 else PEAK_F32_OPS_S
    return bound_ms(n_bytes, 4.0 * slots * g * hd, peak)


def decode_attn_case(name, q, ck, cv, lens, on_path) -> dict:
    """Hold flash-decode against its plain version at one shape (model
    layout, cache (B, S, K, hd)); time the kernel (profiler and CUDA
    events), the plain version and the library yardstick
    ``F.scaled_dot_product_attention(enable_gqa=True)`` on operands laid out
    for it before timing (the port never calls it)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import backend
    from repro_torch.kernels.decode_attn.decode_attn import (decode_attn,
                                                             decode_schedule)
    from repro_torch.kernels.decode_attn.ops import (flash_decode,
                                                     flash_decode_ref)
    b, _, k_, g, hd = q.shape
    s = ck.shape[1]
    got = flash_decode(q, ck, cv, lens)
    exp = flash_decode_ref(q, ck, cv, lens)
    torch.cuda.synchronize()
    err = float((got.float() - exp.float()).abs().max())
    plain_max = float(exp.float().abs().max())
    if q.dtype == ck.dtype == torch.float32:
        rtol = atol = DECODE_F32_TOL
    else:
        rtol, atol = DECODE_BF16_REL, DECODE_BF16_REL * plain_max
    if got.dtype != q.dtype or not torch.allclose(
            got.float(), exp.float(), rtol=rtol, atol=atol):
        raise AssertionError(f"decode_attn {name}: max err {err} > "
                             f"atol {atol} + rtol {rtol} x |plain|")
    peaked = {}
    if ck.dtype == torch.bfloat16:
        # q x DECODE_PEAK: peaked logits, so each output is near one slot's
        # v (O(1)) rather than an average of thousands
        qp = (q.float() * DECODE_PEAK).to(q.dtype)
        gp, ep = (f(qp, ck, cv, lens).float()
                  for f in (flash_decode, flash_decode_ref))
        peaked = dict(peaked_max_abs_err=float((gp - ep).abs().max()),
                      peaked_plain_max_abs=float(ep.abs().max()))
        if not torch.allclose(gp, ep, rtol=rtol, atol=DECODE_BF16_REL
                              * peaked["peaked_plain_max_abs"]):
            raise AssertionError(f"decode_attn {name}, peaked q: {peaked}")
    # the yardstick's operands: (B, H, 1, hd) and (B, K, S, hd), and the
    # lengths as a boolean mask
    qh = q[:, 0].reshape(b, k_ * g, 1, hd).to(ck.dtype)
    kh = ck.transpose(1, 2).contiguous()
    vh = cv.transpose(1, 2).contiguous()
    mask = (torch.arange(s, device=q.device)[None, :]
            < lens[:, None])[:, None, None, :]
    lib = F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask,
                                         enable_gqa=True)
    lib_err = float((lib.reshape(got.shape).float() - exp.float()).abs()
                    .max())
    lens_host = lens.tolist()
    rec = dict(kernel="decode_attn", shape=name, on_path=on_path,
               B=b, S=s, K=k_, G=g, hd=hd, q_dtype=str(q.dtype),
               cache_dtype=str(ck.dtype),
               lengths=[min(lens_host), max(lens_host)], max_abs_err=err,
               plain_max_abs=plain_max, rtol=rtol, atol=atol,
               device_ms=kernel_device_ms(
                   lambda: flash_decode(q, ck, cv, lens), "decode_attn_",
                   decode_attn.kernels_per_launch),
               event_ms=time_ms(lambda: flash_decode(q, ck, cv, lens), 20),
               plain_ms=time_ms(lambda: flash_decode_ref(q, ck, cv, lens), 5,
                                warmup=1),
               library="F.scaled_dot_product_attention(enable_gqa=True)",
               library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                   qh, kh, vh, attn_mask=mask, enable_gqa=True), 20),
               library_max_abs_err=lib_err, **peaked)
    n_split, chunk = decode_schedule(s, b * k_, backend.sm_count(q.device))
    rec["schedule"] = dict(n_split=n_split, chunk=chunk, grid=[b * k_, n_split],
                           merge_grid=[b * k_])
    rec["bound_ms"], rec["bound_by"] = _decode_bound(
        lens_host, k_, g, hd, q.element_size(), ck.element_size())
    rec["roofline_share"] = rec["bound_ms"] / (rec["device_ms"] or
                                               rec["event_ms"])
    print(f"kernel {json.dumps(rec)}")
    return rec


def lm_kernel_phase(live, dev) -> list[dict]:
    """Phase (c): flash-decode on layer 0's live cache (bf16 q as the decode
    path launches it, and f32 q as the example's check) and on the
    off-path yardstick shape."""
    import numpy as np
    import torch
    cfg = live["cfg"]
    b, k_, g, hd = (LM_BATCH, cfg.n_kv_heads, cfg.q_groups,
                    cfg.resolved_head_dim)
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.standard_normal((b, 1, k_, g, hd)).astype(
        np.float32)).to(dev)
    lens = torch.full((b,), live["pos"], dtype=torch.int32, device=dev)
    recs = [decode_attn_case("live cache, layer 0", q.to(live["k"].dtype),
                             live["k"], live["v"], lens, True),
            decode_attn_case("live cache, layer 0, f32 q (example check)", q,
                             live["k"], live["v"], lens, False)]
    del live["k"], live["v"]
    yb, ys, yk, yg, yhd = YARDSTICK
    gen = torch.Generator(device=dev).manual_seed(3)
    ck, cv = (torch.randn((yb, ys, yk, yhd), generator=gen, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
    yq = torch.randn((yb, 1, yk, yg, yhd), generator=gen, device=dev,
                     dtype=torch.bfloat16)
    ylens = torch.from_numpy(rng.integers(ys // 2, ys + 1, yb).astype(
        np.int32)).to(dev)
    recs.append(decode_attn_case("decode_32k yardstick (not on the path)",
                                 yq, ck, cv, ylens, False))
    del ck, cv, yq
    torch.cuda.empty_cache()
    return recs


def decode_attn_line(serve, live, recs) -> dict:
    """The ``kernels`` entry of decode_attn: launches from the served run's
    counter; each time the per-launch time at the live shape times the
    launches; the bound summed over the run's launches at their own
    lengths."""
    path = recs[0]
    n = serve["launches"]["decode_attn"]
    cfg = live["cfg"]
    item = live["item"]
    bound = sum(_decode_bound([ln] * LM_BATCH, cfg.n_kv_heads,
                              cfg.q_groups, cfg.resolved_head_dim, item,
                              item)[0]
                for ln in live["lengths"]) * cfg.n_layers
    ms_from = "profiler" if path["device_ms"] is not None else "events"
    return dict(
        name="decode_attn", route="cuda",
        source="src/repro_torch/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_attn/decode_attn.py:63",
        launches=n, max_abs_err=max(r["max_abs_err"] for r in recs),
        ms=n * (path["device_ms"] or path["event_ms"]),
        plain_ms=n * path["plain_ms"], bound_ms=bound, bound_by="bytes",
        library_ms=n * path["library_ms"], ms_from=ms_from,
        in_path_ms=n * serve["decode_attn_in_path_ms"],
        launches_by_path={"lm_decode": n})


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
    rng = np.random.default_rng(0)
    calib = [rng.standard_normal(model.input_shape).astype(np.float32)
             for _ in range(2)]
    qmodel = Session(split_model(model, RATINGS, mode="spatial"),
                     calibration=calib, device="cpu").qmodel
    xs = rng.standard_normal((BATCH, *model.input_shape)).astype(np.float32)
    modes = ("spatial", "kernel", "neuron")
    engines = {mode: CompiledSplitExecutor(split_model(model, RATINGS,
                                                       mode=mode), device=dev)
               for mode in modes}
    runs = {mode: path_launches(eng, BATCH) for mode, eng in engines.items()}
    del engines
    names = ("qgemm", "dwconv3x3_bands", "dwconv3x3")
    paths = []
    for mode in modes:
        expect = {k: sum(1 for kk, _, _ in runs[mode] if kk == k)
                  for k in names}
        expect["decode_attn"] = 0
        paths.append(serve_path(mode, model, qmodel, xs, dev, expect))
    float_path(model, xs, dev)

    # the planner stack and the distributed runtime: the committed plan,
    # served by worker processes on the card, the kernel-mode split by
    # in-process workers, and an elastic run through a killed worker
    plan, psess = planner_phase(model, qmodel, xs, dev)
    dists, dist_runs = distributed_phase(model, qmodel, xs, plan, psess, dev)
    del psess
    elastic, elastic_launches = elastic_phase(dev)
    runs.update(dist_runs, elastic=elastic_launches)
    paths.append(dict(mode="dist_kernel_inprocess",
                      launches=dists[1]["launches"]))

    recs = kernel_phase(runs, dev)
    # printed: the spatial plan's named layers, the flat plans' b1_dw
    # shards and the off-path yardsticks; every shape is in the JSON file
    named = {"stem", "b1_expand", "b16_project", "head_conv", "classifier",
             "b1_dw", "b14_dw"}
    engine_recs = [r for r in recs if "engine" in r["path"]]
    for r in recs:
        if not r["on_path"] or named & set(r["layers"]) and (
                "spatial" in r["per_run"] or "b1_dw" in r["layers"]) and (
                "engine" in r["path"]):
            print(f"kernel {json.dumps(r)}")
    # each engine shape's schedule beside its device ms, one short line
    # each: qgemm M x K x N, tile height t, splits s; depthwise windows x C
    # x H x W x stride (unpadded), channels c and output rows r of a CTA,
    # shards z of the launch; grid g
    for r in engine_recs:
        sch = r["schedule"]
        split = (f"t{sch['tile'][0]} s{sch['splits']}"
                 if r["kernel"] == "qgemm" else
                 f"c{sch['c_tile']} r{sch['rows_tile']} "
                 f"z{sch['shards']}")
        print(f"sched {r['kernel'][:6]} "
              f"{'x'.join(map(str, r['shape'][:5]))} {split} "
              f"g{'x'.join(map(str, sch['grid']))} "
              f"{launch_ms(r):.5f}ms")
    # the workers' shapes, summed per run: every one was bit-exact above
    for run in DIST_RUNS:
        for name in ("qgemm", "dwconv3x3"):
            tot = per_run(recs, name, run)
            print("dist_shapes " + json.dumps(dict(run=run, kernel=name,
                                                   **tot)))
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_shapes.json").write_text(json.dumps(
        dict(card=card, batch=BATCH, requests=len(xs), shapes=recs,
             distributed=dists, elastic=elastic), indent=1))

    # the LM serving path: (a) fp32 check, (b) bf16 run at full depth,
    # (c) the flash-decode kernel on the live cache and a yardstick shape
    torch.cuda.empty_cache()
    lm_check_fp32(dev)
    serve, live = lm_serve(dev)
    torch.cuda.empty_cache()
    attn_recs = lm_kernel_phase(live, dev)
    (out_dir / "chip_smoke_lm.json").write_text(json.dumps(
        dict(card=card, serve=serve, decode_attn=attn_recs), indent=1))

    source = {"qgemm": "src/repro_torch/csrc/qgemm.cu",
              "dwconv3x3_bands": "src/repro_torch/csrc/dwconv.cu",
              "dwconv3x3": "src/repro_torch/csrc/dwconv.cu"}
    replaces = {"qgemm": "src/repro/kernels/qgemm/qgemm.py:63",
                "dwconv3x3_bands": "src/repro/kernels/dwconv/dwconv.py:133",
                "dwconv3x3": "src/repro/kernels/dwconv/dwconv.py:96"}
    # each kernel's numbers cover the launches of every counted run (the
    # three engine plans, the in-process distributed run): launches from
    # the counters, each time the sum over those launches of its
    # per-launch time at the launch's own shape
    counted = [p["mode"] for p in paths]
    line = []
    for name in names:
        fwd = {run: per_run(recs, name, run) for run in counted}
        for p in paths:
            if fwd[p["mode"]]["launches"] != p["launches"][name]:
                raise AssertionError(f"{name}: {p['mode']} counts differ")
            print("forward " + json.dumps(dict(kernel=name, mode=p["mode"],
                                               **fwd[p["mode"]])))
        rows = [r for r in recs if r["kernel"] == name and r["on_path"]]
        by_bytes = sum(r["bound_ms"] * sum(r["per_run"].get(run, 0)
                                           for run in counted)
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
    line.append(decode_attn_line(serve, live, attn_recs))
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
