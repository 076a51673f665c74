#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` with nvcc, then:

1. prints the card's name and power limit (``nvidia-smi``);
2. lists every kernel launch that one forward of each main-path plan makes,
   from a recorded walk of the engine (``tests/torch_launches.py``: the
   engine's calls of its kernel wrappers, each keyed by its own arguments
   in ``engine_launches``), holds each kernel against its plain torch
   version on the card at every distinct shape of those launches, in the
   form the engine calls it (int8 output bit-exact, float32 output within
   the tolerance below), and times kernel (profiler device time, summed
   over every kernel a wrapper enqueues for one launch, and CUDA events),
   plain version and a library call there; prints each shape's schedule
   (tile, splits, grid) beside its time; all shapes go to
   ``chiprun_out/chip_smoke_shapes.json``.  This step runs after step 7,
   over the engine's, the workers' and the server's launches together
   (``path``: ``engine``, ``distributed``, ``serving``);
3. serves int8 MobileNetV2 at the paper's full width (112x112x3, 1000
   classes, 54 layers) split spatially across 8 workers of unequal ratings
   through ``Session.submit_many`` on the card, and requires the output to
   equal a CPU session of the port bit for bit, the engine's kernels in a
   profiler trace of that run to number the launches of the recorded walk
   (the forward is a CUDA graph captured in the warm-up and replayed, and
   a replay calls no wrapper: the wrappers' launch counters must stay at
   0), every dispatch after the warm-up to replay (``graphs``:
   ``graph_stats()``), and no weight to be copied into the kernel's layout
   (``qgemm.weight_copies`` 0);
4. does the same with a kernel-mode and a neuron-mode plan (the flat
   depthwise and im2col paths), then serves EfficientNet-B0 at 224x224
   (``effnet_phase``) through its spatial, kernel and neuron plans at
   batch EFF_BATCH, each equal bit for bit to the unsplit int8 walk on the
   card (its swish and sigmoid take the card's expf, which the CPU's exp
   may miss by a code), each trace showing the ``se_pool``, ``se_gate``,
   ``dwconv5x5`` and other kernels its walk launched; their launch shapes
   join step 2, where the swish and sigmoid epilogues are held too (int8
   within one code on EXP_CODE_SHARE of the codes);
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
7. the serving slice (``serving`` line), with every launch counter at 0
   after the warm-up:
   one ``repro_torch.serve.Server(max_inflight=2)`` hosts two int8
   tenants at full width, A = ``mobilenet_v2_paper`` on the spatial split
   of the 8 ratings above and B = ``mobilenet_v2`` at 96x96 on a
   neuron-mode split over 4 MCUs rated (3, 1, 2, 0.5) with an SLO of p99
   <= 250 ms, each with the constants of one seed-0 calibration on the
   card; 32 requests a tenant through ``Server.submit`` must equal
   ``Session.run`` byte for byte, under a profiler trace whose engine
   kernels must number the launches that a recorded walk of each tenant's
   engine lists at each bucket, for the dispatches made; then each
   tenant's saturation throughput, 3 s of open-loop Poisson load at 0.4x
   of it (no failed ticket), and 3 s of tenant B at 2x (it must shed,
   every rejection a typed ``Overloaded`` counted by reason, the accepted
   p99 <= 1 s); every dispatch must have replayed a graph (the counters
   still at 0), and the traced part must have run ``qgemm`` and
   ``dwconv3x3_bands`` (A) and ``dwconv3x3`` (B); last, each tenant's
   dispatch p50 at bucket 8 at saturation under ``max_inflight`` 1 and 2.
   A ``dw_many_shards`` line follows: a neuron-mode split of
   ``mobilenet_v2_smoke`` over 72 workers, whose 5 depthwise layers (72
   shards each) take two launches each (the kernels of a profiler trace of
   the batch), every layer's call equal to the plain version and the batch
   equal to the CPU's;
8. the LM serving path, ``qwen3-14b`` at its published width:
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
9. the other LM families (``lm_family`` lines), one model at a time, each
   freed before the next:
   (a) in float32 at full width with TF32 off, at a depth that holds every
       block kind of the family (``FAMILY_CHECKS``: 2 layers of each MoE
       config at capacity factor 8, the hybrid's rec, rec, attn with a
       2052-token prompt over its 2048-slot ring, 7 mLSTM + 1 sLSTM,
       whisper's full 6 + 6 over 1500 frames, 2 vlm layers over 576
       patches): prefill and 4 greedy decode steps through the serve steps
       must give the full forward's logits at each position (rtol 2e-3,
       atol 2e-4) and its greedy tokens;
   (b) in bf16 at full width, 8 prompts (``FAMILY_SERVES``):
       ``deepseek-moe-16b`` at full depth with 2048-token prompts and 32
       decode steps, the others 8 steps: ``dbrx-132b`` cut to 4 of its 40
       layers (its bf16 weights do not fit in 80 GB), ``recurrentgemma-9b``
       and ``xlstm-1.3b`` at 2048 tokens, ``whisper-base`` with 1500
       frames and 448 decoder tokens, ``llava-next-mistral-7b`` with 576
       patches and 1472 tokens; as in 8 (b), no decode step may make a
       synchronising call, and ``decode_attn`` must launch once for each
       attention against a cache in each step (two per whisper decoder
       layer, none for xlstm) and no other kernel at all; prints prefill
       ms, decode ms per step beside its byte bound, the card's busy and
       idle share over the last 2 steps and the peak memory;
   (c) holds flash-decode against its plain version on each family's
       live layer-0 caches (whisper's self and cross), timed as in 8 (c);
   the family records join ``chiprun_out/chip_smoke_lm.json``;
10. the training path (``train`` lines; ``chiprun_out/chip_smoke_train.json``),
   which launches none of the repository's kernels (every counter stays 0):
   (a) float32 with TF32 off: on each of the seven ``-smoke`` configs the
       card's gradients and one donated train step equal the CPU's (loss,
       grad norm, every gradient within 1e-5; updated params within 1e-5
       where |g| > 1e-4, else 2 x lr), and at full width (``qwen3-14b``, 2
       of 40 layers, 2 x 256 tokens, 128-row attention chunks under
       autograd) the gradients with remat "full", "dots" and 2
       microbatches equal those without remat within 1e-5 of each leaf's
       largest;
   (b) bf16 training at full width: ``qwen3-14b`` cut to 6 of 40 layers
       (3.54 B parameters, 12 bytes of training state each), remat
       "full", 1024-row attention chunks, batch 2 x 2048 tokens, 10 steps
       of ``train_loop`` (every loss and grad norm finite), then 2 steps
       under the profiler; prints ms a step after 2 warm-up steps,
       tokens/s, the step's bound (bf16 matmuls, float32 attention,
       AdamW's bytes) and its share, the card's busy and idle share, the
       top 10 device ops and the peak memory (< 72 GB);
   (c) the example's model (``examples/torch/train_small_lm.py``): 40
       steps at 16 x 32 and lr 3e-3 lower the loss by more than 0.1; a run
       killed at 6 (checkpoint at 3) and resumed to 10 ends within rtol
       1e-4 of an uninterrupted one; a bf16 copy of its state round-trips
       a checkpoint bit for bit;
11. the mesh on ``torch.distributed`` (``mesh_*`` lines;
   ``chiprun_out/chip_smoke_mesh.json``): an in-process NCCL group of one
   rank and a (1,1,1) ("pod", "data", "model") mesh, DTensor params and
   caches placed by the rules:
   (a) float32 with TF32 off, ``qwen3-14b`` and ``deepseek-moe-16b`` cut to
       2 layers: 3 mesh train steps at (a)'s shape of step 10, then
       prefill + 4 decode steps, against the single-device steps on the
       card (losses rtol 1e-6, params and logits within 1e-6 of the
       largest magnitude), each record's ``splits`` the calls of the model
       axis's split paths (``split_calls``), nonzero where due;
   (b) step 10 (b)'s bf16 training through ``train_loop(mesh=)``: ms a
       step, tokens/s and peak memory beside step 10 (b)'s;
   (c) step 8 (b)'s full-depth bf16 serve through the mesh's prefill and
       decode steps, every decode attention the kernel's log-sum-exp output
       on the seq-sharded cache and the merge over the model group
       (``decode_attn`` once a layer a step, no other kernel); prefill and
       decode ms beside step 8 (b)'s; the log-sum-exp output held against
       its plain version on the live cache and timed (its launches join
       ``decode_attn``'s kernel line as ``mesh_decode``).
   ``mesh_multi_card(world)`` (not called here) runs (a) and
   qwen3-14b's bf16 training on a (world // 2, 2) mesh of one NCCL rank a
   card;
12. prints a JSON line of every kernel: its launches in the counted runs
   (the three engine plans of each network and the in-process distributed
   run; for
   ``decode_attn`` the dense LM run, each family's and the mesh serve's),
   its largest error against its plain version, and the sums over those
   launches of its time, its bound, and the plain and library times at
   each launch's shape; a CNN kernel also carries its launches in the
   serving run's traced part (``serving_launches``).  An engine plan's
   launches by wrapper are those of its recorded walk, held against the
   trace's kernels by name (ENGINE_KERNELS);
13. prints ``{"ok": true, "device": {...}}`` as the last line.

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
# EfficientNet-B0 at 224x224 is served at the benchmark cell's batch
EFF_BATCH = 32
# the band staging kernels' (csrc/bands.cu) residual epilogue's multiplier
# at their check: a ratio of two activation scales, rounded to float32
BAND_RATIO = 0.7311
# swish and sigmoid epilogues against their plain versions on the card:
# int8 within one code on at most this share of the codes (one code at the
# least), the kernel's expf against torch's exp; float32 as the clamps
EXP_ACTS = ("swish", "sigmoid")
EXP_CODE_SHARE = 1e-4
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


# the engine's kernels by their names on the card, each with the wrappers
# that launch it (a depthwise kernel's band and flat forms launch one)
ENGINE_KERNELS = {"qgemm_kernel": ("qgemm",),
                  "dwconv3x3_kernel": ("dwconv3x3_bands", "dwconv3x3"),
                  "dwconv5x5_kernel": ("dwconv5x5_bands_unpadded",
                                       "dwconv5x5_shards"),
                  "se_pool_kernel": ("se_pool",),
                  "se_gate_kernel": ("se_gate",),
                  "band_windows_kernel": ("band_windows",),
                  "band_take_kernel": ("band_take",)}
# the CNN kernels' wrappers, each holding its launch counter
CNN_WRAPPERS = tuple(w for ws in ENGINE_KERNELS.values() for w in ws)


def traced_kernels(fn):
    """Run ``fn`` once under the profiler, between two ``pad_trace``
    calls, and count the engine's kernels on the card by name
    (ENGINE_KERNELS): a replayed CUDA graph calls no wrapper, so its
    launches show in a trace alone.  ``fn`` returns its result and the
    counts the run should show; a trace that shows others is made again,
    up to TRACE_TRIES runs in all (traces have dropped kernels).  Returns
    the last run's result, counts and wanted counts, and the runs made."""
    for tries in range(1, TRACE_TRIES + 1):
        events, _, (out, want) = trace_calls(fn, 1, pad=True)
        got = {name: sum(name in e for e, _ in events)
               for name in ENGINE_KERNELS}
        if got == want:
            break
    return out, got, want, tries


# -- phase 2: kernels against their plain versions ---------------------------

def bound_ms(n_bytes: float, n_ops: float,
             peak_ops: float = PEAK_INT8_OPS_S) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, n_ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _operands(kernel, shape, gen, dev, int_bias):
    """Random int8 operands of one launch, with a multiplier that keeps
    acc*scale near 1 so requantization spans the int8 range; returns the
    wrapper's positional operands and keyword options.  A pool's or a
    gate's operands are its stack (and gate codes) and a factor that
    spreads the sums or products over the int8 range (no float case)."""
    import torch
    if kernel.startswith("band_"):
        return _band_operands(kernel, shape, gen, dev)
    if kernel.startswith("se_"):
        nb, c, r, w, last = shape
        x = torch.randint(-127, 128, (nb, c, r, w), generator=gen,
                          device=dev, dtype=torch.int8)
        if kernel == "se_pool":
            return (x, last, 1.0 / (4.0 * max(1, r * w) ** 0.5)), {}
        g = torch.randint(0, 128, (last, c), generator=gen, device=dev,
                          dtype=torch.int8)
        return (x, g, 1.0 / 127), {}
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
        k = dw_taps(kernel)
        x = torch.randint(-127, 128, (nb, c, r, wp), generator=gen,
                          device=dev, dtype=torch.int8)
        w = torch.randint(-127, 128, (c, k, k), generator=gen, device=dev,
                          dtype=torch.int8)
        n_ch, fan_in = c, k * k
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


def _band_operands(kernel, shape, gen, dev):
    """A staging launch's operands: random int8 codes in the source's
    layout, a random row table (a tenth of its rows zeros; one band empty
    where there are several) or a random take of output rows, and the
    residual codes and ratio of a block that adds one."""
    import torch
    from repro_torch.core.quantize import f32
    bsz, bands, c, h, w, *rest = shape
    src = rest[-2] if kernel == "band_windows" else rest[1]
    x = torch.randint(-127, 128, (bsz if src == "input" else bsz * bands, c,
                                  h, w), generator=gen, device=dev,
                      dtype=torch.int8)
    if src == "nhwc":
        x = x.contiguous(memory_format=torch.channels_last)
    if kernel == "band_windows":
        r, pw, _, nhwc = rest
        table = torch.randint(0, h, (bands, r), generator=gen, device=dev,
                              dtype=torch.int32)
        table[torch.rand((bands, r), generator=gen, device=dev) < 0.1] = -1
        if bands > 1:
            table[-1] = -1
        return (x, table, bsz), {"pw": pw, "channels_last": nhwc}
    h_out, _, residual = rest
    rows = torch.randperm(bands * h, generator=gen, device=dev)[
        :h_out].sort().values.to(torch.int32)
    args = (x, rows, bsz)
    if residual:
        res = torch.randint(-127, 128, (bsz, c, h_out, w), generator=gen,
                            device=dev, dtype=torch.int8)
        args += (res, f32(BAND_RATIO))
    return args, {}


def counters():
    """Each kernel's wrapper, which also holds its launch count."""
    from repro_torch.kernels.decode_attn.decode_attn import decode_attn
    from repro_torch.kernels.dwconv.dwconv import (
        dwconv3x3, dwconv3x3_bands, dwconv5x5_bands_unpadded,
        dwconv5x5_shards)
    from repro_torch.kernels.bands import band_take, band_windows
    from repro_torch.kernels.qgemm.qgemm import qgemm
    from repro_torch.kernels.se import se_gate, se_pool
    return {"qgemm": qgemm, "dwconv3x3_bands": dwconv3x3_bands,
            "dwconv3x3": dwconv3x3,
            "dwconv5x5_bands_unpadded": dwconv5x5_bands_unpadded,
            "dwconv5x5_shards": dwconv5x5_shards, "se_pool": se_pool,
            "se_gate": se_gate, "band_windows": band_windows,
            "band_take": band_take, "decode_attn": decode_attn}


def dw_taps(kernel) -> int:
    """A depthwise wrapper's kernel size."""
    return 5 if kernel.startswith("dwconv5x5") else 3


def dw_pad(kernel, shape) -> tuple[int, int]:
    """Zero rows and columns the depthwise kernel reads around its input at
    a launch shape: a flat layer's SAME border, a band stack's width, none
    for the pre-padded whole-sample yardstick."""
    p = dw_taps(kernel) // 2
    if kernel in ("dwconv3x3_bands", "dwconv5x5_bands_unpadded"):
        return (0, p)
    return (p, p) if len(shape) == 6 else (0, 0)


def launch_fns(kernel, shape):
    """(kernel call, its plain version) of one launch shape, each taking
    (x, w, scale, bias, **options): the wrapper form the engine calls there
    (a flat layer's shard table built here) and the plain torch loop it
    replaces."""
    from repro_torch.kernels.dwconv import ops, ref
    from repro_torch.kernels.dwconv.dwconv import dwconv3x3
    from repro_torch.kernels.qgemm.qgemm import qgemm
    from repro_torch.kernels.qgemm.ref import qgemm_ref
    from repro_torch.kernels.se import se_gate, se_pool
    from repro_torch.kernels.se.ref import se_gate_ref, se_pool_ref
    if kernel.startswith("band_"):
        from repro_torch.kernels import bands
        from repro_torch.kernels.bands import ref as bref
        return getattr(bands, kernel), getattr(bref, kernel + "_ref")
    if kernel == "qgemm":
        return qgemm, qgemm_ref
    if kernel == "se_pool":
        return se_pool, se_pool_ref
    if kernel == "se_gate":
        return se_gate, se_gate_ref
    if kernel in ("dwconv3x3_bands", "dwconv5x5_bands_unpadded"):
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
    if kernel == "band_windows":
        # one gather of every window row (the source repeated over the
        # bands where it is the block's input), one where for the zero rows
        bsz, n_bands = args[2], w.shape[0]
        c, h, wd = x.shape[1], x.shape[2], x.shape[3]
        xv = (x.reshape(bsz, 1, c, h, wd).expand(bsz, n_bands, c, h, wd)
              if x.shape[0] == bsz else x.reshape(bsz, n_bands, c, h, wd))
        index = w.clamp(min=0).long()[None, :, None, :, None].expand(
            bsz, n_bands, c, w.shape[1], wd)
        mask = (w >= 0)[None, :, None, :, None]
        return "torch.gather+where", lambda: torch.where(
            mask, torch.gather(xv, 3, index), 0)
    if kernel == "band_take":
        # one advanced index of every output row's (band, row)
        bsz = args[2]
        r = x.shape[2]
        xv = x.reshape(bsz, x.shape[0] // bsz, *x.shape[1:])
        band, row = (w // r).long(), (w % r).long()
        return "torch index", lambda: xv[:, band, :, row, :]
    if kernel == "se_pool":
        return "torch.sum int32", lambda: x.sum(dim=(2, 3),
                                                dtype=torch.int32)
    if kernel == "se_gate":
        gv = w.repeat_interleave(x.shape[0] // w.shape[0], 0)[:, :, None,
                                                               None]
        return "torch.mul int8", lambda: torch.mul(x, gv)
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
    if kernel.startswith("band_"):
        # one CTA a tile of 64 positions of an output image x 64 channels
        bsz, bands, c, _, w, *rest = shape
        n_out, plane = ((bsz * bands, rest[0] * (w + 2 * rest[1]))
                        if kernel == "band_windows" else (bsz, rest[0] * w))
        return dict(c_tile=64, grid=[-(-plane // 64) * n_out, -(-c // 64)])
    if kernel == "se_pool":
        from repro_torch.kernels.se.se import pool_c_tile
        nb, c, _, _, rows = shape
        bsz = nb // len(rows)
        c_tile = pool_c_tile(bsz, c, n_sm)
        return dict(c_tile=c_tile, grid=[bsz * -(-c // c_tile)])
    if kernel == "se_gate":
        from repro_torch.kernels.se.se import GATE_CTAS_PER_SM, THREADS
        n = math.prod(shape[:4])
        return dict(grid=[min(-(-n // (16 * THREADS)),
                              GATE_CTAS_PER_SM * n_sm)])
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
                          n_sm, k=dw_taps(kernel))
    return dict(rows_tile=sch.rows_tile, c_tile=sch.c_tile, smem=sch.smem,
                shards=len(spans), grid=[nb, sch.tiles])


def _exp_codes(what, got, ref) -> float:
    """int8 codes of a swish or sigmoid epilogue within one code of the
    plain version on at most EXP_CODE_SHARE of them (one at the least);
    returns the largest difference."""
    d = (got.int() - ref.int()).abs()
    n_off, err = int((d > 0).sum()), float(d.max())
    if err > 1 or n_off > max(1, EXP_CODE_SHARE * d.numel()):
        raise AssertionError(f"{what}: {n_off} of {d.numel()} codes off, "
                             f"by up to {err}")
    return err


def check_launch(kernel, shape, gen, dev, exp_acts: bool = False
                 ) -> tuple[dict, tuple]:
    """Hold one kernel against its plain version at one launch shape, with
    the int32 bias and int8 output (bit-exact) and with the float bias and
    float32 output (within F32_RTOL/F32_ATOL); with ``exp_acts``, also with
    the swish and sigmoid epilogues (int8 within one code on EXP_CODE_SHARE
    of the codes, float32 as before).  A pool, a gate or a staging pass has
    the int8 case alone, bit-exact.  Times kernel, plain version and
    library call with CUDA events.  Returns the record and the int8 case's
    (kernels a launch enqueues, call, operands, options) for the
    device-time trace."""
    import torch
    fn, plain = launch_fns(kernel, shape)
    args, kw = _operands(kernel, shape, gen, dev, int_bias=True)
    got, ref = fn(*args, **kw), plain(*args, **kw)
    err = float((got.int() - ref.int()).abs().max())
    if not torch.equal(got, ref):
        raise AssertionError(f"{kernel} {shape}: differs from plain by {err}")
    ferr = 0.0
    if not kernel.startswith(("se_", "band_")):
        fargs, fkw = _operands(kernel, shape, gen, dev, int_bias=False)
        fcases = [fkw] + [dict(fkw, activation=a) for a in EXP_ACTS
                          if exp_acts]
        for case in fcases:
            fgot, fref = fn(*fargs, **case), plain(*fargs, **case)
            ferr = max(ferr, float((fgot - fref).abs().max()))
            if not torch.allclose(fgot, fref, rtol=F32_RTOL, atol=F32_ATOL):
                raise AssertionError(f"{kernel} {shape} f32 "
                                     f"{case['activation']}: max err {ferr}")
        for act in EXP_ACTS if exp_acts else ():
            case = dict(kw, activation=act,
                        out_scale=1.0 / 127 if act == "sigmoid" else 6 / 127)
            err = max(err, _exp_codes(f"{kernel} {shape} {act}",
                                      fn(*args, **case), plain(*args, **case)))
    if kernel == "qgemm":
        m, k, n = shape
        n_bytes, n_ops = m * k + k * n + 8 * n + m * n, 2.0 * m * n * k
    elif kernel == "se_pool":
        # the stack once (the fill rows below a band's own are read too),
        # one add a byte, the codes out
        n_bytes, n_ops = args[0].numel() + got.numel(), float(args[0].numel())
    elif kernel == "se_gate":
        # the stack and the gate codes once, a multiply and a requantizing
        # multiply an element, the stack out
        n = args[0].numel()
        n_bytes, n_ops = 2 * n + args[1].numel(), 2.0 * n
    elif kernel == "band_windows":
        # each window row of source bytes read once (a zero row reads
        # nothing), the table, every window byte out
        x, table, bsz = args
        n_read = int((table >= 0).sum()) * bsz * x.shape[1] * x.shape[3]
        n_bytes, n_ops = n_read + 4 * table.numel() + got.numel(), 0.0
    elif kernel == "band_take":
        # each output row read once, the rows, the output (and the
        # residual read, one multiply and one add an element)
        n = got.numel()
        n_bytes = 2 * n + 4 * args[1].numel() + (n if len(args) > 3 else 0)
        n_ops = 2.0 * n if len(args) > 3 else 0.0
    else:
        # the input as the kernel reads it (unpadded but for the padded
        # yardstick) once, taps, scale and bias, every output once
        c, taps = shape[1], dw_taps(kernel) ** 2
        n_out = got.numel()
        n_bytes = args[0].numel() + taps * c + 8 * c + n_out
        n_ops = 2.0 * taps * n_out
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
OUR_KERNELS = ("qgemm_", "dwconv3x3_", "dwconv5x5_", "se_pool_",
               "se_gate_", "band_windows_", "band_take_", "decode_attn_")


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


# a launch the main path does not make, kept beside the path's own shapes
# as a yardstick: b1_dw on one pre-padded sample through the reference's
# contract (``dwconv3x3``)
OFF_PATH = [("dwconv3x3", "b1_dw one sample, all channels",
             (1, 96, 58, 58, 2))]


def kernel_phase(runs: dict, dev) -> list[dict]:
    """Every distinct (kernel, shape) that the runs launch, plus
    ``OFF_PATH``: held against the plain version and timed.  ``runs`` maps
    each run to every launch it made, (kernel, layer, shape): one forward
    of an engine plan (its recorded walk: ``engine_launches``), or all
    requests of a distributed run (``dist_launches``).  Returns one record
    per distinct launch shape, with its layers, its launches in each run
    (``per_run``) and the paths that made it (``path``: ``engine``,
    ``distributed``, ``serving``, joined by ``+``, or ``none`` for
    ``OFF_PATH``)."""
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
        path = ("distributed" if run in DIST_RUNS else
                "serving" if run.startswith("serving") else "engine")
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
        # EfficientNet's launches also take swish and sigmoid epilogues
        rec, call = check_launch(kernel, shape, gen, dev, exp_acts=any(
            run.startswith("effnet") for run in r["per_run"]))
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

# the wrappers of a flat depthwise layer: a launch a part of its shard table
SHARD_WRAPPERS = ("dwconv3x3", "dwconv5x5_shards")


def kernel_launches(calls) -> dict:
    """The engine's kernels on the card (ENGINE_KERNELS) that the recorded
    ``calls`` launch: one a call, and one a launch of a flat depthwise
    layer's shard table (``ShardTable.launches``)."""
    got = dict.fromkeys(ENGINE_KERNELS, 0)
    for c in calls:
        kernel = next(k for k, ws in ENGINE_KERNELS.items() if c.name in ws)
        got[kernel] += (len(c.args[1].launches) if c.name in SHARD_WRAPPERS
                        else 1)
    return got


def serve_path(mode, model, qmodel, xs, dev, *, label=None, want_ys=None,
               need=None, ratings=RATINGS):
    """Drive one int8 plan, ``model``'s ``mode`` split of ``ratings``, on
    the card over the batch ``xs``; hold it against the port on the CPU,
    or against ``want_ys`` where given.  A recorded walk of the session's
    engine (``torch_launches.census``) lists the launches of one forward:
    with every launch counter at 0, the served run's trace must show
    exactly those kernels, and no wrapper may launch (the forward replays
    the graph that the warm-up captured); each wrapper of ``need`` must be
    among them.  Returns the record under ``label`` (the mode by default;
    the walk's launches by wrapper, the trace's kernels, the ms of a
    request served alone) and the walk's calls."""
    import torch
    from repro_torch.api import Session
    from repro_torch.core import split_model
    from torch_launches import census
    label = label or mode
    plan = split_model(model, ratings, mode=mode)
    sess = Session(plan, precision="int8", qmodel=qmodel, device=dev,
                   max_batch=len(xs))
    sess.warmup()
    calls = census(sess.engine, torch.from_numpy(xs).to(dev))
    expect = {name: sum(c.name == name for c in calls)
              for name in CNN_WRAPPERS}
    want = kernel_launches(calls)
    wrappers = counters()
    for fn in wrappers.values():
        fn.launches = 0
    wrappers["qgemm"].weight_copies = 0
    ys, kernels, _, tries = traced_kernels(
        lambda: (sess.submit_many(xs), want))
    walked = {name: fn.launches for name, fn in wrappers.items()
              if fn.launches}
    if walked:
        raise AssertionError(f"{label} path walked the plan: {walked}")
    if kernels != want:
        raise AssertionError(f"{label} path ran {kernels} kernels in each "
                             f"of {tries} traces, its walk launched {want}")
    for name in need or (("qgemm", "dwconv3x3") if mode != "spatial" else
                         ("qgemm", "dwconv3x3_bands", "band_windows",
                          "band_take")):
        if expect[name] <= 0:
            raise AssertionError(f"{label} path launched no {name}")
    against = "cpu" if want_ys is None else "card_reference"
    if want_ys is None:
        want_ys = Session(plan, precision="int8", qmodel=qmodel,
                          device="cpu", max_batch=len(xs)).submit_many(xs)
    if ys.shape != (len(xs), *model.out_shape) or ys.dtype.name != "int8":
        raise AssertionError(f"{label}: output {ys.shape} {ys.dtype}")
    if not (ys == want_ys).all():
        raise AssertionError(f"{label}: card output != {against} output in "
                             f"{int((ys != want_ys).sum())} places")
    if not ys.any():
        raise AssertionError(f"{label}: output is all zeros")
    one_ms = []
    for x in xs:
        t0 = time.perf_counter()
        sess.run(x)
        one_ms.append((time.perf_counter() - t0) * 1e3)
    if wrappers["qgemm"].weight_copies:
        raise AssertionError(f"{label} path copied "
                             f"{wrappers['qgemm'].weight_copies} weights")
    # the warm-up captured one graph a bucket; every dispatch since replayed
    graphs = sess.engine.graph_stats()
    if graphs != dict(captures=len(sess.buckets), eager=len(sess.buckets),
                      replays=len(sess.buckets) + tries + len(xs)):
        raise AssertionError(f"{label}: graphs {graphs}, buckets "
                             f"{sess.buckets}")
    rec = dict(mode=label, batch=len(xs), launches=expect,
               kernels_traced=kernels, traces=tries,
               **{f"bit_exact_vs_{against}": True}, weight_copies=0,
               graphs=graphs,
               ms_request_batch1=statistics.median(one_ms))
    print(f"path {json.dumps(rec)}")
    return rec, calls


def effnet_phase(dev) -> tuple[list[dict], dict]:
    """EfficientNet-B0 at 224x224 (16 squeeze-and-excitation blocks, 9 of
    them with 5x5 depthwise convs, seed-0 weights, calibrated on the CPU)
    through the spatial, kernel and neuron splits of RATINGS at batch
    EFF_BATCH (``serve_path``): each plan's answers equal the unsplit int8
    walk in plain torch on the card (``reference_forward(..., qmodel=)``)
    bit for bit, and a profiler trace of each plan's forward shows exactly
    the kernels its recorded walk launched, ``se_pool``, ``se_gate`` and
    the 5x5 kernel among them.  Returns the paths' records and their
    launches (runs ``effnet_<mode>``)."""
    import numpy as np
    from repro_torch.api import Session
    from repro_torch.core import split_model
    from repro_torch.core.executor import reference_forward
    from repro_torch.models import efficientnet_b0
    from torch_launches import engine_launches
    model = efficientnet_b0(seed=0)
    kinds = [layer.kind for layer in model.layers]
    n_5x5 = sum(layer.kind == "dwconv" and layer.kernel == (5, 5)
                for layer in model.layers)
    if (kinds.count("gate"), n_5x5, model.input_shape, model.out_shape) != (
            16, 9, (3, 224, 224), (1000, 1, 1)):
        raise AssertionError("efficientnet_b0 is not the paper's model")
    rng = np.random.default_rng(7)
    calib = [rng.standard_normal(model.input_shape).astype(np.float32)
             for _ in range(2)]
    qmodel = Session(split_model(model, RATINGS, mode="spatial"),
                     calibration=calib, device="cpu").qmodel
    xs = rng.standard_normal((EFF_BATCH, *model.input_shape)).astype(
        np.float32)
    ref = np.stack([reference_forward(model, x, device=dev, qmodel=qmodel)
                    for x in xs])
    paths, runs = [], {}
    for mode in ("spatial", "kernel", "neuron"):
        bands = mode == "spatial"
        need = ("qgemm", "se_pool", "se_gate",
                "dwconv3x3_bands" if bands else "dwconv3x3",
                "dwconv5x5_bands_unpadded" if bands else "dwconv5x5_shards",
                *(("band_windows", "band_take") if bands else ()))
        rec, calls = serve_path(mode, model, qmodel, xs, dev,
                                label=f"effnet_{mode}", want_ys=ref,
                                need=need)
        paths.append(rec)
        runs[rec["mode"]] = engine_launches(calls)
    return paths, runs


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


# -- serving phase: the multi-tenant server over the card's sessions ----------

SERVE_RATINGS = (3.0, 1.0, 2.0, 0.5)   # tenant B's 4 MCUs (the example's)
SERVE_B_HW = (96, 96)
SERVE_MAX_BATCH = 8
SERVE_REQUESTS = 32                 # per tenant, held against Session.run
SERVE_BURST = 128                   # requests of a saturation burst
SERVE_STEADY_S = 3.0
SERVE_OVERLOAD_S = 3.0
SERVE_P99_TARGET_S = 0.25           # tenant B's SLO
SERVE_P99_BOUND_S = 1.0             # accepted-tail bound under 2x overload
MANY_WORKERS = 72                   # dw_many_shards: > MAX_SHARDS shards


class _ShedCounter:
    """A server as the load generator sees it (``running``, ``submit``),
    counting each typed ``Overloaded`` by its reason."""

    def __init__(self, server):
        import collections
        self.server = server
        self.reasons = collections.Counter()

    @property
    def running(self) -> bool:
        return self.server.running

    def submit(self, tenant, x):
        from repro_torch.serve import Overloaded
        try:
            return self.server.submit(tenant, x)
        except Overloaded as e:
            self.reasons[e.reason] += 1
            raise


def _serving_server(tenants, qmodels, max_inflight, dev):
    from repro_torch.serve import SLO, Server
    srv = Server(max_inflight=max_inflight)
    for name, (plan, slo) in tenants.items():
        srv.add_tenant(name, plan, precision="int8", qmodel=qmodels[name],
                       max_batch=SERVE_MAX_BATCH, device=dev,
                       slo=SLO(p99_target_s=slo, queue_cap=1024))
    return srv


def serving_phase(model, dev):
    """Two tenants on one ``Server(max_inflight=2)`` at full width, int8:
    A = ``model`` (``mobilenet_v2_paper``) on the spatial split of RATINGS,
    B = ``mobilenet_v2(input_hw=(96, 96))`` on a neuron-mode split of
    SERVE_RATINGS with SLO p99 <= SERVE_P99_TARGET_S; their int8 constants
    from one seed-0 calibration each on the card, made before ``start()``.
    With every launch counter at 0 after the warm-up: SERVE_REQUESTS
    requests a tenant through ``Server.submit`` must equal ``Session.run``
    byte for byte, under a profiler trace whose engine kernels must number
    what a recorded walk of each tenant's engine lists at each bucket, for
    the dispatches made (``launches``, by wrapper: ``qgemm``,
    ``dwconv3x3_bands`` (A) and ``dwconv3x3`` (B) must be among them);
    then each tenant's
    ``saturation_throughput``, open-loop Poisson at 0.4x of it for
    SERVE_STEADY_S (no failure), and B at 2x its saturation for
    SERVE_OVERLOAD_S (typed shedding counted by reason, accepted p99 <=
    SERVE_P99_BOUND_S).  The counters must still read 0: every dispatch
    replayed a graph.  Last, each tenant's dispatch p50 at bucket 8 at
    saturation under max_inflight 1 and 2 (the dispatch's own device time).
    Returns the record and the launches of one forward at each bucket the
    tenants dispatched (for the shape checks)."""
    import numpy as np
    import torch
    from repro_torch.api import Session
    from repro_torch.core import split_model
    from repro_torch.models import mobilenet_v2
    from repro_torch.serve import run_open_loop, saturation_throughput
    from torch_launches import census, engine_launches
    t_phase = time.perf_counter()
    model_b = mobilenet_v2(input_hw=SERVE_B_HW, seed=0)
    tenants = {"a": (split_model(model, RATINGS, mode="spatial"), None),
               "b": (split_model(model_b, SERVE_RATINGS, mode="neuron"),
                     SERVE_P99_TARGET_S)}
    qmodels = {name: Session(plan, precision="int8", seed=0,
                             device=dev).qmodel
               for name, (plan, _) in tenants.items()}
    rng = np.random.default_rng(5)
    xs = {name: rng.standard_normal((SERVE_REQUESTS, *plan.model.input_shape))
          .astype(np.float32) for name, (plan, _) in tenants.items()}
    want = {}
    for name, (plan, _) in tenants.items():
        oracle = Session(plan, qmodel=qmodels[name], device=dev,
                         max_batch=SERVE_MAX_BATCH)
        want[name] = [oracle.run(x) for x in xs[name]]
    srv = _serving_server(tenants, qmodels, 2, dev)
    engines = {name: srv.session(name).engine for name in tenants}
    # the launches of one forward at each bucket: a recorded walk of each
    # tenant's engine, before the counters are set to 0
    listed_at = {}
    for name, (plan, _) in tenants.items():
        shape = plan.model.input_shape
        listed_at[name] = {b: engine_launches(census(
            engines[name], torch.zeros((b, *shape), device=dev)))
            for b in srv.session(name).buckets}
    wrappers = counters()
    for fn in wrappers.values():
        fn.launches = 0
    shed = _ShedCounter(srv)

    def exact():
        """The requests against ``Session.run``; returns the launches the
        plans list for the dispatches they made, by wrapper and by kernel
        on the card."""
        before = {name: srv.session(name).stats().per_bucket
                  for name in tenants}
        tickets = {name: [] for name in tenants}
        for i in range(SERVE_REQUESTS):
            for name in tenants:
                tickets[name].append(srv.submit(name, xs[name][i]))
        for name in tenants:
            for i, t in enumerate(tickets[name]):
                got = t.result(timeout=120.0)
                if (got.dtype != want[name][i].dtype
                        or got.tobytes() != want[name][i].tobytes()):
                    raise AssertionError(f"serving: tenant {name} request "
                                         f"{i} != Session.run")
        listed = dict.fromkeys(CNN_WRAPPERS, 0)
        for name in tenants:
            for b, n in srv.session(name).stats().per_bucket.items():
                for k, _, _ in listed_at[name][b]:
                    listed[k] += n - before[name].get(b, 0)
        kinds = {kernel: sum(listed[w] for w in ws)
                 for kernel, ws in ENGINE_KERNELS.items()}
        return listed, kinds

    with srv:
        launches, kernels, kinds, tries = traced_kernels(exact)
        if kernels != kinds:
            raise AssertionError(f"serving ran {kernels} kernels in each of "
                                 f"{tries} traces, its plans count {kinds}")
        probe = {name: xs[name][0] for name in tenants}
        makers = {name: (lambda x=x: x) for name, x in probe.items()}
        sat = {name: saturation_throughput(srv, name, makers[name],
                                           n_requests=SERVE_BURST)
               for name in tenants}
        steady = run_open_loop(srv, {n: 0.4 * r for n, r in sat.items()},
                               makers, duration_s=SERVE_STEADY_S, seed=1)
        for name, r in steady.items():
            if r.failed or r.completed == 0 or r.completed != r.accepted:
                raise AssertionError(f"serving steady: {r}")
        rejected_before = srv.stats("b").rejected
        over = run_open_loop(shed, {"b": 2.0 * sat["b"]}, {"b": makers["b"]},
                             duration_s=SERVE_OVERLOAD_S, seed=2)["b"]
        qos = {name: srv.stats(name) for name in tenants}
    walked = {name: fn.launches for name, fn in wrappers.items()
              if fn.launches}
    if walked:
        raise AssertionError(f"serving walked the plan: {walked}")
    if not over.rejected > 0:
        raise AssertionError(f"serving overload shed nothing: {over}")
    if (sum(shed.reasons.values()) != over.rejected
            or qos["b"].rejected - rejected_before != over.rejected
            or not set(shed.reasons) <= {"slo", "queue_cap"}):
        raise AssertionError(f"serving overload: rejections {over.rejected} "
                             f"vs typed {dict(shed.reasons)}")
    if over.failed or over.completed != over.accepted:
        raise AssertionError(f"serving overload: {over}")
    if not over.p99_s <= SERVE_P99_BOUND_S:
        raise AssertionError(f"serving overload: accepted p99 {over.p99_s}")
    for name in ("qgemm", "dwconv3x3_bands", "dwconv3x3", "se_pool"):
        if launches[name] <= 0:
            raise AssertionError(f"serving launched no {name}: {launches}")
    buckets = {name: sorted(srv.session(name).stats().per_bucket)
               for name in tenants}
    del srv

    # the dispatch's own time at bucket 8 at saturation, one pipeline
    # depth after the other (fresh sessions: the constants are cached)
    dispatch_p50 = {}
    for depth in (1, 2):
        srv = _serving_server(tenants, qmodels, depth, dev)
        with srv:
            rates = {name: saturation_throughput(srv, name, makers[name],
                                                 n_requests=SERVE_BURST,
                                                 repeats=2)
                     for name in tenants}
        dispatch_p50[f"max_inflight_{depth}"] = {
            name: dict(ms=srv.session(name).dispatch_latency_s(bucket=8)
                       * 1e3, saturation_rps=rates[name])
            for name in tenants}
        del srv

    def load(r):
        return dict(offered_rps=r.offered_rps, submitted=r.submitted,
                    accepted=r.accepted, rejected=r.rejected,
                    completed=r.completed, failed=r.failed,
                    p50_ms=r.p50_s * 1e3, p99_ms=r.p99_s * 1e3,
                    throughput_rps=r.throughput_rps,
                    rejection_rate=r.rejection_rate)

    rec = dict(
        tenants={
            "a": dict(model="mobilenet_v2_paper", input=list(
                model.input_shape), split="spatial", workers=len(RATINGS)),
            "b": dict(model="mobilenet_v2", input=list(model_b.input_shape),
                      split="neuron", workers=len(SERVE_RATINGS),
                      p99_target_ms=SERVE_P99_TARGET_S * 1e3)},
        max_batch=SERVE_MAX_BATCH, max_inflight=2,
        bit_exact_vs_session_run=True, requests_per_tenant=SERVE_REQUESTS,
        saturation_rps=sat,
        steady={name: load(r) for name, r in steady.items()},
        overload=dict(load(over), reasons=dict(shed.reasons),
                      p99_bound_ms=SERVE_P99_BOUND_S * 1e3),
        launches=launches, kernels_traced=kernels, traces=tries,
        buckets=buckets, graphs={name: engine.graph_stats()
                for name, engine in engines.items()},
        dispatch_p50=dispatch_p50,
        qos={name: dict(latency_p50_ms=q.latency_p50_s * 1e3,
                        latency_p99_ms=q.latency_p99_s * 1e3,
                        completed=q.completed, rejected=q.rejected,
                        failed=q.failed) for name, q in qos.items()},
        seconds=time.perf_counter() - t_phase)
    print(f"serving {json.dumps(rec)}")
    runs = {f"serving_{name}@{b}": listed_at[name][b]
            for name in tenants for b in buckets[name]}
    return rec, runs


def dw_many_shards(dev) -> dict:
    """A neuron-mode split of ``mobilenet_v2_smoke`` over MANY_WORKERS
    equal workers: each depthwise layer is a table of MANY_WORKERS shards,
    more than one launch takes, so it runs in ``ceil(n / MAX_SHARDS)``
    launches.  Each layer's call of the recorded walk equals its plain
    version on the engine's own operands (``torch_launches.on_cpu``), and
    a batch served on the card equals the CPU's, bit for bit, with a
    profiler trace of it showing exactly those launches (``serve_path``:
    the batch replays the graph that the warm-up captured)."""
    import numpy as np
    import torch
    from repro_torch.api import Session
    from repro_torch.core import split_model
    from repro_torch.models import mobilenet_v2_smoke
    from torch_launches import on_cpu
    model = mobilenet_v2_smoke(seed=0)
    ratings = np.ones(MANY_WORKERS)
    rng = np.random.default_rng(6)
    calib = [rng.standard_normal(model.input_shape).astype(np.float32)
             for _ in range(2)]
    xs = rng.standard_normal((4, *model.input_shape)).astype(np.float32)
    qmodel = Session(split_model(model, ratings, mode="neuron"),
                     calibration=calib, device="cpu").qmodel
    path, calls = serve_path("neuron", model, qmodel, xs, dev,
                             label="dw_many_shards", ratings=ratings)
    layers = []
    for c in calls:
        if c.name != "dwconv3x3":
            continue
        if not torch.equal(c.fn(*c.args, **c.kwargs).cpu(), on_cpu(c)):
            raise AssertionError(f"dw_many_shards {c.block}: != plain")
        layers.append(dict(layer=c.block["first"], shards=len(c.args[1].rows),
                           launches=len(c.args[1].launches)))
    if not all(r["shards"] == MANY_WORKERS and r["launches"] > 1
               for r in layers) or len(layers) != 5:
        raise AssertionError(f"dw_many_shards: tables {layers}")
    rec = dict(model="mobilenet_v2_smoke", split="neuron",
               workers=MANY_WORKERS, layers=layers,
               launches=path["kernels_traced"]["dwconv3x3_kernel"],
               tables_bit_exact_vs_plain=True, bit_exact_vs_cpu=True)
    print(f"dw_many_shards {json.dumps(rec)}")
    return rec


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


def decode_attn_line(serve, live, recs, families) -> dict:
    """The ``kernels`` entry of decode_attn: launches from the served runs'
    counters (the dense run's and each family's, ``families``, from
    ``family_attn_totals``); each time the per-launch time at the run's
    live shape times its launches; the bound summed over the runs'
    launches at their own lengths."""
    path = recs[0]
    n = serve["launches"]["decode_attn"]
    cfg = live["cfg"]
    item = live["item"]
    bound = sum(_decode_bound([ln] * LM_BATCH, cfg.n_kv_heads,
                              cfg.q_groups, cfg.resolved_head_dim, item,
                              item)[0]
                for ln in live["lengths"]) * cfg.n_layers
    dense = dict(launches=n, ms=n * (path["device_ms"] or path["event_ms"]),
                 plain_ms=n * path["plain_ms"], bound_ms=bound,
                 library_ms=n * path["library_ms"],
                 in_path_ms=n * serve["decode_attn_in_path_ms"],
                 max_abs_err=max(r["max_abs_err"] for r in recs))
    runs = {"lm_decode": dense, **families}
    ms_from = "profiler" if path["device_ms"] is not None else "events"
    return dict(
        name="decode_attn", route="cuda",
        source="src/repro_torch/csrc/decode_attn.cu",
        replaces="src/repro/kernels/decode_attn/decode_attn.py:63",
        **{key: sum(r[key] for r in runs.values())
           for key in ("launches", "ms", "plain_ms", "bound_ms")},
        bound_by="bytes",
        library_ms=sum(r["library_ms"] for r in runs.values()),
        max_abs_err=max(r["max_abs_err"] for r in runs.values()),
        ms_from=ms_from,
        in_path_ms=sum(r["in_path_ms"] for r in runs.values()),
        launches_by_path={name: r["launches"] for name, r in runs.items()},
        by_path=runs)


# -- LM families phase: moe, hybrid, ssm, audio, vlm -------------------------

# (a) float32 checks at full width, TF32 off: (arch, layers (None: the
# config's), batch, decoder prompt).  The depth holds every block kind of
# the family; MoE at batch 8 with capacity factor 8 (the reference's test),
# where decode's 8 tokens leave each expert room for 6 (deepseek) or 16
# (dbrx); the hybrid's prompt of 2052 > its 2048 window fills the ring in
# rotated order, and each decode step overwrites its oldest slot.
FAMILY_CHECKS = (("deepseek-moe-16b", 2, 8, 16), ("dbrx-132b", 2, 8, 16),
                 ("recurrentgemma-9b", 3, 2, 2052), ("xlstm-1.3b", 8, 2, 64),
                 ("whisper-base", None, 2, 16),
                 ("llava-next-mistral-7b", 2, 2, 16))
FAMILY_CHECK_STEPS = 4
# (b) bf16 serves of LM_BATCH prompts at full width: (arch, layers (None:
# the config's), decoder prompt, decode steps).  dbrx-132b is cut to 4 of
# its 40 layers: its 263 GB of bf16 weights do not fit in 80 GB.  Whisper's
# decoder prompt is its text context (448); llava's 1472 tokens follow its
# 576 patches, 2048 positions in all.
FAMILY_SERVES = (("deepseek-moe-16b", None, LM_PROMPT, LM_TOKENS),
                 ("dbrx-132b", 4, LM_PROMPT, 8),
                 ("recurrentgemma-9b", None, LM_PROMPT, 8),
                 ("xlstm-1.3b", None, LM_PROMPT, 8),
                 ("whisper-base", None, 448, 8),
                 ("llava-next-mistral-7b", None, LM_PROMPT - 576, 8))
# decode attentions against a cache, a block: self (attn, moe) and, for
# whisper's decoder, self and cross
ATTN_CALLS = {"attn": {"self": 1}, "moe": {"self": 1},
              "xattn": {"self": 1, "cross": 1}}


def _family_inputs(cfg, b, s, rng, dev):
    """Prompts and the stub frontend's frame or patch embeddings (from
    ``rng``), as the serve steps take them."""
    import numpy as np
    import torch
    from repro_torch.nn.layers import torch_dtype
    out = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (b, s))).to(dev)}
    stub = {"audio": ("frames", cfg.n_audio_frames),
            "vlm": ("patches", cfg.n_patches)}.get(cfg.family)
    if stub:
        out[stub[0]] = torch.from_numpy(rng.standard_normal(
            (b, stub[1], cfg.d_model)).astype(np.float32)).to(
            dev, torch_dtype(cfg.dtype))
    return out


def _attn_calls(cfg) -> dict:
    """Decode attentions a step, by cache kind (self, cross)."""
    from repro_torch.models import lm
    out = {"self": 0, "cross": 0}
    for pattern, ng in lm.pattern_stacks(cfg):
        for kind in pattern:
            for name, n in ATTN_CALLS.get(kind, {}).items():
                out[name] += n * ng
    return out


def family_check_fp32(arch, n_layers, b, s, dev) -> dict:
    """Phase (a) of one family: prefill and FAMILY_CHECK_STEPS greedy
    decode steps through the serve steps, in float32 at full width with
    TF32 off, must give the full (train mode) forward's logits at each
    step's position within LM_RTOL/LM_ATOL, and its greedy tokens.  The
    full forward runs once, over the prompt and the generated tokens: it is
    causal, so position p sees what the step at p saw."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.executor import _full_fp32
    from repro_torch.models import lm
    from repro_torch.train.serve import make_decode_step, make_prefill_step
    cfg = get_config(arch)
    kw = dict(dtype="float32")
    if n_layers:
        kw["n_layers"] = n_layers
    if cfg.n_experts:
        kw["capacity_factor"] = 8.0
    cfg = dataclasses.replace(cfg, **kw)
    n = FAMILY_CHECK_STEPS
    prefix = cfg.n_patches if cfg.family == "vlm" else 0
    max_seq = prefix + s + n + 1
    with _full_fp32():
        params = lm.init_model(cfg, 0, device=dev)
        inp = _family_inputs(cfg, b, s, np.random.default_rng(1), dev)
        cache = lm.init_cache(cfg, b, max_seq, device=dev)
        logits, cache = make_prefill_step(cfg, b, max_seq, device=dev)(
            params, cache, inp)
        decode = make_decode_step(cfg, b, max_seq, device=dev)
        got, toks = [logits], []
        for _ in range(n):
            toks.append(torch.argmax(got[-1], -1)[:, None])
            got.append(decode(params, cache, toks[-1])[0])
        full = lm.forward(params, dict(inp, tokens=torch.cat(
            [inp["tokens"]] + toks, dim=1)), cfg, mode="train")
        errs = []
        for i, lg in enumerate(got):
            ref = full[:, prefix + s - 1 + i]
            errs.append(float((lg - ref).abs().max()))
            if not torch.allclose(lg, ref, rtol=LM_RTOL, atol=LM_ATOL):
                raise AssertionError(f"{arch} fp32 step {i}: cache path "
                                     f"differs from the full forward by "
                                     f"{errs[-1]}")
            if not torch.equal(torch.argmax(lg, -1), torch.argmax(ref, -1)):
                raise AssertionError(f"{arch} fp32 step {i}: greedy tokens "
                                     f"differ")
    del params, cache, full
    torch.cuda.empty_cache()
    rec = dict(phase="a", arch=arch, n_layers=cfg.n_layers,
               kinds=[list(p) for p, _ in lm.pattern_stacks(cfg)],
               dtype="float32", batch=b, prompt=s, prefix=prefix,
               decode_steps=n, max_seq=max_seq,
               capacity_factor=cfg.capacity_factor if cfg.n_experts else None,
               max_abs_err=max(errs), rtol=LM_RTOL, atol=LM_ATOL,
               greedy_tokens=[t[:, 0].tolist() for t in toks])
    print(f"lm_family {json.dumps(rec)}")
    return rec


def _family_step_bytes(cfg, params, cache, b: int, pos: int) -> int:
    """Bytes one decode step at position ``pos`` must move: every weight it
    reads once (not the embedding table but the batch's rows, not the
    audio encoder or the vlm patch projection, which decode does not run),
    each self-attention cache's K and V up to its valid length and one slot
    written, each cross-attention cache read whole, and each recurrent
    state read and written once."""
    from repro_torch.models import lm
    from repro_torch.nn.layers import leaves

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in leaves(tree))

    skip = nbytes(params["embed"]) + nbytes(params.get("encoder", {})) + \
        nbytes(params.get("mm_proj", {}))
    total = nbytes(params) - skip + b * params["embed"].shape[1] * \
        params["embed"].element_size()
    for (pattern, ng), stack in zip(lm.pattern_stacks(cfg), cache["stacks"]):
        for key, blk in stack.items():
            kind = key.split("_", 1)[1]
            if kind not in ATTN_CALLS:
                total += 2 * nbytes(blk)
                continue
            attn = blk["self"] if kind == "xattn" else blk
            k = attn["k"]                          # (ng, B, w, K, hd)
            slot = 2 * k[0, 0, 0].numel() * k.element_size()
            total += ng * b * (min(pos + 1, k.shape[2]) + 1) * slot
            if kind == "xattn":
                total += nbytes(blk["cross"])
    return total


def family_serve(arch, n_layers, s, n, dev, mesh=None,
                 single=None) -> tuple[dict, dict]:
    """Phase (b) of one family: bf16 at full width (random weights, seed
    0), LM_BATCH prompts of ``s`` decoder tokens: a warm-up prefill, the
    timed prefill, then ``n`` greedy decode steps through the serve steps,
    the last LM_PROFILED_STEPS of them under the profiler.  ``decode_attn``
    must launch once for each attention against a cache in each step, and
    no other kernel at all.  On one device no decode step may make a
    synchronising call.  With ``mesh`` the steps are the mesh's (params and
    cache placed by its serve rules; each self-attention through the
    kernel's log-sum-exp output and its merge), beside ``single``, the
    same run's record on one device, whose first tokens they must repeat.
    Returns the record and layer 0's live caches (local shards) for phase
    (c)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.nn.layers import leaves
    from repro_torch.parallel.sharding import local
    from repro_torch.train import serve
    cfg = get_config(arch)
    full_layers = cfg.n_layers
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    b = LM_BATCH
    prefix = cfg.n_patches if cfg.family == "vlm" else 0
    max_seq = prefix + s + n + 1
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if mesh is None:
        params = lm.init_model(cfg, 0, device=dev)
        cache = lm.init_cache(cfg, b, max_seq, device=dev)
        kw = dict(device=dev)
    else:
        rules = serve.serve_rules(mesh)
        params = serve.init_serve_params(cfg, rules, 0)
        cache = serve.place_cache(cfg, rules, b, max_seq)
        kw = dict(mesh=mesh)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in leaves(params))
    params_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    inp = _family_inputs(cfg, b, s, np.random.default_rng(0), dev)
    prefill = serve.make_prefill_step(cfg, b, max_seq, **kw)
    decode = serve.make_decode_step(cfg, b, max_seq, **kw)
    prefill(params, cache, inp)            # warm-up; refilled below
    torch.cuda.synchronize()

    wrappers = counters()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    logits, cache = prefill(params, cache, inp)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    # a mesh's logits are (batch, vocab) DTensors: this rank's rows, whole
    # along the vocab, are every row at world 1
    gen, positions = [torch.argmax(local(logits), -1)[:, None]], []

    def step():
        positions.append(cache["pos"])
        out, _ = decode(params, cache, gen[-1])
        out = local(out)
        gen.append(torch.argmax(out, -1)[:, None])
        return out

    timed = n - LM_PROFILED_STEPS
    t0 = time.perf_counter()
    if mesh is None:
        torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(timed):
            step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    events, wall_us, logits = trace_calls(step, LM_PROFILED_STEPS)
    calls = _attn_calls(cfg)
    per_step = calls["self"] + calls["cross"]
    launches = {name: fn.launches for name, fn in wrappers.items()}
    expect = {name: 0 for name in wrappers}
    expect["decode_attn"] = n * per_step
    if launches != expect:
        raise AssertionError(f"{arch}: launched {launches}, expected "
                             f"{expect}")
    if not bool(torch.isfinite(logits).all()) or logits.shape != (
            b, cfg.padded_vocab):
        raise AssertionError(f"{arch}: logits {tuple(logits.shape)} not "
                             f"finite")
    if torch.cat(gen, dim=1).shape != (b, n + 1):
        raise AssertionError(f"{arch}: generated {len(gen)} tokens")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    busy_us = sum(us for _, us in events)
    attn_us = [us for name, us in events if "decode_attn_" in name]
    kpl = wrappers["decode_attn"].kernels_per_launch
    n_attn = LM_PROFILED_STEPS * per_step * kpl
    # at most one dropped kernel event a traced step (see lm_serve)
    if not n_attn - LM_PROFILED_STEPS <= len(attn_us) <= n_attn:
        raise AssertionError(f"{arch}: profiled {len(attn_us)} decode_attn "
                             f"kernels for {n_attn}")
    by_name: dict[str, float] = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us
    step_ms = decode_s * 1e3 / timed
    bound = [_family_step_bytes(cfg, params, cache, b, pos) / PEAK_BYTES_S
             * 1e3 for pos in positions[:timed]]
    rec = dict(
        phase="b", arch=arch, n_layers=cfg.n_layers,
        config_layers=full_layers, dtype=cfg.dtype, params=n_params,
        params_gb=params_bytes / 1e9,
        cache_gb=sum(t.numel() * t.element_size()
                     for t in leaves(cache["stacks"])) / 1e9,
        init_s=init_s, batch=b, prefix=prefix, prompt=s, decode_steps=n,
        max_seq=max_seq, prefill_ms=prefill_ms,
        decode_ms_per_step=step_ms, decode_steps_timed=timed,
        tokens_per_s=b / step_ms * 1e3,
        decode_bound_ms_per_step=statistics.mean(bound),
        decode_bound_by="bytes", profiled_steps=LM_PROFILED_STEPS,
        profiled_wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
        device_busy_share=busy_us / wall_us,
        device_idle_share=1 - busy_us / wall_us, device_events=len(events),
        decode_attn_in_path_ms=(sum(attn_us) / len(attn_us) * kpl / 1e3
                                if attn_us else None),
        decode_attn_events_dropped=n_attn - len(attn_us),
        attn_calls_per_step=calls, positions=positions,
        top=[dict(name=k[:80], ms=v / 1e3) for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:6]],
        launches=launches, peak_memory_gb=peak_gb, logits_finite=True,
        first_tokens=torch.cat(gen, dim=1)[0, :8].tolist())
    if mesh is not None:
        rec.update(mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
                   single_decode_ms_per_step=single["decode_ms_per_step"],
                   single_prefill_ms=single["prefill_ms"],
                   single_first_tokens=single["first_tokens"],
                   mesh_overhead=step_ms / single["decode_ms_per_step"] - 1)
        if rec["first_tokens"] != single["first_tokens"]:
            raise AssertionError(f"mesh {arch}: first tokens "
                                 f"{rec['first_tokens']}, one device "
                                 f"{single['first_tokens']}")
    print(f"{'mesh_family' if mesh is not None else 'lm_family'} "
          f"{json.dumps(rec)}")
    live = {}
    for stack in cache["stacks"]:
        for blk in stack.values():
            for kind, c in (("self", blk.get("self", blk)),
                            ("cross", blk.get("cross"))):
                if c is not None and "k" in c and kind not in live:
                    live[kind] = dict(k=local(c["k"])[0].clone(),
                                      v=local(c["v"])[0].clone())
    live.update(cfg=cfg, pos=cache["pos"])
    del params, cache
    torch.cuda.empty_cache()
    return rec, live


def family_kernel_cases(serve, live, dev, lse: bool = False) -> list[dict]:
    """Phase (c) of one family: flash-decode against its plain version on
    layer 0's live caches (bf16 q, as the decode path launches it), timed
    beside its plain version, SDPA and the bound; with ``lse`` (a mesh's
    serve) the self-attention cache through the log-sum-exp output, as the
    mesh's decode launches it."""
    import numpy as np
    import torch
    cfg = live["cfg"]
    b, k_, g, hd = (LM_BATCH, cfg.n_kv_heads, cfg.q_groups,
                    cfg.resolved_head_dim)
    rng = np.random.default_rng(4)
    recs = []
    for kind in ("self", "cross"):
        if kind not in live:
            continue
        ck, cv = live[kind]["k"], live[kind]["v"]
        q = torch.from_numpy(rng.standard_normal((b, 1, k_, g, hd)).astype(
            np.float32)).to(dev, ck.dtype)
        n_valid = min(live["pos"], ck.shape[1]) if kind == "self" \
            else ck.shape[1]
        lens = torch.full((b,), n_valid, dtype=torch.int32, device=dev)
        label = f"{serve['arch']} {kind}, layer 0"
        if lse and kind == "self":
            rec = decode_attn_lse_case(cfg, ck, cv, n_valid, f"mesh {label}, "
                                       f"lse output", dev)
        else:
            rec = decode_attn_case(label, q, ck, cv, lens, True)
        rec.update(arch=serve["arch"], cache=kind)
        recs.append(rec)
    del live["self"]
    live.pop("cross", None)
    torch.cuda.empty_cache()
    return recs


def family_attn_totals(serve, cfg, cases) -> dict:
    """decode_attn over one family's served run: launches by the counter;
    ms, plain and library times at the live shape of each cache kind times
    its launches; the bound summed over the run's launches at their own
    lengths."""
    n = serve["decode_steps"]
    calls = serve["attn_calls_per_step"]
    k_, g, hd = cfg.n_kv_heads, cfg.q_groups, cfg.resolved_head_dim
    tot = dict(launches=serve["launches"]["decode_attn"], ms=0.0,
               plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
               max_abs_err=max(c["max_abs_err"] for c in cases),
               in_path_ms=serve["launches"]["decode_attn"]
               * serve["decode_attn_in_path_ms"])
    for c in cases:
        m = n * calls[c["cache"]]
        tot["ms"] += m * (c["device_ms"] or c["event_ms"])
        tot["plain_ms"] += m * c["plain_ms"]
        tot["library_ms"] += m * c["library_ms"]
        for pos in serve["positions"] if c["cache"] == "self" else [None] * n:
            ln = c["S"] if pos is None else min(pos + 1, c["S"])
            tot["bound_ms"] += calls[c["cache"]] * _decode_bound(
                [ln] * LM_BATCH, k_, g, hd, 2, 2)[0]
    return tot


def lm_families_phase(dev) -> tuple[list[dict], list[dict], dict]:
    """Phases (a)-(c) for each family config, one model at a time, each
    freed before the next.  Returns the (a) and (b) records, the (c)
    kernel records, and decode_attn's totals by family path."""
    checks = [family_check_fp32(*c, dev) for c in FAMILY_CHECKS]
    serves, cases, totals = [], [], {}
    for arch, n_layers, s, n in FAMILY_SERVES:
        rec, live = family_serve(arch, n_layers, s, n, dev)
        cfg = live["cfg"]
        recs = family_kernel_cases(rec, live, dev) if "self" in live else []
        serves.append(rec)
        cases += recs
        if recs:
            totals[f"lm_family/{arch}"] = family_attn_totals(rec, cfg, recs)
    return checks + serves, cases, totals


# -- training phase: lm_loss -> AdamW -> train step -> data -> checkpoint --

TRAIN_ARCHS = ("qwen3-14b", "deepseek-moe-16b", "dbrx-132b",
               "recurrentgemma-9b", "xlstm-1.3b", "whisper-base",
               "llava-next-mistral-7b")
# (a) float32, TF32 off: the card's step equals the CPU's (loss, grad norm,
# every gradient) at 1e-5 on each -smoke config (batch x seq below); at
# full width, qwen3-14b's 2 of 40 layers over 2 x 256 tokens with 128-row
# attention chunks, gradients under each remat policy and with 2
# microbatches agree within 1e-5 of each leaf's largest gradient
TRAIN_TOL = 1e-5
TRAIN_SMOKE_SHAPE = (2, 12)
TRAIN_CHECK = dict(n_layers=2, batch=2, seq=256, attn_chunk=128)
# Adam's first step is g / (|g| + eps): where |g| is near eps, 1e-6 of
# gradient noise moves it by up to lr, so updated params are held at
# TRAIN_TOL where |g| > TRAIN_BIG_GRAD and at 2 x lr elsewhere
TRAIN_BIG_GRAD = 1e-4
# (b) bf16 at full width: qwen3-14b cut to 6 of its 40 layers (training
# state is 12 bytes a parameter: 3.54 B parameters take 42.5 GB; 8 layers
# would pass 70 GB with the loss's logits), batch 2 x 2048 tokens, 10 steps
# of train_loop, the first 2 untimed, then 2 more steps traced
TRAIN_BF16 = dict(n_layers=6, batch=2, seq=2048, attn_chunk=1024, steps=10,
                  warmup=2, traced=2, lr=3e-4)
TRAIN_PEAK_GB = 72.0
# (c) the example's model: 40 steps at 16 x 32, lr 3e-3, the loss falls by
# more than 0.1 (tests/test_system.py:55-63); kill-and-resume at 4 x 16
# (tests/test_system.py:66-82)
TRAIN_EXAMPLE = dict(steps=40, batch=16, seq=32, lr=3e-3, drop=0.1)
TRAIN_RESUME_RTOL = 1e-4


def _train_batch(cfg, b, s, step=0):
    """The loop's batch ``step``: SyntheticLM tokens, and the stub frames or
    patches drawn as ``launch.train.train_loop`` draws them."""
    import numpy as np
    from repro_torch.data.pipeline import SyntheticLM
    out = SyntheticLM(cfg.vocab_size, seed=0).batch(step, b, s)
    stub = {"audio": ("frames", cfg.n_audio_frames),
            "vlm": ("patches", cfg.n_patches)}.get(cfg.family)
    if stub:
        out[stub[0]] = np.random.default_rng(step).standard_normal(
            (b, stub[1], cfg.d_model)).astype(np.float32)
    return out


def train_check_smoke(arch, dev) -> dict:
    """Phase (a), one -smoke config: loss_and_grads and one donated
    train step on the card against the same on the CPU (same weights, same
    batch), float32 with TF32 off: loss, grad norm and every gradient
    within TRAIN_TOL, updated params as TRAIN_BIG_GRAD says."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.executor import _full_fp32
    from repro_torch.models import lm
    from repro_torch.nn.layers import leaves, map_defs
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.trainer import (TrainOptions, loss_and_grads,
                                           make_train_step, to_device)
    cfg = get_config(arch + "-smoke")
    ocfg = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    batch = _train_batch(cfg, *TRAIN_SMOKE_SHAPE)
    cpu = lm.init_model(cfg, 0, device="cpu")
    with _full_fp32():
        out = {}
        for d in ("cpu", dev):
            # a copy each: the donated step updates it in place
            params = map_defs(lambda t: t.to(d, copy=True), cpu)
            loss, grads = loss_and_grads(params, to_device(batch, d), cfg)
            new, _, m = make_train_step(cfg, ocfg, TrainOptions(),
                                        device=d)(
                params, init_opt_state(params), batch)
            out[d] = (float(loss), grads, new, {k: float(v)
                                                for k, v in m.items()})
    (loss_c, g_c, p_c, m_c), (loss_d, g_d, p_d, m_d) = out["cpu"], out[dev]
    errs = [float((g.cpu() - e).abs().max())
            for g, e in zip(leaves(g_d), leaves(g_c))]
    for g, e in zip(leaves(g_d), leaves(g_c)):
        if not torch.allclose(g.cpu(), e, rtol=TRAIN_TOL, atol=TRAIN_TOL):
            raise AssertionError(f"train {arch}: card gradient differs from "
                                 f"the CPU's by {max(errs)}")
    for k in ("loss", "grad_norm", "lr"):
        if abs(m_d[k] - m_c[k]) > TRAIN_TOL * (1 + abs(m_c[k])):
            raise AssertionError(f"train {arch}: step {k} {m_d[k]} != "
                                 f"{m_c[k]}")
    upd_big, upd_small = 0.0, 0.0
    for p, q, g in zip(leaves(p_d), leaves(p_c), leaves(g_c)):
        err = (p.cpu() - q).abs()
        big = g.abs() > TRAIN_BIG_GRAD
        upd_big = max(upd_big, float(err[big].max()) if big.any() else 0.0)
        upd_small = max(upd_small, float(err.max()))
    if upd_big > TRAIN_TOL or upd_small > 2 * m_c["lr"]:
        raise AssertionError(f"train {arch}: updated params differ by "
                             f"{upd_big} (|g| > {TRAIN_BIG_GRAD}), "
                             f"{upd_small} (all)")
    return dict(arch=arch + "-smoke", loss=loss_d, loss_err=abs(loss_d - loss_c),
                grad_norm=m_d["grad_norm"], leaves=len(errs),
                max_abs_grad_err=max(errs), max_param_err_big_grad=upd_big,
                max_param_err=upd_small)


def train_check_full_width(dev) -> dict:
    """Phase (a) at full width: qwen3-14b cut to TRAIN_CHECK's layers, in
    float32 with TF32 off, over chunked attention under autograd.  The
    gradients with remat off are the reference for remat "full", "dots"
    and for 2 microbatches (with "full")."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.executor import _full_fp32
    from repro_torch.models import lm
    from repro_torch.nn.layers import leaves
    from repro_torch.train.trainer import loss_and_grads, to_device
    c = TRAIN_CHECK
    cfg = dataclasses.replace(get_config("qwen3-14b"), n_layers=c["n_layers"],
                              dtype="float32", attn_chunk=c["attn_chunk"])
    batch = to_device(_train_batch(cfg, c["batch"], c["seq"]), dev)
    rel = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _full_fp32():
        params = lm.init_model(cfg, 0, device=dev)
        loss0, ref = loss_and_grads(params, batch, dataclasses.replace(
            cfg, remat=False))
        for name, kw, micro in (("remat_full", dict(remat_policy="full"), 1),
                                ("remat_dots", dict(remat_policy="dots"), 1),
                                ("microbatches_2",
                                 dict(remat_policy="full"), 2)):
            loss, grads = loss_and_grads(params, batch, dataclasses.replace(
                cfg, remat=True, **kw), microbatches=micro)
            worst = max(float((g.float() - e).abs().max())
                        / max(float(e.abs().max()), 1e-30)
                        for g, e in zip(leaves(grads), leaves(ref)))
            rel[name] = dict(max_rel_grad_err=worst,
                             loss_err=abs(float(loss) - float(loss0)))
            if worst > TRAIN_TOL or rel[name]["loss_err"] > TRAIN_TOL * (
                    1 + abs(float(loss0))):
                raise AssertionError(f"train full width {name}: gradients "
                                     f"differ by {worst} of the largest")
            del grads
    torch.cuda.synchronize()
    rec = dict(arch=cfg.name, n_layers=cfg.n_layers, dtype="float32",
               batch=c["batch"], seq=c["seq"], attn_chunk=cfg.attn_chunk,
               loss=float(loss0), tol=TRAIN_TOL, checks=rel,
               seconds=time.perf_counter() - t0,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    del params, ref
    torch.cuda.empty_cache()
    return rec


def _train_step_ops(cfg, params, b: int, s: int) -> dict:
    """Operations one bf16 train step does, from the code's shapes: every
    matmul (the layers' and the head's, not the embedding lookup) forward
    once, again under the layer remat, and twice in backward; the float32
    attention (scores and probabilities x V over every (query, key) pair of
    each chunk, as ``_attend`` computes them) forward, under the layer
    remat, under the chunk checkpoint in backward, and twice in backward.
    Bytes of the AdamW pass: bf16 params read and written, bf16 grads read,
    float32 m and v read and written."""
    from repro_torch.nn.layers import leaves
    t = b * s
    layer = sum(x.numel() for x in leaves(params["stacks"])
                if x.dim() >= 3)               # (layers, in, out...) weights
    head = params["lm_head"].numel()
    mm = 2.0 * t * (3 * (layer + head) + layer)
    h, hd = cfg.n_heads, cfg.resolved_head_dim
    attn = 4.0 * b * h * s * s * hd * cfg.n_layers * 5
    n = sum(x.numel() for x in leaves(params))
    return dict(matmul_ops=mm, attention_ops=attn, adamw_bytes=22.0 * n,
                params=n)


def _op_class(name: str) -> str:
    """A device op's class by its kernel name: float32 GEMMs (the
    attention's einsums, on CUDA cores), other GEMMs (bf16 on tensor
    cores: cuBLAS's nvjet and xmma kernels), softmax, reductions, copies
    and casts, other elementwise kernels."""
    low = name.lower()
    if "gemm" in low or "nvjet" in low:
        return "gemm_f32" if "f32f32" in low or "sgemm" in low else "gemm"
    if "softmax" in low:
        return "softmax"
    if "reduce" in low:
        return "reduce"
    if "copy" in low or "memcpy" in low or "memset" in low:
        return "copy"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def train_bf16(dev) -> dict:
    """Phase (b): qwen3-14b at full width, cut to TRAIN_BF16's layers, bf16,
    remat "full": TRAIN_BF16["steps"] steps of ``train_loop`` (ms a step by
    the host clock after the warm-up steps, every loss and grad norm finite),
    then TRAIN_BF16["traced"] more steps of ``make_train_step`` under the
    profiler (busy and idle share, top device ops, device time by op
    class), then one step's gradients and its AdamW update timed apart;
    peak memory over all."""
    import dataclasses
    import math as m_

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_loop
    from repro_torch.train.optimizer import OptConfig, adamw_update
    from repro_torch.train.trainer import (TrainOptions, loss_and_grads,
                                           make_train_step, to_device)
    c = TRAIN_BF16
    cfg = dataclasses.replace(get_config("qwen3-14b"), n_layers=c["n_layers"],
                              remat=True, remat_policy="full",
                              attn_chunk=c["attn_chunk"])
    if cfg.dtype != "bfloat16":
        raise AssertionError(f"{cfg.name} trains in {cfg.dtype}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    marks, metrics = [], []

    def on_step(i, m):
        marks.append(time.perf_counter())
        metrics.append(dict(step=i, **m))

    t0 = time.perf_counter()
    params, state, losses = train_loop(
        cfg, steps=c["steps"], batch=c["batch"], seq=c["seq"], ckpt_dir=None,
        device=dev, lr=c["lr"], log_every=5, on_step=on_step)
    loop_s = time.perf_counter() - t0
    if len(losses) != c["steps"] or not all(
            m_.isfinite(m["loss"]) and m_.isfinite(m["grad_norm"])
            for m in metrics):
        raise AssertionError(f"train bf16: losses {losses}")
    timed = [b - a for a, b in zip(marks[c["warmup"]:], marks[c["warmup"]
                                                              + 1:])]
    step_ms = sum(timed) / len(timed) * 1e3
    # the loop's schedule, continued for the traced steps
    ocfg = OptConfig(lr=c["lr"], warmup_steps=max(c["steps"] // 20, 5),
                     total_steps=c["steps"])
    step = make_train_step(cfg, ocfg, TrainOptions(), device=dev)
    carry = [params, state]
    batches = [_train_batch(cfg, c["batch"], c["seq"], c["steps"] + i)
               for i in range(c["traced"])]

    def one():
        carry[0], carry[1], mt = step(carry[0], carry[1],
                                      batches.pop(0))
        return mt

    events, wall_us, mt = trace_calls(one, c["traced"])
    traced_loss = float(mt["loss"])
    # a step's halves alone, by the host clock around synchronised work:
    # the loss and its gradients, then the AdamW update
    batch = to_device(_train_batch(cfg, c["batch"], c["seq"],
                                   c["steps"] + c["traced"]), dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, grads = loss_and_grads(carry[0], batch, cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    adamw_update(grads, carry[1], carry[0], ocfg, in_place=True)
    torch.cuda.synchronize()
    split_ms = dict(loss_and_grads=(t1 - t0) * 1e3,
                    adamw_update=(time.perf_counter() - t1) * 1e3)
    del grads
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if peak_gb >= TRAIN_PEAK_GB or not m_.isfinite(traced_loss):
        raise AssertionError(f"train bf16: peak {peak_gb} GB, traced loss "
                             f"{traced_loss}")
    by_name: dict[str, float] = {}
    for name, us in events:
        by_name[name] = by_name.get(name, 0.0) + us
    busy_us = sum(by_name.values())
    by_class: dict[str, float] = {}
    for name, us in by_name.items():
        by_class[_op_class(name)] = by_class.get(_op_class(name), 0.0) + us
    ops = _train_step_ops(cfg, carry[0], c["batch"], c["seq"])
    mm_ms = ops["matmul_ops"] / PEAK_BF16_OPS_S * 1e3
    attn_ms = ops["attention_ops"] / PEAK_F32_OPS_S * 1e3
    adamw_ms = ops["adamw_bytes"] / PEAK_BYTES_S * 1e3
    bound = mm_ms + attn_ms + adamw_ms
    tokens = c["batch"] * c["seq"]
    rec = dict(
        arch=cfg.name, n_layers=cfg.n_layers, of_layers=get_config(
            "qwen3-14b").n_layers, dtype=cfg.dtype, remat=cfg.remat_policy,
        attn_chunk=cfg.attn_chunk, batch=c["batch"], seq=c["seq"],
        params=ops["params"], steps=c["steps"], warmup_steps=c["warmup"],
        loop_s=loop_s, ms_per_step=step_ms, step_ms=[x * 1e3 for x in timed],
        tokens_per_s=tokens / step_ms * 1e3,
        matmul_ops=ops["matmul_ops"], attention_ops=ops["attention_ops"],
        adamw_bytes=ops["adamw_bytes"], bound_ms=dict(
            matmul_bf16=mm_ms, attention_f32=attn_ms, adamw_bytes=adamw_ms,
            total=bound),
        bound_share=bound / step_ms,
        traced_steps=c["traced"], traced_wall_ms=wall_us / 1e3,
        device_busy_ms=busy_us / 1e3, device_busy_share=busy_us / wall_us,
        device_idle_share=1 - busy_us / wall_us, device_events=len(events),
        top=[dict(name=k[:80], ms=v / 1e3) for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]],
        device_ms_by_class={k: v / 1e3 for k, v in sorted(
            by_class.items(), key=lambda kv: -kv[1])},
        split_ms=split_ms, peak_memory_gb=peak_gb, losses=losses,
        grad_norms=[m["grad_norm"] for m in metrics], traced_loss=traced_loss)
    del params, state, carry
    torch.cuda.empty_cache()
    return rec


def train_example(dev, out_dir) -> dict:
    """Phase (c): the example's model (``examples/torch/train_small_lm.py``)
    learns at its own size; a run killed at step 6 (checkpoint at 3) and
    resumed to 10 ends where an uninterrupted one does; a bf16 copy of
    the state round-trips a checkpoint bit for bit."""
    import importlib.util
    import tempfile

    import numpy as np
    import torch
    from repro_torch.ckpt.checkpoint import (latest_step, restore_checkpoint,
                                             save_checkpoint)
    from repro_torch.launch.train import train_loop
    from repro_torch.nn.layers import leaves, map_defs
    spec = importlib.util.spec_from_file_location(
        "train_small_lm", ROOT / "examples" / "torch" / "train_small_lm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    cfg = example.small_config()
    e = TRAIN_EXAMPLE
    t0 = time.perf_counter()
    _, _, losses = train_loop(cfg, steps=e["steps"], batch=e["batch"],
                              seq=e["seq"], ckpt_dir=None, lr=e["lr"],
                              device=dev, log_every=100)
    learn_s = time.perf_counter() - t0
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    if not last < first - e["drop"]:
        raise AssertionError(f"train example: loss {first} -> {last}")
    with tempfile.TemporaryDirectory(prefix="train_ckpt_",
                                     dir=out_dir) as tmp:
        d1, d2, d3 = (str(Path(tmp) / n) for n in "abc")
        kw = dict(batch=4, seq=16, log_every=100, device=dev)
        train_loop(cfg, steps=6, ckpt_dir=d1, ckpt_every=3,
                   schedule_steps=10, **kw)
        if latest_step(d1) != 6:
            raise AssertionError(f"train resume: latest step {latest_step(d1)}")
        params, state, resumed = train_loop(cfg, steps=10, ckpt_dir=d1,
                                            ckpt_every=100, **kw)
        _, _, full = train_loop(cfg, steps=10, ckpt_dir=d2, ckpt_every=100,
                                **kw)
        if len(resumed) != 4 or abs(resumed[-1] - full[-1]) > \
                TRAIN_RESUME_RTOL * abs(full[-1]):
            raise AssertionError(f"train resume: {resumed} vs {full}")
        tree = {"params": map_defs(lambda t: t.to(torch.bfloat16), params),
                "opt": state}
        save_checkpoint(d3, 10, tree)
        back = restore_checkpoint(d3, 10, tree, device=dev)
        for a, b in zip(leaves(tree), leaves(back)):
            if a.dtype != b.dtype or a.device != b.device or not torch.equal(
                    a.reshape(-1).view(torch.uint8), b.reshape(-1).view(
                        torch.uint8)):
                raise AssertionError("train bf16 checkpoint: not bit-exact")
    return dict(model=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
                params=sum(t.numel() for t in leaves(params)),
                steps=e["steps"], batch=e["batch"], seq=e["seq"], lr=e["lr"],
                loss_first5=first, loss_last5=last, learn_s=learn_s,
                resumed_last_loss=resumed[-1], uninterrupted_last_loss=full[-1],
                resume_rtol=TRAIN_RESUME_RTOL,
                bf16_checkpoint_leaves=len(leaves(tree)),
                bf16_checkpoint_bit_exact=True)


def train_phase(dev, out_dir, card: str) -> dict:
    """The training path: (a) float32 checks, (b) bf16 training at full
    width, (c) the example.  The path launches none of the repository's
    kernels: every counter must stay 0."""
    t0 = time.perf_counter()
    wrappers = counters()
    for fn in wrappers.values():
        fn.launches = 0
    smoke = [train_check_smoke(arch, dev) for arch in TRAIN_ARCHS]
    for rec in smoke:
        print(f"train {json.dumps(dict(phase='a', **rec))}")
    full = train_check_full_width(dev)
    print(f"train {json.dumps(dict(phase='a', **full))}")
    bf16 = train_bf16(dev)
    print(f"train {json.dumps(dict(phase='b', **bf16))}")
    example = train_example(dev, out_dir)
    print(f"train {json.dumps(dict(phase='c', **example))}")
    launches = {name: fn.launches for name, fn in wrappers.items()}
    if any(launches.values()):
        raise AssertionError(f"the training path launched {launches}")
    summary = dict(seconds=time.perf_counter() - t0, kernel_launches=launches,
                   peak_memory_gb=bf16["peak_memory_gb"], card=card)
    print(f"train_phase {json.dumps(summary)}")
    return dict(smoke=smoke, full_width=full, bf16=bf16, example=example,
                **summary)


# -- mesh phase: torch.distributed + DTensor, one NCCL rank ------------------

MESH_SHAPE, MESH_AXES = (1, 1, 1), ("pod", "data", "model")
# (a) float32, TF32 off: the mesh step against the single-device step of
# PRs 17/18 on the same card: losses at rtol 1e-6, params and logits at
# 1e-6 of the leaf's (the step's) largest magnitude
MESH_ARCHS = ("qwen3-14b", "deepseek-moe-16b")
MESH_TOL = 1e-6
MESH_TRAIN_STEPS = 3
MESH_SERVE = dict(batch=2, prompt=16, decode_steps=4)
# (b) qwen3-14b, 6 of 40 layers, bf16, 2 x 2048, 10 steps of
# train_loop(mesh=), as TRAIN_BF16; (c) the full-depth bf16 serve of
# lm_serve through the mesh's steps
# the hybrid, ssm, audio and vlm families on the mesh (mesh_family lines):
# (a) as MESH_ARCHS, each cut to one group of its pattern: (arch, config
# overrides, decoder prompt (None: MESH_SERVE's)); the hybrid's prompt of
# 2052 fills its 2048-slot ring past the wrap, so each decode step
# overwrites its oldest slot; (b) FAMILY_SERVES' bf16 serves at full width
# and depth through the mesh's steps; (c) decode_attn's log-sum-exp output
# on their live caches (the ring's K1 G16 hd256, whisper's hd64)
MESH_FAMILY_CHECKS = (("recurrentgemma-9b", dict(n_layers=3), 2052),
                      ("xlstm-1.3b", dict(n_layers=8), None),
                      ("whisper-base", dict(n_layers=2, n_encoder_layers=2),
                       None),
                      ("llava-next-mistral-7b", dict(n_layers=2), None))
MESH_PHASE_LIMIT_S = 180.0


def release() -> float:
    """Collect garbage (a checkpointed graph may sit in a reference
    cycle), return the cached blocks to the card, and give the GB still
    allocated."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated() / 1e9


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


class split_calls:
    """Counts, while the block runs, the model axis's compute splits that
    the mesh's steps go through (one model rank at world 1 runs the same
    code): ``seq_gathers``, attention's gathers along the sequence (k, v
    and the sublayer's output, ``lm._seq_gather``); ``expert_splits``, MoE
    layers whose routed experts the rules split (``lm._moe`` with
    ``MeshCtx.experts``); ``vocab_embeds`` and ``vocab_heads``, the
    embedding tables and LM heads taken in their vocabulary slice
    (``lm._vocab_param`` with ``MeshCtx.vocab``), ``vocab_losses``, the
    log-sum-exps split over the model axis (``lm._split_logz`` with a
    group); ``head_splits``, decode attentions split by heads
    (``lm._heads_attn``); ``rglru_splits``, ``mlstm_splits`` and
    ``slstm_splits``, recurrent blocks run on this rank's slice of their
    channels (``lm._apply_rglru`` with ``MeshCtx.rnn``, ``lm._apply_mlstm``
    with ``MeshCtx.mlstm``, ``lm._apply_slstm`` with
    ``MeshCtx.slstm_ff``)."""

    NAMES = ("_seq_gather", "_moe", "_vocab_param", "_split_logz",
             "_heads_attn", "_apply_rglru", "_apply_mlstm", "_apply_slstm")
    # the recurrent blocks' counters and the MeshCtx field of their split
    RECURRENT = (("rglru_splits", "rnn"), ("mlstm_splits", "mlstm"),
                 ("slstm_splits", "slstm_ff"))

    def __enter__(self):
        from repro_torch.models import lm
        self.lm = lm
        self.n = dict(seq_gathers=0, expert_splits=0, vocab_embeds=0,
                      vocab_heads=0, vocab_losses=0, head_splits=0,
                      rglru_splits=0, mlstm_splits=0, slstm_splits=0)
        self.saved = [getattr(lm, name) for name in self.NAMES]
        gather, moe, vocab_param, logz, heads = self.saved[:5]

        def seq_gather(*a, **kw):
            self.n["seq_gathers"] += 1
            return gather(*a, **kw)

        def moe_layer(p, xn, ctx):
            self.n["expert_splits"] += ctx.mesh is not None and \
                ctx.mesh.experts is not None
            return moe(p, xn, ctx)

        def vocab_slice(t, mc, dim):
            if mc.vocab is not None:
                self.n["vocab_heads" if dim else "vocab_embeds"] += 1
            return vocab_param(t, mc, dim)

        def split_logz(lg, group):
            self.n["vocab_losses"] += group is not None
            return logz(lg, group)

        def heads_attn(*a, **kw):
            self.n["head_splits"] += 1
            return heads(*a, **kw)

        def recurrent(block, counter, field):
            def counted(p, xn, ctx, cache):
                self.n[counter] += ctx.mesh is not None and getattr(
                    ctx.mesh, field) is not None
                return block(p, xn, ctx, cache)
            return counted

        blocks = [recurrent(fn, *rc) for fn, rc in zip(self.saved[5:],
                                                       self.RECURRENT)]
        for name, fn in zip(self.NAMES, (seq_gather, moe_layer, vocab_slice,
                                         split_logz, heads_attn, *blocks)):
            setattr(lm, name, fn)
        return self.n

    def __exit__(self, *exc):
        for name, fn in zip(self.NAMES, self.saved):
            setattr(self.lm, name, fn)


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


def mesh_check_fp32(arch, mesh, dev, strict: bool = True, overrides=None,
                    prompt=None) -> dict:
    """Phase (a), one config cut to 2 layers (or as ``overrides`` say) in
    float32 with TF32 off: MESH_TRAIN_STEPS train steps at TRAIN_CHECK's
    shape, then prefill (MESH_SERVE's prompt, or ``prompt`` tokens, and the
    frontend's stub) and MESH_SERVE's decode steps, through the mesh's
    steps against the single-device steps on the same card, at MESH_TOL.
    Not ``strict`` (a
    mesh of several cards, whose sums run in other orders): losses and
    logits at MULTI_CARD_TOL, and every param within Adam's bound of 2 x lr
    a step of one device's (Adam turns a last-bit gradient difference into
    a full step where |g| is near eps; tests/test_torch_mesh.py holds the
    rest tighter); the largest error and its leaf are recorded."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.executor import _full_fp32
    from repro_torch.models import lm
    from repro_torch.nn.layers import leaves
    from repro_torch.parallel.sharding import is_dtensor
    from repro_torch.train import serve
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.trainer import (TrainOptions, init_train_state,
                                           make_train_step)
    c = TRAIN_CHECK
    cfg = dataclasses.replace(get_config(arch), **{
        "n_layers": c["n_layers"], "dtype": "float32",
        "attn_chunk": c["attn_chunk"], **(overrides or {})})
    ocfg = OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    batches = [_train_batch(cfg, c["batch"], c["seq"], i)
               for i in range(MESH_TRAIN_STEPS)]
    rec = dict(arch=cfg.name, family=cfg.family, n_layers=cfg.n_layers,
               kinds=[list(pat) for pat, _ in lm.pattern_stacks(cfg)],
               dtype="float32", batch=c["batch"], seq=c["seq"], tol=MESH_TOL,
               allocated_before_gb=release())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _full_fp32():
        step = make_train_step(cfg, ocfg, TrainOptions(), device=dev)
        params, state = init_train_state(cfg, 0, device=dev)
        single = []
        for b in batches:
            params, state, m = step(params, state, b)
            single.append(float(m["loss"]))
        del state
        mstep = make_train_step(cfg, ocfg, TrainOptions(), mesh=mesh)
        mp, ms = init_train_state(cfg, 0, mesh=mesh, rules=mstep.rules)
        got = []
        with split_calls() as train_splits:
            for b in batches:
                mp, ms, m = mstep(mp, ms, b)
                got.append(float(m["loss"]))
        del ms
        from repro_torch.ckpt.checkpoint import _flatten
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(got, single))
        errs = {key: (_rel_err(a.full_tensor(), b), float(
            (a.full_tensor() - b).abs().max()))
                for (key, a), b in zip(_flatten(mp).items(), leaves(params))}
        worst = max(errs, key=lambda k: errs[k][0])
        param_err = errs[worst][0]
        abs_err = max(e[1] for e in errs.values())
        rec.update(param_worst_leaf=worst, param_abs_err=abs_err,
                   adam_bound=2 * ocfg.lr * MESH_TRAIN_STEPS)
        if not all(is_dtensor(t) for t in leaves(mp)):
            raise AssertionError(f"mesh {arch}: params left the mesh")
        del mp, params
        torch.cuda.empty_cache()
        rec.update(train_losses=got, single_losses=single,
                   loss_rel_err=loss_err, param_rel_err=param_err)
        tol = MESH_TOL if strict else MULTI_CARD_TOL
        # written so that a NaN (a loss, a param) fails the check
        if not (all(math.isfinite(x) for x in got + single)
                and loss_err <= tol and (param_err <= tol if strict else
                                         abs_err <= rec["adam_bound"])):
            raise AssertionError(f"mesh {arch} train: losses {got} vs "
                                 f"{single}, params {param_err}")
        # prefill + decode steps: mesh against one device
        sv = MESH_SERVE
        b, s, n = sv["batch"], prompt or sv["prompt"], sv["decode_steps"]
        prefix = cfg.n_patches if cfg.family == "vlm" else 0
        max_seq = prefix + s + n + 1
        rng = np.random.default_rng(1)
        inputs = _family_inputs(cfg, b, s, rng, dev)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                             (n, b, 1))).to(dev)
        outs = {}
        for kind in ("single", "mesh"):
            if kind == "single":
                p = lm.init_model(cfg, 0, device=dev)
                cache = lm.init_cache(cfg, b, max_seq, device=dev)
                kw = dict(device=dev)
            else:
                rules = serve.serve_rules(mesh)
                p = serve.init_serve_params(cfg, rules, 0)
                cache = serve.place_cache(cfg, rules, b, max_seq)
                kw = dict(mesh=mesh)
            pre = serve.make_prefill_step(cfg, b, max_seq, **kw)
            de = serve.make_decode_step(cfg, b, max_seq, **kw)
            with split_calls() as serve_splits:
                lg, cache = pre(p, cache, inputs)
                seq = [lg]
                for i in range(n):
                    lg, cache = de(p, cache, toks[i])
                    seq.append(lg)
            outs[kind] = [x.full_tensor() if is_dtensor(x) else x
                          for x in seq]
            del p, cache
        logit_err = max(_rel_err(a, b) for a, b in zip(outs["mesh"],
                                                       outs["single"]))
        rec.update(serve_batch=b, prompt=s, prefix=prefix, max_seq=max_seq,
                   decode_steps=n, logits_rel_err=logit_err,
                   splits=dict(train=train_splits, serve=serve_splits))
        if not logit_err <= tol:
            raise AssertionError(f"mesh {arch} serve: logits differ by "
                                 f"{logit_err} of the largest")
        # the split paths ran: sequence-parallel attention in train and
        # prefill (every family but the ssm), the routed experts split
        # over the model axis (moe), the embedding and the LM head in
        # their vocabulary slice, the loss's log-sum-exp split (train),
        # decode's attention split by heads (serve, every family but the
        # ssm), the recurrences on their channel slices (hybrid: the
        # RG-LRU; ssm: the mLSTM and, where the config holds one, the
        # sLSTM's up/down)
        kinds = {k for pat, _ in lm.pattern_stacks(cfg) for k in pat}
        for mode, n_calls in rec["splits"].items():
            want = dict(seq_gathers=cfg.family != "ssm",
                        expert_splits=cfg.family == "moe",
                        vocab_embeds=True, vocab_heads=True,
                        vocab_losses=mode == "train",
                        head_splits=mode == "serve" and cfg.family != "ssm",
                        rglru_splits="rec" in kinds,
                        mlstm_splits="mlstm" in kinds,
                        slstm_splits="slstm" in kinds)
            if any(bool(n_calls[k]) != v for k, v in want.items()):
                raise AssertionError(f"mesh {arch} {mode}: split calls "
                                     f"{n_calls}, want {want}")
    torch.cuda.synchronize()
    rec.update(seconds=time.perf_counter() - t0,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               allocated_after_gb=release())
    return rec


def mesh_train_bf16(mesh, dev, single=None, n_layers=None) -> dict:
    """Phase (b): TRAIN_BF16's qwen3-14b cut (or ``n_layers``), through
    train_loop(mesh=): ms a step after the warm-up steps, tokens/s, peak
    memory, beside the single-device ``train`` (b) of the same run where
    given."""
    import dataclasses
    import math as m_

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_loop
    c = TRAIN_BF16
    cfg = dataclasses.replace(get_config("qwen3-14b"),
                              n_layers=n_layers or c["n_layers"], remat=True,
                              remat_policy="full", attn_chunk=c["attn_chunk"])
    before = release()
    torch.cuda.reset_peak_memory_stats()
    marks, metrics = [], []

    def on_step(i, m):
        marks.append(time.perf_counter())
        metrics.append(m)

    t0 = time.perf_counter()
    losses = train_loop(cfg, steps=c["steps"], batch=c["batch"],
                        seq=c["seq"], ckpt_dir=None, mesh=mesh, lr=c["lr"],
                        log_every=100, on_step=on_step)[2]
    loop_s = time.perf_counter() - t0
    if len(losses) != c["steps"] or not all(
            m_.isfinite(m["loss"]) and m_.isfinite(m["grad_norm"])
            for m in metrics):
        raise AssertionError(f"mesh train bf16: losses {losses}")
    timed = [b - a for a, b in zip(marks[c["warmup"]:],
                                   marks[c["warmup"] + 1:])]
    step_ms = sum(timed) / len(timed) * 1e3
    rec = dict(arch=cfg.name, n_layers=cfg.n_layers, dtype=cfg.dtype,
               batch=c["batch"], seq=c["seq"], steps=c["steps"],
               loop_s=loop_s, ms_per_step=step_ms,
               step_ms=[x * 1e3 for x in timed],
               tokens_per_s=c["batch"] * c["seq"] / step_ms * 1e3,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               losses=losses, allocated_before_gb=before,
               allocated_after_gb=release())
    if single is not None:
        rec.update(single_ms_per_step=single["ms_per_step"],
                   single_peak_memory_gb=single["peak_memory_gb"],
                   mesh_overhead=step_ms / single["ms_per_step"] - 1,
                   single_losses=single["losses"])
    return rec


def mesh_serve(mesh, dev, single=None) -> tuple[dict, dict]:
    """Phase (c): qwen3-14b at full width and depth in bf16 through the
    mesh's prefill and decode steps (LM_BATCH x LM_PROMPT, LM_TOKENS greedy
    steps, the last LM_PROFILED_STEPS traced), every decode attention the
    kernel's log-sum-exp output and its merge: decode_attn must launch once
    a layer a step and no other kernel at all.  Beside ``lm_serve``'s
    record of the same run where given.  Returns the record and layer 0's
    live local cache."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.parallel.sharding import local
    from repro_torch.train import serve
    cfg = get_config(LM_ARCH)
    b, s, n = LM_BATCH, LM_PROMPT, LM_TOKENS
    max_seq = s + n + 1
    before = release()
    torch.cuda.reset_peak_memory_stats()
    rules = serve.serve_rules(mesh)
    params = serve.init_serve_params(cfg, rules, 0)
    cache = serve.place_cache(cfg, rules, b, max_seq)
    prefill = serve.make_prefill_step(cfg, b, max_seq, mesh=mesh)
    decode = serve.make_decode_step(cfg, b, max_seq, mesh=mesh)
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, s))).to(dev)
    prefill(params, cache, prompts)           # warm-up; refilled below
    torch.cuda.synchronize()
    wrappers = counters()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    logits, cache = prefill(params, cache, prompts)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    gen, lengths = [torch.argmax(logits.to_local(), -1)[:, None]], []

    def step():
        lengths.append(min(cache["pos"] + 1, max_seq))
        out, _ = decode(params, cache, gen[-1])
        gen.append(torch.argmax(out.to_local(), -1)[:, None])
        return out

    timed = n - LM_PROFILED_STEPS
    t0 = time.perf_counter()
    for _ in range(timed):
        step()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    events, wall_us, logits = trace_calls(step, LM_PROFILED_STEPS)
    launches = {name: fn.launches for name, fn in wrappers.items()}
    expect = {name: 0 for name in wrappers}
    expect["decode_attn"] = n * cfg.n_layers
    if launches != expect:
        raise AssertionError(f"mesh LM path launched {launches}, expected "
                             f"{expect}")
    full = logits.full_tensor()
    if not bool(torch.isfinite(full).all()) or full.shape != (
            b, cfg.padded_vocab):
        raise AssertionError(f"mesh LM logits {tuple(full.shape)} not "
                             f"finite")
    attn_us = [us for name, us in events if "decode_attn_" in name]
    kpl = wrappers["decode_attn"].kernels_per_launch
    busy_us = sum(us for _, us in events)
    step_ms = decode_s * 1e3 / timed
    rec = dict(phase="c", arch=cfg.name, n_layers=cfg.n_layers,
               dtype=cfg.dtype, batch=b, prompt=s, decode_steps=n,
               prefill_ms=prefill_ms, decode_ms_per_step=step_ms,
               tokens_per_s=b / step_ms * 1e3, launches=launches,
               profiled_steps=LM_PROFILED_STEPS,
               device_busy_share=busy_us / wall_us,
               device_idle_share=1 - busy_us / wall_us,
               decode_attn_in_path_ms=(sum(attn_us) / len(attn_us) * kpl
                                       / 1e3) if attn_us else None,
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
               allocated_before_gb=before,
               first_tokens=torch.cat(gen, 1)[0, :8].tolist())
    if single is not None:
        rec.update(single_prefill_ms=single["prefill_ms"],
                   single_decode_ms_per_step=single["decode_ms_per_step"],
                   single_first_tokens=single["first_tokens"])
    blk = cache["stacks"][0]["0_attn"]
    live = dict(k=local(blk["k"])[0].clone(), v=local(blk["v"])[0].clone(),
                pos=cache["pos"], lengths=lengths, cfg=cfg,
                item=local(blk["k"]).element_size(), launches=n * cfg.n_layers,
                in_path_ms=rec["decode_attn_in_path_ms"])
    del params, cache
    torch.cuda.empty_cache()
    return rec, live


def decode_attn_lse_case(cfg, ck, cv, n_valid: int, label: str,
                         dev) -> dict:
    """The log-sum-exp output of flash-decode on a live local cache of a
    mesh serve (layer 0's ``ck``, ``cv``, its first ``n_valid`` slots; bf16
    q as the path launches it) against its plain version: output at rtol
    2e-2 and an atol of 2e-2 x the plain output's largest magnitude, lse at
    rtol 1e-5 and atol 1e-4; timed as ``decode_attn_case`` times it."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attn.decode_attn import decode_attn
    from repro_torch.kernels.decode_attn.ops import (flash_decode,
                                                     flash_decode_ref)
    b, k_, g, hd = (LM_BATCH, cfg.n_kv_heads, cfg.q_groups,
                    cfg.resolved_head_dim)
    s = ck.shape[1]
    q = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (b, 1, k_, g, hd)).astype(np.float32)).to(dev, ck.dtype)
    lens = torch.full((b,), n_valid, dtype=torch.int32, device=dev)
    before = decode_attn.launches
    out, lse = flash_decode(q, ck, cv, lens, return_lse=True)
    e_out, e_lse = flash_decode_ref(q, ck, cv, lens, return_lse=True)
    torch.cuda.synchronize()
    decode_attn.launches = before
    err = float((out - e_out).abs().max())
    lse_err = float((lse - e_lse).abs().max())
    plain_max = float(e_out.abs().max())
    if out.dtype != torch.float32 or not torch.allclose(
            out, e_out, rtol=DECODE_BF16_REL,
            atol=DECODE_BF16_REL * plain_max) or not torch.allclose(
            lse, e_lse, rtol=1e-5, atol=1e-4):
        raise AssertionError(f"decode_attn lse: out err {err}, lse err "
                             f"{lse_err}")
    qh = q[:, 0].reshape(b, k_ * g, 1, hd)
    kh, vh = (t.transpose(1, 2).contiguous() for t in (ck, cv))
    mask = (torch.arange(s, device=dev)[None, :]
            < lens[:, None])[:, None, None, :]
    slots = float(n_valid) * b * k_
    n_bytes = (2 * slots * hd * 2 + b * k_ * g * hd * (2 + 4)
               + b * k_ * g * 4 + 4 * b)
    bound, by = bound_ms(n_bytes, 4.0 * slots * g * hd, PEAK_BF16_OPS_S)
    call = lambda: flash_decode(q, ck, cv, lens, return_lse=True)  # noqa
    rec = dict(kernel="decode_attn", shape=label, cache="self",
               on_path=True, B=b, S=s, K=k_, G=g, hd=hd,
               q_dtype=str(q.dtype), cache_dtype=str(ck.dtype),
               lengths=[n_valid] * 2, max_abs_err=err,
               lse_max_abs_err=lse_err, plain_max_abs=plain_max,
               device_ms=kernel_device_ms(call, "decode_attn_",
                                          decode_attn.kernels_per_launch),
               event_ms=time_ms(call, 20),
               plain_ms=time_ms(lambda: flash_decode_ref(
                   q, ck, cv, lens, return_lse=True), 5, warmup=1),
               library="F.scaled_dot_product_attention(enable_gqa=True)",
               library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                   qh, kh, vh, attn_mask=mask, enable_gqa=True), 20),
               bound_ms=bound, bound_by=by)
    decode_attn.launches = before
    rec["roofline_share"] = bound / (rec["device_ms"] or rec["event_ms"])
    print(f"kernel {json.dumps(rec)}")
    return rec


def mesh_attn_run(live, case) -> dict:
    """decode_attn's numbers over the mesh serve's launches, as
    ``decode_attn_line`` sums them."""
    cfg = live["cfg"]
    n = live["launches"]
    item = live["item"]
    slots = [float(ln) * LM_BATCH * cfg.n_kv_heads for ln in live["lengths"]]
    hd, g = cfg.resolved_head_dim, cfg.q_groups
    per = LM_BATCH * cfg.n_kv_heads * g
    bound = sum(bound_ms(2 * sl * hd * item + per * hd * (item + 4)
                         + per * 4 + 4 * LM_BATCH, 4.0 * sl * g * hd,
                         PEAK_BF16_OPS_S)[0]
                for sl in slots) * cfg.n_layers
    per_launch = case["device_ms"] or case["event_ms"]
    return dict(launches=n, ms=n * per_launch, plain_ms=n * case["plain_ms"],
                bound_ms=bound, library_ms=n * case["library_ms"],
                in_path_ms=n * (live["in_path_ms"] or per_launch),
                max_abs_err=case["max_abs_err"])


def mesh_phase(dev, card: str, train_single=None, serve_single=None,
               family_single=None) -> tuple[dict, dict]:
    """The mesh on torch.distributed: an in-process NCCL group of one rank,
    a (1,1,1) ("pod", "data", "model") mesh; (a) float32 checks of both
    mesh configs, (b) bf16 training through train_loop(mesh=), (c) the
    full-depth bf16 serve through the mesh's steps, and the kernel's
    log-sum-exp output at the live shape; then the hybrid, ssm, audio and
    vlm families (MESH_FAMILY_CHECKS, ``mesh_family`` lines), their bf16
    serves beside ``family_single`` (arch -> the same run's single-device
    ``family_serve`` record).  Returns the summary and decode_attn's
    numbers over each mesh serve, by path."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh(MESH_SHAPE, MESH_AXES)
        checks = [mesh_check_fp32(arch, mesh, dev) for arch in MESH_ARCHS]
        for rec in checks:
            print(f"mesh_check {json.dumps(dict(phase='a', **rec))}")
        train = mesh_train_bf16(mesh, dev, train_single)
        print(f"mesh_train {json.dumps(dict(phase='b', **train))}")
        srv, live = mesh_serve(mesh, dev, serve_single)
        print(f"mesh_serve {json.dumps(srv)}")
        case = decode_attn_lse_case(live["cfg"], live["k"], live["v"],
                                    live["pos"], "mesh live cache, layer 0, "
                                    "lse output", dev)
        runs = {"mesh_decode": mesh_attn_run(live, case)}
        del live
        torch.cuda.empty_cache()
        fam_checks, fam_serves, fam_cases = [], [], []
        for arch, overrides, prompt in MESH_FAMILY_CHECKS:
            rec = mesh_check_fp32(arch, mesh, dev, overrides=overrides,
                                  prompt=prompt)
            fam_checks.append(rec)
            print(f"mesh_family {json.dumps(dict(phase='a', **rec))}")
        on_mesh = {a for a, _, _ in MESH_FAMILY_CHECKS}
        for arch, n_layers, s, n in FAMILY_SERVES:
            if arch not in on_mesh:
                continue
            # the single-device serve of lm_families_phase, or (the phase
            # run alone) one made here
            single = (family_single or {}).get(arch) or family_serve(
                arch, n_layers, s, n, dev)[0]
            release()
            rec, live = family_serve(arch, n_layers, s, n, dev, mesh=mesh,
                                     single=single)
            fam_serves.append(rec)
            if "self" in live:
                cases = family_kernel_cases(rec, live, dev, lse=True)
                fam_cases += cases
                runs[f"mesh_family/{arch}"] = family_attn_totals(
                    rec, live["cfg"], cases)
            del live
            release()
    finally:
        dist.destroy_process_group()
    summary = dict(seconds=time.perf_counter() - t0, world=1,
                   mesh=dict(zip(MESH_AXES, MESH_SHAPE)),
                   peak_memory_gb=max(r["peak_memory_gb"] for r in
                                      (*checks, train, srv, *fam_checks,
                                       *fam_serves)),
                   decode_attn_launches={k: r["launches"]
                                         for k, r in runs.items()},
                   card=card)
    print(f"mesh {json.dumps(summary)}")
    if summary["seconds"] > MESH_PHASE_LIMIT_S:
        print(f"mesh: the phase took {summary['seconds']:.1f} s, more than "
              f"its {MESH_PHASE_LIMIT_S} s budget", file=sys.stderr)
    return dict(checks=checks, train=train, serve=srv, lse_case=case,
                family_checks=fam_checks, family_serves=fam_serves,
                family_cases=fam_cases, **summary), runs


# world-1 mesh serves timed against another checkout in one call
# (``mesh_ab``): (arch, decoder prompt, decode steps, steps not timed)
AB_SERVES = (("recurrentgemma-9b", LM_PROMPT, 18, 2),
             ("xlstm-1.3b", LM_PROMPT, 18, 2))
AB_ORDER = ("parent", "change", "change", "parent")
AB_TIMEOUT_S = 900


def mesh_serve_times() -> list[dict]:
    """The recurrent families' world-1 mesh serves (AB_SERVES) on an
    in-process NCCL group of one rank and a (1,1,1) mesh, bf16 at full
    width and depth (seed 0), LM_BATCH prompts: the timed prefill after a
    warm-up prefill, then greedy decode steps, the last ones timed
    together; a ``mesh_ab_serve`` line each.  It calls the serve steps'
    entry points alone, so it times whichever checkout's ``src`` comes
    first on ``sys.path``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import local
    from repro_torch.train import serve
    dev = "cuda"
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", rank=0, world_size=1)
    recs = []
    try:
        mesh = make_mesh(MESH_SHAPE, MESH_AXES)
        rules = serve.serve_rules(mesh)
        for arch, s, n, warm in AB_SERVES:
            cfg = get_config(arch)
            b, max_seq = LM_BATCH, s + n + 1
            params = serve.init_serve_params(cfg, rules, 0)
            cache = serve.place_cache(cfg, rules, b, max_seq)
            inp = _family_inputs(cfg, b, s, np.random.default_rng(0), dev)
            prefill = serve.make_prefill_step(cfg, b, max_seq, mesh=mesh)
            decode = serve.make_decode_step(cfg, b, max_seq, mesh=mesh)
            prefill(params, cache, inp)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, cache = prefill(params, cache, inp)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            tok = torch.argmax(local(logits), -1)[:, None]
            for i in range(n):
                if i == warm:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                logits, cache = decode(params, cache, tok)
                tok = torch.argmax(local(logits), -1)[:, None]
            torch.cuda.synchronize()
            rec = dict(arch=arch, batch=b, prompt=s, prefill_ms=prefill_ms,
                       decode_ms_per_step=(time.perf_counter() - t0) * 1e3
                       / (n - warm), decode_steps_timed=n - warm,
                       logits_finite=bool(torch.isfinite(
                           local(logits)).all()))
            print(f"mesh_ab_serve {json.dumps(rec)}", flush=True)
            recs.append(rec)
            del params, cache, logits
            release()
    finally:
        dist.destroy_process_group()
    return recs


def mesh_ab(parent) -> list[dict]:
    """``mesh_serve_times`` of the checkout at ``parent`` (unpacked) and
    of this one, in AB_ORDER, each in a fresh process that builds its
    checkout's kernels first; a ``mesh_ab`` line a run, beside the card's
    name and power limit.  Fails if a run fails or a logit is not
    finite."""
    card = card_line()
    roots = {"parent": Path(parent).resolve(), "change": ROOT}
    out = []
    for i, which in enumerate(AB_ORDER, 1):
        code = (f"import sys; sys.path[:0] = [{str(roots[which] / 'src')!r},"
                f" {str(ROOT)!r}]; from repro_torch.kernels import backend; "
                f"backend.build(); import chip_smoke; "
                f"chip_smoke.mesh_serve_times()")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                              capture_output=True, text=True,
                              timeout=AB_TIMEOUT_S)
        if proc.returncode != 0:
            raise AssertionError(f"mesh_ab run {i} ({which}): rc "
                                 f"{proc.returncode}\n{proc.stderr[-3000:]}")
        recs = [json.loads(line.split(" ", 1)[1])
                for line in proc.stdout.splitlines()
                if line.startswith("mesh_ab_serve ")]
        if len(recs) != len(AB_SERVES) or not all(r["logits_finite"]
                                                  for r in recs):
            raise AssertionError(f"mesh_ab run {i} ({which}): {recs}")
        for r in recs:
            print(f"mesh_ab {json.dumps(dict(run=i, tree=which, **r))}")
        out.append(dict(run=i, tree=which, seconds=time.perf_counter() - t0,
                        serves=recs))
    print(card)
    return out


def _multi_card_rank(rank, world, port, out_dir):
    """One NCCL rank of ``mesh_multi_card``."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import make_mesh
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh((world // 2, 2), ("data", "model"))
        checks = [mesh_check_fp32(arch, mesh, "cuda", strict=False)
                  for arch in MESH_ARCHS]
        train = mesh_train_bf16(mesh, "cuda", n_layers=MULTI_CARD_LAYERS)
        if rank == 0:
            rec = dict(world=world, mesh=[world // 2, 2], checks=checks,
                       train=train, card=card_line())
            (Path(out_dir) / "mesh_multi_card.json").write_text(
                json.dumps(rec, indent=1))
            print(f"mesh_multi_card {json.dumps(rec)}")
    finally:
        dist.destroy_process_group()


# qwen3-14b layers of the multi-card bf16 run: training state is 12 bytes a
# parameter; on a (2, 2) mesh every large leaf is split 4 ways, so 40
# layers (14.77 B parameters, 177 GB of state) hold 44 GB a card, plus one
# layer's gathered params and the local rows' activations and logits
MULTI_CARD_LAYERS = 40
MULTI_CARD_TOL = 1e-5


def mesh_multi_card(world: int) -> None:
    """The mesh on ``world`` cards, one spawned NCCL rank a card, a
    (world // 2, 2) ("data", "model") mesh: phase (a) of the mesh phase,
    then MULTI_CARD_LAYERS of qwen3-14b through train_loop(mesh=).  Not
    called by main(); run as
    ``python3 -c "import chip_smoke as c; c.mesh_multi_card(4)"``.  Writes
    ``chiprun_out/mesh_multi_card.json``."""
    import torch
    import torch.multiprocessing as mp
    if torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks need {world} cards, the machine "
                           f"has {torch.cuda.device_count()}")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import backend
    backend.build()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    mp.start_processes(_multi_card_rank, args=(world, free_port(),
                                               str(out_dir)),
                       nprocs=world, join=True, start_method="spawn")


# -- dry-run phase: launch/dryrun.py on fake 256- and 512-rank meshes -------

# the reference's multi-pod test archs (tests/test_distributed.py:63-83)
DRYRUN_MULTIPOD_ARCHS = ("qwen3-14b", "deepseek-moe-16b",
                         "recurrentgemma-9b", "whisper-base", "xlstm-1.3b")
DRYRUN_JOBS = 8                 # cells counted at once (the host's 8 cores)
DRYRUN_CELL_TIMEOUT_S = 600
# 60 cells of 2-50 s of fake dispatch each took 198-241 s on an H100
# host's 8 cores, not the 120 s first aimed at
DRYRUN_LIMIT_S = 300.0
# every cell's counts before the model axis split the recurrences
# (commit 6c68b88's dry-run on fake tensors, written by
# ``dryrun_baseline``)
DRYRUN_BASELINE = ROOT / "chip_smoke_dryrun_baseline.json"


def dryrun_counts(out_dir: Path, root: Path = ROOT):
    """``python -m repro_torch.launch.dryrun`` of the checkout at ``root``
    over every (arch x shape) cell on the fake 16x16 mesh and over
    DRYRUN_MULTIPOD_ARCHS' on 2x16x16 (``--multi-pod``), one cell a
    process (the fake process group is a process's default group),
    DRYRUN_JOBS at a time; their records joined in ``out_dir /
    "dryrun.jsonl"``.  Returns (cells, records, failed cells, seconds).
    Runs on the host's cores only: no process touches the card."""
    import concurrent.futures
    import os
    from repro_torch.configs import ARCHS, LM_SHAPES
    # the costly shapes (train_4k, prefill_32k) first, so that the last
    # cells to start are short ones
    cells = [(a, sh.name, multi_pod) for sh in LM_SHAPES
             for multi_pod, archs in ((False, ARCHS),
                                      (True, DRYRUN_MULTIPOD_ARCHS))
             for a in archs]
    parts = out_dir / "dryrun_parts"
    parts.mkdir(parents=True, exist_ok=True)
    for old in parts.glob("*.jsonl"):
        old.unlink()
    env = dict(os.environ, PYTHONPATH=str(root / "src"))

    def count(i, cell):
        arch, shape, multi_pod = cell
        out = parts / f"{i:03d}.jsonl"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", str(out)]
        proc = subprocess.run(cmd + ["--multi-pod"] * multi_pod, cwd=root,
                              env=env, capture_output=True, text=True,
                              timeout=DRYRUN_CELL_TIMEOUT_S)
        recs = [json.loads(ln) for ln in out.read_text().splitlines()] \
            if out.exists() else []
        return cell, proc.returncode, recs, proc.stderr[-2000:]

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(DRYRUN_JOBS) as pool:
        results = list(pool.map(count, range(len(cells)), cells))
    seconds = time.perf_counter() - t0
    recs, bad = [], []
    for cell, rc, got, err in results:
        recs += got
        if rc != 0 or len(got) != 1 or got[0]["status"] not in ("ok",
                                                                "skipped"):
            bad.append((cell, rc, got, err))
    (out_dir / "dryrun.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in recs))
    return cells, recs, bad, seconds


def dryrun_baseline(root: Path, out: Path, what: str) -> None:
    """Writes ``out``, a DRYRUN_BASELINE of the checkout at ``root`` (the
    parent commit's, unpacked): each ok cell's FLOPs, useful fraction and
    collective bytes summed over kinds, beside ``what`` says whence.  The
    counts are made on fake tensors and are the same on any host."""
    _, recs, bad, _ = dryrun_counts(out.parent / "baseline_counts", root)
    if bad:
        raise AssertionError(f"dry-run of {root}: {len(bad)} cells failed")
    cells = {f"{r['arch']}/{r['shape']}@{r['mesh']}": dict(
        useful_flops_frac=r["useful_flops_frac"],
        coll_bytes=sum(r["coll_bytes"].values()), flops=r["flops"])
        for r in recs if r["status"] == "ok"}
    out.write_text(json.dumps(dict(what=what, cells=dict(sorted(
        cells.items()))), indent=1) + "\n")


def dryrun_phase(out_dir: Path) -> dict:
    """The dry-run's counts of this checkout (``dryrun_counts``) beside
    DRYRUN_BASELINE.  Prints the ``dryrun`` line: cells ok, skipped and
    failed, and seconds, and a ``dryrun_cell`` line a cell.  A failed cell,
    or one whose useful fraction fell below the baseline's, fails the
    run."""
    cells, recs, bad, seconds = dryrun_counts(out_dir)
    ok = [r for r in recs if r["status"] == "ok"]
    summary = dict(
        cells=len(cells), ok=len(ok),
        skipped=sum(r["status"] == "skipped" for r in recs),
        failed=len(bad), seconds=seconds, jobs=DRYRUN_JOBS,
        count_s_sum=sum(r["t_count_s"] for r in ok),
        count_s_max=max((r["t_count_s"] for r in ok), default=0.0),
        bottlenecks={b: sum(r["bottleneck"] == b for r in ok)
                     for b in ("compute", "memory", "collective")},
        useful_flops_frac={f"{r['arch']}/{r['shape']}@{r['mesh']}":
                           r["useful_flops_frac"] for r in ok})
    print(f"dryrun {json.dumps(summary)}")
    # each cell beside its baseline counts (DRYRUN_BASELINE): a cell whose
    # useful fraction fell fails the run
    base = json.loads(DRYRUN_BASELINE.read_text())["cells"]
    fell = []
    for r in ok:
        key = f"{r['arch']}/{r['shape']}@{r['mesh']}"
        was = base.get(key)
        cell = dict(cell=key, useful=r["useful_flops_frac"],
                    useful_before=was and was["useful_flops_frac"],
                    coll_gb=sum(r["coll_bytes"].values()) / 1e9,
                    coll_gb_before=was and was["coll_bytes"] / 1e9,
                    tflop=r["flops"] / 1e12,
                    tflop_before=was and was["flops"] / 1e12)
        if was:
            cell["useful_x"] = r["useful_flops_frac"] / was[
                "useful_flops_frac"]
            if r["useful_flops_frac"] < was["useful_flops_frac"]:
                fell.append(key)
        print(f"dryrun_cell {json.dumps(cell)}")
    summary["below_baseline"] = fell
    if bad:
        raise AssertionError(f"dry-run: {len(bad)} cells failed, the first "
                             f"{bad[0][:3]}:\n{bad[0][3]}")
    if fell or len(ok) != len(base):
        raise AssertionError(f"dry-run: {len(ok)} cells counted against "
                             f"{len(base)} before; useful fraction fell "
                             f"in {fell}")
    if seconds > DRYRUN_LIMIT_S:
        print(f"dryrun: the phase took {seconds:.1f} s, more than its "
              f"{DRYRUN_LIMIT_S} s budget", file=sys.stderr)
    return summary


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    import numpy as np
    from repro_torch.api import Session
    from repro_torch.core import split_model
    from repro_torch.kernels import backend
    from repro_torch.models import mobilenet_v2_paper
    from torch_launches import engine_launches

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
    paths, runs = [], {}
    for mode in ("spatial", "kernel", "neuron"):
        rec, calls = serve_path(mode, model, qmodel, xs, dev)
        paths.append(rec)
        runs[mode] = engine_launches(calls)
    del calls
    # EfficientNet-B0: the 5x5 and squeeze-and-excitation kernels
    eff_paths, eff_runs = effnet_phase(dev)
    paths += eff_paths
    runs.update(eff_runs)
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

    # the multi-tenant server over two full-width tenants, and a flat
    # depthwise layer over more shards than one launch takes
    serving, serving_runs = serving_phase(model, dev)
    runs.update(serving_runs)
    many = dw_many_shards(dev)

    recs = kernel_phase(runs, dev)
    # printed: the spatial plan's named layers, the flat plans' b1_dw
    # shards and the off-path yardsticks; every shape is in the JSON file
    named = {"stem", "b1_expand", "b16_project", "head_conv", "classifier",
             "b1_dw", "b14_dw"}
    engine_recs = [r for r in recs if "engine" in r["path"]]
    for r in recs:
        layers = {n for lyr in r["layers"] for n in lyr.split("..")}
        if not r["on_path"] or named & layers and (
                "spatial" in r["per_run"] or "b1_dw" in layers) and (
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
                 f"c{sch.get('c_tile', '-')}"
                 if r["kernel"].startswith(("se_", "band_"))
                 else f"c{sch['c_tile']} r{sch['rows_tile']} "
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
             distributed=dists, elastic=elastic, serving=serving,
             dw_many_shards=many), indent=1))

    # the LM serving path: (a) fp32 check, (b) bf16 run at full depth,
    # (c) the flash-decode kernel on the live cache and a yardstick shape
    torch.cuda.empty_cache()
    lm_check_fp32(dev)
    serve, live = lm_serve(dev)
    torch.cuda.empty_cache()
    attn_recs = lm_kernel_phase(live, dev)
    # the other five families: (a) fp32 checks, (b) bf16 serves, (c)
    # flash-decode at each family's live shapes
    t_fam = time.perf_counter()
    fam_recs, fam_cases, fam_totals = lm_families_phase(dev)
    fam_summary = dict(seconds=time.perf_counter() - t_fam,
                       peak_memory_gb=max(r.get("peak_memory_gb", 0)
                                          for r in fam_recs))
    print(f"lm_families {json.dumps(fam_summary)}")
    (out_dir / "chip_smoke_lm.json").write_text(json.dumps(
        dict(card=card, serve=serve, decode_attn=attn_recs,
             families=fam_recs, family_decode_attn=fam_cases,
             family_totals=fam_totals), indent=1))

    # the training path: (a) float32 checks, (b) bf16 training of qwen3-14b
    # at full width and cut depth, (c) the example's model
    torch.cuda.empty_cache()
    train = train_phase(dev, out_dir, card)
    (out_dir / "chip_smoke_train.json").write_text(json.dumps(train,
                                                              indent=1))

    # the mesh on torch.distributed: one NCCL rank, a (1,1,1) mesh; (a)
    # float32 checks, (b) bf16 training, (c) the full-depth bf16 serve with
    # decode_attn's log-sum-exp output on the seq-sharded cache
    torch.cuda.empty_cache()
    family_single = {r["arch"]: r for r in fam_recs if r["phase"] == "b"}
    mesh, mesh_runs = mesh_phase(dev, card, train["bf16"], serve,
                                 family_single)
    (out_dir / "chip_smoke_mesh.json").write_text(json.dumps(mesh, indent=1))

    # the dry-run: every cell counted on a fake 256- and 512-rank mesh, in
    # processes of their own (CPU only)
    dryrun_phase(out_dir)

    source = {name: "src/repro_torch/csrc/" + (
        "qgemm.cu" if name == "qgemm" else
        "se.cu" if name.startswith("se_") else
        "bands.cu" if name.startswith("band_") else "dwconv.cu")
        for name in CNN_WRAPPERS}
    # the reference's kernels each replaces (it has no EfficientNet)
    replaces = {"qgemm": "src/repro/kernels/qgemm/qgemm.py:63",
                "dwconv3x3_bands": "src/repro/kernels/dwconv/dwconv.py:133",
                "dwconv3x3": "src/repro/kernels/dwconv/dwconv.py:96"}
    # each kernel's numbers cover the launches of every counted run (the
    # three engine plans of each network, the in-process distributed run):
    # launches from the plans' recorded walks, held against the traces,
    # each time the sum over those launches of its per-launch time at the
    # launch's own shape
    counted = [p["mode"] for p in paths]
    line = []
    for name in CNN_WRAPPERS:
        fwd = {run: per_run(recs, name, run) for run in counted}
        for p in paths:
            if fwd[p["mode"]]["launches"] != p["launches"].get(name, 0):
                raise AssertionError(f"{name}: {p['mode']} counts differ")
            print("forward " + json.dumps(dict(kernel=name, mode=p["mode"],
                                               **fwd[p["mode"]])))
        # one forward of each tenant at each bucket it dispatched (not in
        # the sums below: the serving run's launches are counted apart)
        for run in serving_runs:
            tot = per_run(recs, name, run)
            if tot["launches"]:
                print("forward " + json.dumps(dict(kernel=name, mode=run,
                                                   **tot)))
        rows = [r for r in recs if r["kernel"] == name and r["on_path"]]
        by_bytes = sum(r["bound_ms"] * sum(r["per_run"].get(run, 0)
                                           for run in counted)
                       for r in rows if r["bound_by"] == "bytes")
        line.append(dict(
            name=name, route="cuda", source=source[name],
            replaces=replaces.get(name),
            launches=sum(p["launches"].get(name, 0) for p in paths),
            max_abs_err=max(r["max_abs_err"] for r in rows),
            **{key: sum(f[key] for f in fwd.values())
               for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
            bound_by=("bytes" if 2 * by_bytes >= sum(f["bound_ms"] for f in
                                                    fwd.values())
                      else "operations"),
            ms_from="profiler" if all(r["device_ms"] is not None
                                      for r in rows) else "events",
            launches_by_path={p["mode"]: p["launches"].get(name, 0)
                              for p in paths},
            serving_launches=serving["launches"].get(name, 0)))
    line.append(decode_attn_line(serve, live, attn_recs,
                                 {**fam_totals, **mesh_runs}))
    print(json.dumps({"kernels": line}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
