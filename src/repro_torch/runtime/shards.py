"""Per-worker shard payloads and segment compilation for the distributed
runtime — port of ``repro/runtime/shards.py``.

Three host-side views of one :class:`~repro_torch.core.splitting.SplitPlan`
live here, all derived from the same compiled geometry the single-process
executors use (``mapping.compile_shard_geometry`` /
``splitting.spatial_band_geometry``):

* :func:`build_worker_setup` — the setup frame shipped to one worker at
  attach time: plain-JSON segment specs plus the weight fragments (int8
  ``w_q`` / int32 epilogue bias / f32 scale in int8 mode, f32 weights in
  float mode).  A worker only ever receives the fragments its own shards
  touch (spatial bands replicate full block weights, exactly as the plan's
  ``weight_bytes`` accounting says).  A copy of the reference's, byte for
  byte: a port coordinator can set up reference workers and the other way
  round.

* :func:`build_segment_fns` — the worker-side half, written in torch: lower
  each received segment spec into one function over the routed input
  slice, its constants uploaded once to the worker's device.  The bodies
  run the single-process engine's kernel wrappers (``qconv2d`` /
  ``qgemm``, ``dwconv_window``) with the multiply-only epilogue fused, so
  distributed int8 output is bit-identical to the eager oracle and the
  compiled ``Session`` — the runtime's correctness contract.

* :func:`build_coordinator_plan` — the coordinator-side routing table: per
  block group, which workers are active, how to slice the current activation
  into each worker's download, how to place uploads back into the output
  buffer (row bands / flat ranges), the residual/stash bookkeeping that
  stays coordinator-side (Alg. 4 line 9), and the boundary dependency
  structure (exact ``pipelined_dependencies`` row-overlap deps for clean
  spatial seams, a barrier everywhere else) realized by the per-link queues
  in ``runtime.coordinator``.

Everything but :func:`build_segment_fns` is a numpy copy of the
reference's; ``tests/test_torch_runtime.py`` pins the payloads, the
routing tables and the segment outputs to it.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..core.executor import _conv_chw, _full_fp32, resolve_device
from ..core.fusion import apply_activation
from ..core.mapping import compile_shard_geometry
from ..core.quantize import QuantizedModel, epilogue_params, requantize
from ..core.simulator import _segments, pipelined_dependencies
from ..core.splitting import SplitPlan, spatial_band_geometry
from ..kernels.dwconv.ops import dwconv_window
from ..kernels.qgemm.ops import qconv2d
from ..kernels.qgemm.qgemm import qgemm

PRECISIONS = ("int8", "float")


def _check_precision(precision: str) -> bool:
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r} "
                         f"(want one of {PRECISIONS})")
    return precision == "int8"


def _array_fp(a: np.ndarray) -> str:
    """Content fingerprint of one wire array (dtype + shape + bytes)."""
    h = hashlib.sha256()
    h.update(str(a.dtype).encode())
    h.update(repr(tuple(a.shape)).encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def _array_role(key: str) -> str:
    """Wire key with the group index stripped (``w3_1`` -> ``w_1``,
    ``b7`` -> ``b``): array identity is content + role, never group
    numbering, so a segment that lands at a different ``gi`` after a replan
    still fingerprints identically."""
    prefix, rest = key[0], key[1:]
    if "_" in rest:
        return prefix + "_" + rest.split("_", 1)[1]
    return prefix


def _fingerprint_spec(spec: dict, arrays: dict[str, np.ndarray],
                      keys: list[str]) -> None:
    """Annotate one segment spec in place with content fingerprints.

    ``array_fps`` maps each wire array key to its content fingerprint (the
    unit of re-ship avoidance: a worker that already holds the bytes is not
    sent them again); ``fingerprint`` hashes the spec minus its group index
    plus the array contents — the unit of warm recompilation: an identical
    fingerprint means the jitted segment function can be reused verbatim.
    """
    spec["array_fps"] = {k: _array_fp(arrays[k]) for k in keys}
    clean = {k: v for k, v in spec.items()
             if k not in ("gi", "array_fps", "fingerprint")}
    h = hashlib.sha256(json.dumps(clean, sort_keys=True).encode())
    for k in sorted(keys, key=_array_role):
        h.update(_array_role(k).encode())
        h.update(spec["array_fps"][k].encode())
    spec["fingerprint"] = h.hexdigest()[:16]


def setup_array_bytes(arrays: dict[str, np.ndarray]) -> int:
    """Total payload bytes of a setup frame's arrays."""
    return int(sum(a.nbytes for a in arrays.values()))


def delta_setup(meta: dict, arrays: dict[str, np.ndarray],
                held_array_fps: set[str]) -> dict[str, np.ndarray]:
    """The arrays a worker that already holds ``held_array_fps`` actually
    needs — content the worker has (by fingerprint) is dropped, and the
    worker resolves the omitted keys from its local store via the specs'
    ``array_fps``.  The meta is shipped unchanged (specs are cheap JSON)."""
    fps: dict[str, str] = {}
    for spec in meta["segments"]:
        fps.update(spec.get("array_fps", {}))
    return {k: v for k, v in arrays.items()
            if fps.get(k) not in held_array_fps}


def _layer_consts(layer, ql, int8: bool):
    """(weight, bias, scale) arrays for one layer in the wire layout."""
    if int8:
        scale, b_q = epilogue_params(ql)
        return ql.w_q, b_q, scale
    bias = (layer.bias if layer.bias is not None
            else np.zeros(layer.out_shape[0], np.float32))
    return np.asarray(layer.weight, np.float32), \
        np.asarray(bias, np.float32), None


# ---------------------------------------------------------------------------
# Worker setup payloads
# ---------------------------------------------------------------------------

def build_worker_setup(split: SplitPlan, qmodel: QuantizedModel | None,
                       precision: str, worker: int) -> tuple[dict, dict]:
    """The setup frame for one worker: ``(meta, arrays)``.

    ``meta["segments"]`` has one spec per block group of the plan, in group
    order; groups where this worker computes nothing (empty shard,
    coordinator-local layers) are ``{"kind": "skip"}``.  Arrays are keyed
    ``w{gi}_{li}`` / ``b{gi}_{li}`` / ``s{gi}_{li}`` (weight / bias /
    epilogue scale; flat groups drop the ``_li``).
    """
    int8 = _check_precision(precision)
    if int8 and qmodel is None:
        raise ValueError("precision='int8' requires a QuantizedModel")
    model = split.model
    segments: list[dict] = []
    arrays: dict[str, np.ndarray] = {}
    for gi, idxs in enumerate(split.block_groups):
        sp0 = split.splits[idxs[0]]
        if sp0.mode == "spatial":
            geoms = [spatial_band_geometry(split.splits[i].layer,
                                           split.splits[i]) for i in idxs]
            if geoms[-1][worker] is None:
                segments.append({"gi": gi, "kind": "skip"})
                continue
            g0 = geoms[0][worker]
            first_layer = model.layers[idxs[0]]
            in_rows = (g0.in_hi - g0.in_lo) if g0 is not None else 0
            stages: list[dict] = []
            seg_keys: list[str] = []
            for li, i in enumerate(idxs):
                layer = model.layers[i]
                g = geoms[li][worker]
                if g is None:
                    # degenerate interior stage (zero-height band): the next
                    # stage pads the empty band up to its window, exactly as
                    # the eager oracle's _run_block_spatial does
                    stages.append({"empty": True,
                                   "out_channels": layer.out_shape[0],
                                   "out_width": layer.out_shape[2]})
                    continue
                ql = qmodel.layers[i] if int8 else None
                w, b, s = _layer_consts(layer, ql, int8)
                arrays[f"w{gi}_{li}"] = w
                arrays[f"b{gi}_{li}"] = b
                seg_keys += [f"w{gi}_{li}", f"b{gi}_{li}"]
                stage = {"layer": i, "stride": list(layer.stride),
                         "pw": layer.padding[1],
                         "pad_top": g.pad_top, "pad_bot": g.pad_bot,
                         "activation": layer.activation}
                if int8:
                    arrays[f"s{gi}_{li}"] = s
                    seg_keys.append(f"s{gi}_{li}")
                    stage["out_scale"] = float(ql.out_scale)
                stages.append(stage)
            spec = {"gi": gi, "kind": "spatial",
                    "layer_first": idxs[0],
                    "in_shape": [first_layer.in_shape[0], in_rows,
                                 first_layer.in_shape[2]],
                    "stages": stages}
            _fingerprint_spec(spec, arrays, seg_keys)
            segments.append(spec)
            continue
        # flat group: singleton layer (conv/dwconv/linear shard, or
        # coordinator-local avgpool)
        (i,) = idxs
        layer = model.layers[i]
        shard = sp0.shard_of(worker)
        if layer.kind == "avgpool" or shard.n_positions == 0:
            segments.append({"gi": gi, "kind": "skip"})
            continue
        ql = qmodel.layers[i] if int8 else None
        w, b, s = _layer_consts(layer, ql, int8)
        if layer.kind == "linear":
            sl, e = shard.start, shard.stop
            arrays[f"w{gi}"] = w[:, sl:e]
            arrays[f"b{gi}"] = b[sl:e]
            spec = {"gi": gi, "kind": "linear", "layer_first": i,
                    "cols": [int(sl), int(e)],
                    "in_len": int(np.prod(layer.in_shape)),
                    "activation": layer.activation}
            seg_keys = [f"w{gi}", f"b{gi}"]
            if int8:
                arrays[f"s{gi}"] = s[sl:e]
                seg_keys.append(f"s{gi}")
                spec["out_scale"] = float(ql.out_scale)
            _fingerprint_spec(spec, arrays, seg_keys)
            segments.append(spec)
            continue
        geom = compile_shard_geometry(layer, sp0)[worker]
        assert geom is not None
        ph, pw = layer.padding
        c_in = layer.in_shape[0]
        n_ch_in = (geom.n_channels if layer.kind == "dwconv" else c_in)
        arrays[f"w{gi}"] = w[geom.c_lo:geom.c_hi + 1]
        arrays[f"b{gi}"] = b[geom.c_lo:geom.c_hi + 1]
        spec = {"gi": gi, "kind": "conv", "layer_first": i,
                "stride": list(layer.stride),
                "in_shape": [n_ch_in, geom.in_r1 - geom.in_r0,
                             layer.in_shape[2] + 2 * pw],
                "bbox_start": int(geom.bbox_start),
                "n_positions": int(geom.n_positions),
                "activation": layer.activation}
        seg_keys = [f"w{gi}", f"b{gi}"]
        if int8:
            # per-position epilogue scale over the shard's flat range — the
            # eager oracle requantizes the concatenated accumulator with
            # scale[flat_idx // hw]; requantization is elementwise, so each
            # worker applying its own slice commutes with the concat
            hw = layer.out_shape[1] * layer.out_shape[2]
            idx = np.arange(shard.start, shard.stop)
            arrays[f"s{gi}"] = s[idx // hw]
            seg_keys.append(f"s{gi}")
            spec["out_scale"] = float(ql.out_scale)
        _fingerprint_spec(spec, arrays, seg_keys)
        segments.append(spec)
    meta = {"precision": precision, "segments": segments}
    if int8:
        meta["input_scale"] = float(qmodel.input_scale)
    return meta, arrays


# ---------------------------------------------------------------------------
# Worker-side segment compilation
# ---------------------------------------------------------------------------

def _upload(a, device, dtype=None):
    """A C-contiguous copy of numpy ``a`` on ``device`` (frames hand out
    read-only views of their receive buffer)."""
    return torch.from_numpy(np.array(a, dtype=dtype, order="C")).to(device)


def _channel_scale(s_pos: np.ndarray, bbox_start: int, plane: int,
                   n_ch: int) -> np.ndarray:
    """Per-channel epilogue scale of a flat conv shard, recovered from the
    setup frame's per-position one: position p of the shard's range is
    bbox position ``bbox_start + p``, of local channel ``// plane`` (the
    bbox's outputs per channel).  Every position must hold its channel's
    value, and every local channel must own a position: the kernels take a
    scale per channel, and this makes a frame that breaks that loud."""
    ch = (bbox_start + np.arange(len(s_pos))) // plane
    out = np.zeros(n_ch, s_pos.dtype)
    out[ch] = s_pos
    if (not np.array_equal(out[ch], s_pos)
            or not np.array_equal(np.unique(ch), np.arange(n_ch))):
        raise ValueError("flat conv segment: the per-position scale is not "
                         "one value per local channel")
    return out


def _dw_kernel_covers(w: np.ndarray, stride) -> bool:
    """The depthwise kernel takes 3x3 taps at a square stride of 1 or 2
    over a window padded beforehand."""
    return (tuple(w.shape[2:]) == (3, 3) and stride[0] == stride[1]
            and stride[0] in (1, 2))


def _int8_conv(w, b, s, stride, c_in: int, activation, out_scale, device):
    """The int8 conv of one stage or flat shard: (C_in, R, Wp) int8, padded
    beforehand -> (C_out, oh, ow) int8, with the int32 bias ``b`` and the
    per-channel scale ``s`` fused in the kernel's epilogue.  A depthwise
    weight (``w.shape[1] != c_in``, as ``_conv_chw`` tells it) goes to
    ``dwconv_window``, any other to ``qconv2d`` (im2col + ``qgemm``).  The
    wrappers launch the CUDA kernel on a CUDA device and take the plain
    version on the CPU; a depthwise conv no kernel covers runs plain on the
    CPU only and raises here on CUDA."""
    w_t, b_t, s_t = (_upload(a, device) for a in (w, b, s))
    kw = dict(activation=activation, out_scale=out_scale)
    stride = tuple(stride)
    if w.shape[1] == c_in:
        # (Cout, Cin, kh, kw) contiguous: qconv2d's (K, N) view of it is
        # K-contiguous, as the kernel reads it (no copy a call)
        return lambda x: qconv2d(x, w_t, s_t, b_t, stride=stride, **kw)
    if _dw_kernel_covers(w, stride):
        taps = w_t[:, 0].contiguous()
        return lambda x: dwconv_window(x, taps, s_t, b_t, stride=stride[0],
                                       **kw)
    if device.type != "cpu":
        raise NotImplementedError(
            f"no CUDA kernel covers a depthwise conv with taps "
            f"{tuple(w.shape[2:])} at stride {stride}")

    def plain(x):
        acc = _conv_chw(x, w_t, stride, True) + b_t[:, None, None]
        return requantize(acc, s_t[:, None, None], out_scale, activation)
    return plain


def _float_conv(w, b, stride, activation, device):
    """The float32 conv of one stage or flat shard (padded beforehand),
    bias and activation applied."""
    w_t, b_t = _upload(w, device, np.float32), _upload(b, device, np.float32)
    stride = tuple(stride)

    def fn(x):
        acc = _conv_chw(x, w_t, stride, False) + b_t[:, None, None]
        return apply_activation(acc, activation)
    return fn


def _spatial_fn(spec, arrays, gi, int8, device):
    stages = spec["stages"]
    ops = []
    c_in = spec["in_shape"][0]
    for li, st in enumerate(stages):
        if st.get("empty"):
            ops.append(None)
            c_in = st["out_channels"]
            continue
        w, b = arrays[f"w{gi}_{li}"], arrays[f"b{gi}_{li}"]
        if int8:
            ops.append(_int8_conv(w, b, arrays[f"s{gi}_{li}"], st["stride"],
                                  c_in, st["activation"], st["out_scale"],
                                  device))
        else:
            ops.append(_float_conv(w, b, st["stride"], st["activation"],
                                   device))
        c_in = w.shape[0]
    dtype = torch.int8 if int8 else torch.float32

    def fn(x):
        band = _upload(x, device)
        for op, st in zip(ops, stages):
            if op is None:
                # a zero-height band: the next stage pads it up to its
                # window, as the eager oracle does
                band = torch.zeros((st["out_channels"], 0, st["out_width"]),
                                   dtype=dtype, device=device)
                continue
            pw = st["pw"]
            band = op(F.pad(band, (pw, pw, st["pad_top"], st["pad_bot"])))
        return band
    return fn


def _conv_fn(spec, arrays, gi, int8, device):
    w, b = arrays[f"w{gi}"], arrays[f"b{gi}"]
    stride = spec["stride"]
    o, n = spec["bbox_start"], spec["n_positions"]
    if not int8:
        op = _float_conv(w, b, stride, spec["activation"], device)
        return lambda x: op(_upload(x, device)).reshape(-1)[o:o + n]
    c_in, rows, wp = spec["in_shape"]
    kh, kw = w.shape[2:]
    plane = ((rows - kh) // stride[0] + 1) * ((wp - kw) // stride[1] + 1)
    s = _channel_scale(arrays[f"s{gi}"], o, plane, w.shape[0])
    op = _int8_conv(w, b, s, stride, c_in, spec["activation"],
                    spec["out_scale"], device)
    # one launch over the whole routed bbox, then the shard's range
    return lambda x: op(_upload(x, device)).reshape(-1)[o:o + n]


def _linear_fn(spec, arrays, gi, int8, device):
    w, b = arrays[f"w{gi}"], arrays[f"b{gi}"]
    act = spec["activation"]
    if not int8:
        w_t = _upload(w, device, np.float32)
        b_t = _upload(b, device, np.float32)
        return lambda x: apply_activation(
            _upload(x, device, np.float32).reshape(-1) @ w_t + b_t, act)
    # the frame's (K, n) column block, stored (n, K) once here and used as
    # its K-contiguous (K, n) view: qgemm copies no weight a call
    w_kn = _upload(w.T, device).t()
    b_t, s_t = _upload(b, device), _upload(arrays[f"s{gi}"], device)
    out_scale = spec["out_scale"]
    return lambda x: qgemm(_upload(x, device).reshape(1, -1), w_kn, s_t, b_t,
                           activation=act, out_scale=out_scale).reshape(-1)


@dataclasses.dataclass
class CompiledSegment:
    """One segment function on the worker.  Its constants were uploaded to
    the worker's device once, at setup; a call uploads the routed input
    slice, launches the segment's kernels and returns the output on the
    device without waiting for it (the caller's ``.cpu()`` does)."""

    gi: int
    layer_first: int
    input_shape: tuple[int, ...]
    fn: "object"                    # input slice (numpy) -> device tensor

    def warmup(self, dtype) -> None:
        self.fn(np.zeros(self.input_shape, dtype)).cpu()


# Upper bound on warm compiled segments a worker keeps across replans.
# Sized for several topology epochs of the full MobileNetV2 split (~30
# segments per worker per epoch): the coordinator mirrors this LRU in
# ``WorkerHandle.held_segments``, so the bound is also what the hit-rate
# accounting promises — an undersized cap shows up as a gated hit-rate
# miss, not a silent re-upload.
SEGMENT_CACHE_CAP = 256

_SEGMENT_BUILDERS = {"spatial": _spatial_fn, "conv": _conv_fn,
                     "linear": _linear_fn}


def build_segment_fns(meta: dict, arrays: dict[str, np.ndarray],
                      cache: "collections.OrderedDict | None" = None,
                      stats: dict | None = None, *,
                      device=None) -> dict[int, CompiledSegment]:
    """Lower a setup payload into segment functions on ``device`` (worker
    side; CUDA unless the caller passes another device).

    Each function runs the single-process engine's arithmetic restricted to
    this worker's geometry, through the same kernel wrappers: on CUDA an
    int8 conv stage is ``qconv2d`` (im2col + the ``qgemm`` kernel, the
    stage's scale, int32 bias and ``out_scale`` fused in its epilogue), a
    3x3 depthwise stage ``dwconv_window`` (the ``dwconv3x3`` kernel), a
    flat conv or depthwise shard one such launch over its whole routed
    bbox, then its range, and a linear shard one ``qgemm`` with M = 1.  On
    the CPU the wrappers take their plain versions, as the engine does.
    The float precision runs ``F.conv2d`` and matmul with TF32 off.

    ``cache`` (an ``OrderedDict`` the caller keeps across setups, LRU up to
    ``SEGMENT_CACHE_CAP``) enables warm re-setup across replans: a spec
    whose content ``fingerprint`` matches a cached entry reuses its
    already uploaded constants — geometry that did not change uploads
    nothing.  A cache belongs to one worker, hence to one device.
    ``stats`` (a dict, filled in place) gets ``cache_hits`` /
    ``cache_misses`` counters for the coordinator's hit-rate accounting.
    """
    int8 = _check_precision(meta["precision"])
    dev = resolve_device(device)
    out: dict[int, CompiledSegment] = {}
    hits = misses = 0
    for spec in meta["segments"]:
        if spec["kind"] == "skip":
            continue
        gi = spec["gi"]
        fp = spec.get("fingerprint")
        if cache is not None and fp is not None and fp in cache:
            cache.move_to_end(fp)
            out[gi] = dataclasses.replace(cache[fp], gi=gi)
            hits += 1
            continue
        misses += 1
        build = _SEGMENT_BUILDERS.get(spec["kind"])
        if build is None:
            raise ValueError(f"unknown segment kind {spec['kind']!r}")
        body = build(spec, arrays, gi, int8, dev)
        if not int8:
            body = _fp32(body)
        shape = ([spec["in_len"]] if spec["kind"] == "linear"
                 else spec["in_shape"])
        out[gi] = CompiledSegment(gi=gi, layer_first=spec["layer_first"],
                                  input_shape=tuple(shape), fn=body)
        if cache is not None and fp is not None:
            cache[fp] = out[gi]
            while len(cache) > SEGMENT_CACHE_CAP:
                cache.popitem(last=False)
    if stats is not None:
        stats["cache_hits"] = hits
        stats["cache_misses"] = misses
    return out


def _fp32(body):
    # in-process workers compute on threads of their own; _full_fp32 holds
    # the process-wide lock that keeps their float segments apart
    def fn(x):
        with _full_fp32():
            return body(x)
    return fn


def _conv_launch(w_shape, stride, c_in: int, rows: int, width: int):
    """The kernel launch of one int8 conv over a padded (c_in, rows, width)
    input, as :func:`_int8_conv` makes it, and the output's (rows, width)."""
    c_out, c_g, kh, kw = w_shape
    oh, ow = (rows - kh) // stride[0] + 1, (width - kw) // stride[1] + 1
    if c_g == c_in:
        return ("qgemm", (oh * ow, c_in * kh * kw, c_out)), (oh, ow)
    return ("dwconv3x3", (1, c_in, rows, width, stride[0])), (oh, ow)


def segment_launches(spec: dict, arrays: dict[str, np.ndarray]
                     ) -> list[tuple[str, tuple, int]]:
    """The kernel launches one call of an int8 segment makes on CUDA, in
    order, from its setup spec: (kernel, shape, layer index), the shape
    ``(M, K, N)`` of a ``qgemm`` — a conv's im2col of one sample, or a
    linear shard with M = 1 — or ``(1, C, R, Wp, stride)`` of a
    ``dwconv3x3`` over its padded (C, R, Wp) window.  An empty spatial
    stage launches nothing."""
    kind, gi = spec["kind"], spec["gi"]
    if kind == "skip":
        return []
    if kind == "linear":
        n = spec["cols"][1] - spec["cols"][0]
        return [("qgemm", (1, spec["in_len"], n), spec["layer_first"])]
    if kind == "conv":
        c_in, rows, width = spec["in_shape"]
        (kernel, shape), _ = _conv_launch(arrays[f"w{gi}"].shape,
                                          spec["stride"], c_in, rows, width)
        return [(kernel, shape, spec["layer_first"])]
    out = []
    c, rows, width = spec["in_shape"]
    for li, st in enumerate(spec["stages"]):
        if st.get("empty"):
            c, rows, width = st["out_channels"], 0, st["out_width"]
            continue
        w_shape = arrays[f"w{gi}_{li}"].shape
        (kernel, shape), (rows, width) = _conv_launch(
            w_shape, st["stride"], c, rows + st["pad_top"] + st["pad_bot"],
            width + 2 * st["pw"])
        out.append((kernel, shape, st["layer"]))
        c = w_shape[0]
    return out


def warmup_segments(segments: dict[int, CompiledSegment],
                    precision: str) -> float:
    """Run every segment function once on zeros ahead of serving (kernel
    libraries loaded, first launches made); returns seconds."""
    dtype = np.int8 if precision == "int8" else np.float32
    t0 = time.monotonic()
    for seg in segments.values():
        seg.warmup(dtype)
    return time.monotonic() - t0


# ---------------------------------------------------------------------------
# Coordinator routing plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GroupPlan:
    """Routing/bookkeeping for one block group on the coordinator."""

    gi: int
    idxs: tuple[int, ...]
    kind: str                       # "spatial" | "flat" | "local"
    layer_first: int
    in_shape: tuple[int, ...]       # first layer's input shape
    out_shape: tuple[int, ...]
    actives: tuple[int, ...]        # workers with nonempty shards
    downloads: dict[int, dict]      # worker -> slice spec
    assembly: dict[int, dict]       # worker -> placement spec
    residual_from: str | None = None
    save_as: str | None = None
    out_scale: float | None = None  # last layer's activation scale (int8)
    local: tuple | None = None      # ("avgpool", in_scale, out_scale)
    # boundary (gi-1 -> gi) structure: ``deps[w]`` is the simulator's
    # predicted producer set for consumer worker w (``_boundary_deps``
    # evaluated at this seam; None for the input boundary gi == 0).  When
    # ``clean`` the coordinator's per-worker feed awaits exactly those
    # producers' band events; otherwise it barriers on the previous group's
    # completion — which happens-after every producer, so each predicted
    # edge is realized either way (the fine-grained path just waits on less).
    deps: list[list[int]] | None = None
    clean: bool = False


@dataclasses.dataclass
class CoordinatorPlan:
    precision: str
    groups: list[GroupPlan]
    input_scale: float | None = None


def build_coordinator_plan(split: SplitPlan, qmodel: QuantizedModel | None,
                           precision: str) -> CoordinatorPlan:
    int8 = _check_precision(precision)
    if int8 and qmodel is None:
        raise ValueError("precision='int8' requires a QuantizedModel")
    model = split.model
    groups: list[GroupPlan] = []
    segs = _segments(split)
    assert list(segs) == list(split.block_groups), \
        "simulator segments must coincide with executor block groups"
    all_deps = pipelined_dependencies(split)
    modes = split.group_modes
    for gi, idxs in enumerate(split.block_groups):
        sp0 = split.splits[idxs[0]]
        last = model.layers[idxs[-1]]
        first = model.layers[idxs[0]]
        out_scale = float(qmodel.layers[idxs[-1]].out_scale) if int8 else None
        downloads: dict[int, dict] = {}
        assembly: dict[int, dict] = {}
        local = None
        if sp0.mode == "spatial":
            kind = "spatial"
            geoms_first = spatial_band_geometry(first, sp0)
            sp_last = split.splits[idxs[-1]]
            geoms_last = spatial_band_geometry(last, sp_last)
            actives = tuple(w for w in range(split.n_workers)
                            if geoms_last[w] is not None)
            for w in actives:
                g0 = geoms_first[w]
                lo, hi = (g0.in_lo, g0.in_hi) if g0 is not None else (0, 0)
                downloads[w] = {"kind": "rows", "lo": lo, "hi": hi}
                gl = geoms_last[w]
                assembly[w] = {"kind": "rows", "lo": gl.row_lo,
                               "hi": gl.row_hi}
        elif last.kind == "avgpool":
            kind = "local"
            actives = ()
            if int8:
                ql = qmodel.layers[idxs[-1]]
                local = ("avgpool", float(ql.in_scale), float(ql.out_scale))
            else:
                local = ("avgpool", None, None)
        else:
            kind = "flat"
            actives = tuple(s.worker for s in sp0.shards if s.n_positions)
            geom = (compile_shard_geometry(first, sp0)
                    if first.kind in ("conv", "dwconv") else None)
            for w in actives:
                shard = sp0.shard_of(w)
                if first.kind == "linear":
                    downloads[w] = {"kind": "full"}
                else:
                    g = geom[w]
                    downloads[w] = {
                        "kind": "conv", "r0": g.in_r0, "r1": g.in_r1,
                        "ph": first.padding[0], "pw": first.padding[1],
                        "c_lo": (g.c_lo if first.kind == "dwconv" else None),
                        "c_hi1": (g.c_hi + 1 if first.kind == "dwconv"
                                  else None)}
                assembly[w] = {"kind": "flat", "start": shard.start,
                               "stop": shard.stop}
        # boundary structure gi-1 -> gi
        deps = None
        clean = False
        if gi > 0:
            prev_last = model.layers[split.block_groups[gi - 1][-1]]
            deps = all_deps[gi - 1]
            clean = (modes[gi - 1] == "spatial" and kind == "spatial"
                     and prev_last.residual_from is None
                     and prev_last.save_as is None)
        groups.append(GroupPlan(
            gi=gi, idxs=tuple(idxs), kind=kind, layer_first=idxs[0],
            in_shape=tuple(first.in_shape), out_shape=tuple(last.out_shape),
            actives=actives, downloads=downloads, assembly=assembly,
            residual_from=last.residual_from, save_as=last.save_as,
            out_scale=out_scale, local=local, deps=deps, clean=clean))
    return CoordinatorPlan(
        precision=precision, groups=groups,
        input_scale=float(qmodel.input_scale) if int8 else None)


def worker_geometry_summary(split: SplitPlan) -> list[dict]:
    """JSON-serializable per-worker geometry: what each worker holds and
    computes, per block group — the serialized form ``Plan.worker_geometry``
    exposes and the distributed example reports."""
    model = split.model
    out: list[dict] = []
    for w in range(split.n_workers):
        segs: list[dict] = []
        for gi, idxs in enumerate(split.block_groups):
            sp0 = split.splits[idxs[0]]
            if sp0.mode == "spatial":
                sp_last = split.splits[idxs[-1]]
                g = spatial_band_geometry(model.layers[idxs[-1]], sp_last)[w]
                if g is None:
                    continue
                segs.append({"segment": gi, "mode": "spatial",
                             "layers": list(idxs),
                             "rows": [g.row_lo, g.row_hi]})
            else:
                shard = sp0.shard_of(w)
                if not shard.n_positions:
                    continue
                segs.append({"segment": gi, "mode": sp0.mode,
                             "layers": list(idxs),
                             "flat_range": [shard.start, shard.stop]})
        out.append({"worker": w,
                    "weight_bytes": int(split.worker_weight_bytes(w)),
                    "segments": segs})
    return out
