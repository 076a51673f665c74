"""Launchers of the hand-written CUDA depthwise kernel (``csrc/dwconv.cu``).

Port of the two TPU kernels in ``repro/kernels/dwconv/dwconv.py``:

* :func:`dwconv3x3` — one pre-padded (C, H+2, W+2) sample, or a batch of
  them (B, C, H+2, W+2), as the reference's contract gives it.
* :func:`dwconv3x3_bands` — a stack of spatial band windows
  (bands, C, R, W+2): the depthwise stage of every fused spatial block.

The 5x5 depthwise convs of EfficientNet (pad 2) take the engine's two
forms, :func:`dwconv5x5_shards` and :func:`dwconv5x5_bands_unpadded`, and
launch the kernel's 5x5 instance (``dwconv5x5_kernel``; the 3x3 forms
launch ``dwconv3x3_kernel``).

One CUDA kernel serves both, and the port's engine reaches it through
three forms that read the input unpadded and make the zero halo inside the
kernel (``pad`` rows and columns on each side):

* :func:`dwconv3x3_same` — SAME padding of an unpadded (B, C, H, W) input;
* :func:`dwconv3x3_bands_unpadded` — band windows whose width is not yet
  padded (the spatial plan's stages);
* :func:`dwconv3x3_shards` — a whole flat layer over all of its worker
  shards in one launch (the kernel and neuron plans), or one launch per
  ``MAX_SHARDS`` shards beyond that (:func:`split_table`): a
  :class:`ShardTable` gives each shard's channel span and flat output
  range, every CTA belongs to one shard and stores only that shard's
  positions.

The first and third count on ``dwconv3x3.launches``, the others on
``dwconv3x3_bands.launches``; each 5x5 form counts on its own
``.launches`` (a launch captured into a CUDA graph counts
once, its replays do not).  A CPU tensor takes the plain version
(:mod:`.ref`); a CUDA tensor launches the kernel or raises.

:func:`dwconv_schedule` picks a CTA's tile (channels x output rows) from
the shape, the shard spans and the SM count; :func:`cta_tiles` lists the
tiles of a launch in the order the kernel maps ``blockIdx.x`` onto them.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ...core.quantize import f32
from .. import backend
from .ref import (dwconv3x3_ref, dwconv_bands_unpadded_ref, dwconv_same_ref,
                  dwconv_shards_ref)

_ACTIVATIONS = {None: 0, "relu": 1, "relu6": 2, "swish": 3, "sigmoid": 4}
THREADS = 256            # threads of a CTA (as csrc/dwconv.cu)
VEC = 4                  # adjacent outputs of a row a thread computes (too)
SMEM_BUDGET = 24 * 1024  # staged bytes of a CTA (up to 8 CTAs an SM)
TARGET_ITEMS = 2 * THREADS   # row segments of VEC outputs a CTA aims at
MIN_ITEMS = THREADS // 8     # a CTA is not cut below this to fill the card
CTAS_PER_SM = 2              # CTAs per SM the schedule tries to reach
MAX_GRID = 2 ** 31 - 1   # CTAs of a window (grid x)
MAX_WINDOWS = 65535      # windows (grid y)
MAX_SHARDS = 64          # shards of one launch (kernel parameter space)


def out_size(h: int, w: int, stride: int, pad: tuple[int, int], k: int = 3
             ) -> tuple[int, int]:
    """Output rows and columns of a kxk conv over (h, w) with ``pad``."""
    ph, pw = pad
    return (h + 2 * ph - k) // stride + 1, (w + 2 * pw - k) // stride + 1


def slab_bytes(rows_tile: int, h: int, w: int, stride: int, k: int = 3) -> int:
    """Shared-memory bytes of one channel's staged rows: the input rows of
    ``rows_tile`` output rows (at most ``h``), copied as the 16-byte-aligned
    chunks that hold them (a run starts at any byte, so up to 15 bytes
    more)."""
    run = min((rows_tile - 1) * stride + k, h) * w
    return 16 * -(-(run + 15) // 16)


def smem_bytes(c_tile: int, slab: int, k: int = 3) -> int:
    """A CTA's dynamic shared memory (``dwconv_smem_bytes_k`` in the
    source): the channels' slabs between 16 bytes of padding on each side
    (a tap's word read may reach past them), then each channel's f32 scale,
    32-bit bias and k rows of packed taps (one word a row at 3x3, two at
    5x5)."""
    return 32 + c_tile * (slab + 8 + 4 * k * (1 if k == 3 else 2))


@dataclasses.dataclass(frozen=True)
class DwSchedule:
    """The tile of one launch: ``c_tile`` channels x ``rows_tile`` output
    rows a CTA; ``tiles`` CTAs a window (the grid's x), ``grid`` CTAs in
    all (windows x tiles)."""

    c_tile: int
    rows_tile: int
    slab: int
    smem: int
    tiles: int
    grid: int


def _tiles(spans, c_tile: int, n_rt: int) -> int:
    return sum(-(-n // c_tile) for n in spans) * n_rt


def dwconv_schedule(nb: int, spans, h: int, w: int, stride: int,
                    pad: tuple[int, int] = (1, 1), n_sm: int = 132,
                    k: int = 3) -> DwSchedule:
    """Tile of a launch over ``nb`` windows of (C, h, w) unpadded input,
    cut into shards of ``spans`` channels each (one span of all C for an
    unsharded call).

    A CTA first takes whole output rows of as many channels as make about
    ``TARGET_ITEMS`` row segments of ``VEC`` outputs (or, for planes larger
    than that, a band of rows of one channel), within ``SMEM_BUDGET``
    staged bytes.  While the launch has fewer than ``CTAS_PER_SM`` CTAs an
    SM, channels and then rows are halved, down to ``MIN_ITEMS`` segments a
    CTA.  No CTA spans two shards.  Shapes only: no device value is read."""
    spans = [int(n) for n in spans]
    if not spans or min(spans) < 1:
        raise ValueError(f"dwconv shard spans {spans}")
    oh, ow = out_size(h, w, stride, pad, k)
    if oh < 1 or ow < 1:
        raise ValueError(f"dwconv input {h}x{w} below the {k}x{k} window")
    n_seg = -(-ow // VEC)
    per_plane = oh * n_seg
    if per_plane >= TARGET_ITEMS:
        c_tile, rows_tile = 1, min(oh, -(-TARGET_ITEMS // n_seg))
    else:
        c_tile = max(1, min(max(spans), TARGET_ITEMS // per_plane))
        rows_tile = oh

    def smem(c, r):
        return smem_bytes(c, slab_bytes(r, h, w, stride, k), k)

    while c_tile > 1 and smem(c_tile, rows_tile) > SMEM_BUDGET:
        c_tile = -(-c_tile // 2)
    while rows_tile > 1 and smem(c_tile, rows_tile) > SMEM_BUDGET:
        rows_tile = -(-rows_tile // 2)
    if smem(c_tile, rows_tile) > SMEM_BUDGET:
        raise ValueError(f"dwconv rows of width {w} do not fit the kernel")

    def ctas(c, r):
        return nb * _tiles(spans, c, -(-oh // r))

    while ctas(c_tile, rows_tile) < CTAS_PER_SM * n_sm:
        if c_tile > 1 and -(-c_tile // 2) * rows_tile * n_seg >= MIN_ITEMS:
            c_tile = -(-c_tile // 2)
        elif (rows_tile > 1
              and c_tile * -(-rows_tile // 2) * n_seg >= MIN_ITEMS):
            rows_tile = -(-rows_tile // 2)
        else:
            break
    slab = slab_bytes(rows_tile, h, w, stride, k)
    tiles = _tiles(spans, c_tile, -(-oh // rows_tile))
    return DwSchedule(c_tile, rows_tile, slab, smem_bytes(c_tile, slab, k),
                      tiles, nb * tiles)


# a launch's schedule, computed once per shape (the forward pass is
# host-bound, and the schedule takes ~10 us of Python)
_schedule = functools.lru_cache(maxsize=4096)(dwconv_schedule)


def cta_tiles(sched: DwSchedule, shards, oh: int):
    """Yield (tile, shard index, c0, nc, r0, nr) of each CTA of one window,
    in the order the kernel maps ``blockIdx.x % tiles`` onto them: shard by
    shard, channel tile by channel tile, row tile by row tile.  ``shards``
    holds (c_lo, c_hi exclusive, ...) rows."""
    n_rt = -(-oh // sched.rows_tile)
    t = 0
    for z, (c_lo, c_hi, *_) in enumerate(shards):
        for c0 in range(c_lo, c_hi, sched.c_tile):
            for rt in range(n_rt):
                r0 = rt * sched.rows_tile
                yield (t, z, c0, min(sched.c_tile, c_hi - c0), r0,
                       min(sched.rows_tile, oh - r0))
                t += 1


@dataclasses.dataclass(frozen=True)
class ShardTable:
    """The worker shards of one flat depthwise layer: rows (c_lo, c_hi
    exclusive, start, stop, dst) — the channel span a shard holds, its flat
    output range [start, stop) of the layer's (C, oh, ow) output, and where
    that range lands in the output (the running sum of the shards'
    positions).  ``packed`` is the rows as the C array the launch passes
    into the kernel's parameters (built once, no device upload)."""

    rows: tuple[tuple[int, int, int, int, int], ...]
    packed: ctypes.Array

    @functools.cached_property
    def spans(self) -> tuple[int, ...]:
        return tuple(c_hi - c_lo for c_lo, c_hi, *_ in self.rows)

    @functools.cached_property
    def positions(self) -> int:
        return sum(stop - start for _, _, start, stop, _ in self.rows)

    @functools.cached_property
    def launches(self) -> tuple[tuple["ShardTable", int, int], ...]:
        """The table as the kernel takes it: :func:`split_table` at
        ``MAX_SHARDS`` rows a launch."""
        return tuple(split_table(self, MAX_SHARDS))


def _packed(rows) -> ShardTable:
    rows = tuple(rows)
    flat = [v for row in rows for v in row]
    return ShardTable(rows, (ctypes.c_int * len(flat))(*flat))


def split_table(table: ShardTable, limit: int
                ) -> list[tuple[ShardTable, int, int]]:
    """Cut ``table`` into consecutive tables of at most ``limit`` rows, one
    launch each: [(sub_table, pos_lo, pos_hi)].  A row keeps its
    destination, so the launch of a sub-table writes exactly the slice
    [pos_lo, pos_hi) of the whole table's (NB, positions) output, at the
    whole table's row stride."""
    if limit < 1:
        raise ValueError(f"dwconv launch limit {limit}")
    if len(table.rows) <= limit:
        return [(table, 0, table.positions)]
    out = []
    for i in range(0, len(table.rows), limit):
        sub = _packed(table.rows[i:i + limit])
        _, _, start, stop, dst = sub.rows[-1]
        out.append((sub, sub.rows[0][4], dst + stop - start))
    return out


def shard_table(shards) -> ShardTable:
    """``shards``: (c_lo, c_hi inclusive, start, stop) of each shard with
    positions, in worker order.  Their destinations are the running sum of
    their positions, as the reference concatenates them."""
    rows, dst = [], 0
    for c_lo, c_hi, start, stop in shards:
        if not (0 <= c_lo <= c_hi and start < stop):
            raise ValueError(f"dwconv shard {(c_lo, c_hi, start, stop)}")
        rows.append((int(c_lo), int(c_hi) + 1, int(start), int(stop), dst))
        dst += int(stop) - int(start)
    if not rows:
        raise ValueError("dwconv shard table without shards")
    return _packed(rows)


@functools.cache
def _entry():
    fn = backend.library("dwconv").dwconv_s8
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = ([p] * 5 + [ctypes.POINTER(i)] + [i] * 13
                   + [ctypes.c_longlong, i, i, i, ctypes.c_float, p])
    fn.restype = ctypes.c_int
    return fn


def _launch(wrapper, x, w, scale, bias, stride, activation, out_scale,
            pad, table: ShardTable | None = None):
    """x: (NB, C, H, W) int8 on CUDA, read with ``pad`` zero rows and
    columns on each side.  Returns (NB, C, oh, ow), or (NB, positions) with
    a shard table; counts each launch on ``wrapper``.  A table of more than
    ``MAX_SHARDS`` shards takes one launch per ``MAX_SHARDS``
    (:func:`split_table`), each writing its slice of the one output."""
    nb, c, h, wd = x.shape
    k = w.shape[-1]
    oh, ow = out_size(h, wd, stride, pad, k)
    out_i8 = out_scale is not None
    dtype = torch.int8 if out_i8 else torch.float32
    if table is None:
        out = torch.empty((nb, c, oh, ow), dtype=dtype, device=x.device)
        per_window = c * oh * ow
        parts = ((None, (c,)),)
    else:
        per_window = table.positions
        out = torch.empty((nb, per_window), dtype=dtype, device=x.device)
        parts = tuple((sub, sub.spans) for sub, _, _ in table.launches)
    if out.numel() == 0:
        return out
    n_sm = backend.sm_count(x.device)
    scheds = [_schedule(nb, spans, h, wd, stride, tuple(pad), n_sm, k)
              for _, spans in parts]
    tiles = max(sched.tiles for sched in scheds)
    if tiles > MAX_GRID or nb > MAX_WINDOWS:
        raise ValueError(f"dwconv grid {tiles} x {nb} too large")
    x, w = x.contiguous(), w.contiguous()
    scale, bias = scale.contiguous(), bias.contiguous()
    inv = f32(1.0 / float(out_scale)) if out_i8 else 1.0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    for (sub, spans), sched in zip(parts, scheds):
        status = _entry()(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), None if sub is None else sub.packed,
            0 if sub is None else len(sub.rows), nb, c, h, wd, pad[0],
            pad[1], k, stride, sched.c_tile, sched.rows_tile, sched.slab,
            sched.tiles, per_window,
            int(not bias.dtype.is_floating_point), int(out_i8),
            _ACTIVATIONS[activation], inv, stream)
        wrapper.launches += 1
        backend.check("dwconv", status,
                      f"dwconv{k}x{k} NB={nb} C={c} H={h} W={wd} s={stride} "
                      f"pad={pad} shards={len(spans)}")
    return out


def _check_args(x, w, scale, bias, stride, activation, ndims, pad=(0, 0),
                k: int = 3):
    if x.dim() not in ndims:
        raise ValueError(f"dwconv input of rank {x.dim()} (want {ndims})")
    c = x.shape[-3]
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError("dwconv takes int8 x and w")
    if tuple(w.shape) != (c, k, k):
        raise ValueError(f"dwconv weight {tuple(w.shape)} != ({c}, {k}, {k})")
    if scale.shape != (c,) or bias.shape != (c,):
        raise ValueError(f"scale/bias must be ({c},)")
    if scale.dtype != torch.float32 or bias.dtype not in (torch.float32,
                                                          torch.int32):
        raise TypeError("scale must be float32, bias float32 or int32")
    if stride not in (1, 2) or activation not in _ACTIVATIONS:
        raise ValueError(f"stride {stride} / activation {activation!r}")
    if (x.shape[-2] + 2 * pad[0] < k or x.shape[-1] + 2 * pad[1] < k
            or min(x.shape[-2:]) < 1):
        raise ValueError(f"dwconv window {tuple(x.shape[-2:])} below {k}x{k}")
    devices = {t.device for t in (x, w, scale, bias)}
    if len(devices) != 1:
        raise ValueError(f"dwconv operands on several devices: {devices}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"dwconv runs on cuda or cpu, not {x.device}")


def dwconv3x3(x_pad, w, scale, bias, *, stride: int = 1,
              activation: str | None = None, out_scale: float | None = None):
    """x_pad: (C, H+2, W+2) int8 (pre-padded by 1), or a batch
    (B, C, H+2, W+2); w: (C, 3, 3) int8; scale: (C,) f32; bias: (C,) f32
    (real-domain, f32 epilogue) or int32 (quantized ``b_q``, added in exact
    int32 — the bit-exact executor path).  Returns (C, oh, ow) (or
    (B, C, oh, ow)), int8 or f32."""
    _check_args(x_pad, w, scale, bias, stride, activation, (3, 4))
    if x_pad.device.type == "cpu":
        return dwconv3x3_ref(x_pad, w, scale, bias, stride=stride,
                             activation=activation, out_scale=out_scale)
    single = x_pad.dim() == 3
    out = _launch(dwconv3x3, x_pad[None] if single else x_pad, w, scale,
                  bias, stride, activation, out_scale, (0, 0))
    return out[0] if single else out


def _shards(counter, k, x, table, w, scale, bias, stride, activation,
            out_scale):
    """A flat SAME kxk depthwise layer over its worker shards, counted on
    ``counter`` (see :func:`dwconv3x3_shards`)."""
    p = k // 2
    _check_args(x, w, scale, bias, stride, activation, (4,), (p, p), k)
    if max(c_hi for _, c_hi, *_ in table.rows) > x.shape[1]:
        raise ValueError(f"shard table beyond {x.shape[1]} channels")
    if x.device.type == "cpu":
        return dwconv_shards_ref(x, table.rows, w, scale, bias,
                                 stride=stride, activation=activation,
                                 out_scale=out_scale)
    return _launch(counter, x, w, scale, bias, stride, activation,
                   out_scale, (p, p), table)


def _bands_unpadded(counter, k, x_win, w, scale, bias, stride, activation,
                    out_scale):
    """Band windows (bands, C, R, W) of a kxk depthwise stage whose width is
    not padded, counted on ``counter``."""
    p = k // 2
    _check_args(x_win, w, scale, bias, stride, activation, (4,), (0, p), k)
    if x_win.device.type == "cpu":
        return dwconv_bands_unpadded_ref(x_win, w, scale, bias,
                                         stride=stride, activation=activation,
                                         out_scale=out_scale)
    return _launch(counter, x_win, w, scale, bias, stride, activation,
                   out_scale, (0, p))


def dwconv3x3_same(x, w, scale, bias, *, stride: int = 1,
                   activation: str | None = None,
                   out_scale: float | None = None):
    """SAME 3x3 depthwise conv of an unpadded (C, H, W) or (B, C, H, W)
    input: the kernel makes the zero border itself.  Same contract and
    counter as :func:`dwconv3x3`."""
    _check_args(x, w, scale, bias, stride, activation, (3, 4), (1, 1))
    if x.device.type == "cpu":
        return dwconv_same_ref(x, w, scale, bias, stride=stride,
                               activation=activation, out_scale=out_scale)
    single = x.dim() == 3
    out = _launch(dwconv3x3, x[None] if single else x, w, scale, bias,
                  stride, activation, out_scale, (1, 1))
    return out[0] if single else out


def dwconv3x3_shards(x, table: ShardTable, w, scale, bias, *,
                     stride: int = 1, activation: str | None = None,
                     out_scale: float | None = None):
    """A flat SAME 3x3 depthwise layer over all of its worker shards in one
    launch.  ``x``: the layer's unpadded input (B, C, H, W); ``w``, ``scale``
    and ``bias`` the whole layer's.  Each shard of ``table`` computes its
    channel span and keeps its flat output range; the result is
    (B, positions), the shards' ranges side by side in table order — the
    reference's per-shard ``dwconv`` + slice + concatenate.  Counts one
    launch on ``dwconv3x3.launches`` for each ``MAX_SHARDS`` shards (a
    table of more takes ``ceil(shards / MAX_SHARDS)`` launches)."""
    return _shards(dwconv3x3, 3, x, table, w, scale, bias, stride,
                   activation, out_scale)


def dwconv3x3_bands(x_win, w, scale, bias, *, stride: int = 1,
                    activation: str | None = None,
                    out_scale: float | None = None):
    """Batched-band 3x3 depthwise conv: ``x_win`` is (bands, C, R, W+2) int8
    — one pre-gathered row window per spatial band (halo/zero rows and the
    width pad already in place, shorter bands zero-filled to the common R).
    Every band runs in one kernel launch; weights/scale/bias are shared
    across bands (spatial mode replicates weights) with the same contract
    as :func:`dwconv3x3`."""
    _check_args(x_win, w, scale, bias, stride, activation, (4,))
    if x_win.device.type == "cpu":
        return dwconv3x3_ref(x_win, w, scale, bias, stride=stride,
                             activation=activation, out_scale=out_scale)
    return _launch(dwconv3x3_bands, x_win, w, scale, bias, stride,
                   activation, out_scale, (0, 0))


def dwconv3x3_bands_unpadded(x_win, w, scale, bias, *, stride: int = 1,
                             activation: str | None = None,
                             out_scale: float | None = None):
    """:func:`dwconv3x3_bands` over windows (bands, C, R, W) whose width is
    not padded: the kernel makes the zero column on each side.  Counts on
    ``dwconv3x3_bands.launches``."""
    return _bands_unpadded(dwconv3x3_bands, 3, x_win, w, scale, bias, stride,
                           activation, out_scale)


def dwconv5x5_shards(x, table: ShardTable, w, scale, bias, *,
                     stride: int = 1, activation: str | None = None,
                     out_scale: float | None = None):
    """:func:`dwconv3x3_shards` at 5x5 (pad 2), ``w`` (C, 5, 5); counts on
    ``dwconv5x5_shards.launches``."""
    return _shards(dwconv5x5_shards, 5, x, table, w, scale, bias, stride,
                   activation, out_scale)


def dwconv5x5_bands_unpadded(x_win, w, scale, bias, *, stride: int = 1,
                             activation: str | None = None,
                             out_scale: float | None = None):
    """:func:`dwconv3x3_bands_unpadded` at 5x5: the kernel makes two zero
    columns on each side.  Counts on ``dwconv5x5_bands_unpadded.launches``."""
    return _bands_unpadded(dwconv5x5_bands_unpadded, 5, x_win, w, scale,
                           bias, stride, activation, out_scale)


dwconv3x3.launches = dwconv3x3_bands.launches = 0
dwconv5x5_shards.launches = dwconv5x5_bands_unpadded.launches = 0
dwconv3x3.kernels_per_launch = dwconv3x3_bands.kernels_per_launch = 1
dwconv5x5_shards.kernels_per_launch = 1
dwconv5x5_bands_unpadded.kernels_per_launch = 1
