"""Length-prefixed frame protocol for coordinator <-> worker sockets.

Pure stdlib + numpy (no msgpack: the pinned-minimum CI cell installs only
jax/numpy/pytest, and activations are raw int8 buffers anyway — JSON headers
plus raw array payloads are both simpler and faster than re-encoding tensor
bytes).  One frame on the wire is

    u32 body_len (little-endian)
    body:
        u32 header_len
        header_len bytes of UTF-8 JSON:
            {"type": str, "meta": {...},
             "arrays": [[name, dtype_str, shape, nbytes], ...]}
        concatenated raw array buffers, in header order

Arrays round-trip by dtype string (``np.dtype.str``, e.g. ``"|i1"``,
``"<f4"``) and shape; payload bytes are the C-contiguous buffer.  Frames are
bounded by :data:`MAX_FRAME_BYTES` — a corrupt length prefix surfaces as a
:class:`ProtocolError` instead of an attempt to allocate garbage gigabytes.

EOF semantics: end-of-stream on a frame boundary raises
:class:`ConnectionClosed` (a clean shutdown the caller may expect); EOF
*inside* a frame raises :class:`ProtocolError` naming how far the frame got
— the truncated-frame signal the coordinator turns into a worker-death
error.

:func:`read_frame` timestamps the wire transfer (``recv_start`` after the
length prefix landed, ``recv_end`` once the body is in) with
``time.monotonic()`` — on Linux a system-wide clock, so worker-side receive
windows and coordinator-side events are directly comparable when both run
on one host (the localhost validation harness).

Port copy of ``repro/runtime/protocol.py`` (numpy only, no torch): the port
cannot import the reference, whose package pulls in JAX, so it carries
this copy.  The frames stay byte-identical to the reference's (the device
is never part of one), so a port coordinator drives reference workers and
the other way round; ``tests/test_torch_runtime.py`` holds both to that.
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
import struct
import time

import numpy as np

MAX_FRAME_BYTES = 1 << 30          # 1 GiB: far above any shard payload
_LEN = struct.Struct("<I")


class ProtocolError(RuntimeError):
    """Malformed, truncated, or oversized frame."""


class ConnectionClosed(ProtocolError):
    """EOF on a clean frame boundary (peer went away between frames)."""


@dataclasses.dataclass
class Frame:
    """One decoded frame plus its measured receive window."""

    type: str
    meta: dict
    arrays: dict[str, np.ndarray]
    nbytes: int = 0                 # full frame size incl. length prefix
    recv_start: float = 0.0         # monotonic, after the length prefix landed
    recv_end: float = 0.0           # monotonic, after the full body landed


def encode_frame(type: str, meta: dict | None = None,
                 arrays: dict[str, np.ndarray] | None = None) -> bytes:
    """Serialize one frame to wire bytes (length prefix included)."""
    specs = []
    payloads = []
    for name, arr in (arrays or {}).items():
        arr = np.ascontiguousarray(arr)
        buf = arr.tobytes()
        specs.append([name, arr.dtype.str, list(arr.shape), len(buf)])
        payloads.append(buf)
    header = json.dumps({"type": type, "meta": meta or {},
                         "arrays": specs}).encode("utf-8")
    body_len = _LEN.size + len(header) + sum(len(p) for p in payloads)
    if body_len > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame body of {body_len} bytes exceeds "
                            f"MAX_FRAME_BYTES={MAX_FRAME_BYTES}")
    parts = [_LEN.pack(body_len), _LEN.pack(len(header)), header, *payloads]
    return b"".join(parts)


def decode_body(body: bytes) -> tuple[str, dict, dict[str, np.ndarray]]:
    """Decode a frame body (everything after the outer length prefix)."""
    if len(body) < _LEN.size:
        raise ProtocolError(f"frame body of {len(body)} bytes is shorter "
                            "than its header length field")
    (header_len,) = _LEN.unpack_from(body, 0)
    header_end = _LEN.size + header_len
    if header_end > len(body):
        raise ProtocolError(f"frame header of {header_len} bytes overruns "
                            f"the {len(body)}-byte body")
    try:
        header = json.loads(body[_LEN.size:header_end].decode("utf-8"))
        ftype = header["type"]
        meta = header.get("meta", {})
        specs = header.get("arrays", [])
    except (ValueError, KeyError, UnicodeDecodeError) as e:
        raise ProtocolError(f"undecodable frame header: {e}") from e
    arrays: dict[str, np.ndarray] = {}
    off = header_end
    for name, dtype_str, shape, nbytes in specs:
        if off + nbytes > len(body):
            raise ProtocolError(
                f"array {name!r} ({nbytes} bytes) overruns the frame body")
        dt = np.dtype(dtype_str)
        count = int(np.prod(shape, dtype=np.int64))
        if count * dt.itemsize != nbytes:
            raise ProtocolError(
                f"array {name!r}: {nbytes} payload bytes != "
                f"{count} x {dt.itemsize}-byte elements of shape {shape}")
        arrays[name] = np.frombuffer(body, dtype=dt, count=count,
                                     offset=off).reshape(shape)
        off += nbytes
    if off != len(body):
        raise ProtocolError(f"{len(body) - off} trailing bytes after the "
                            "last declared array")
    return ftype, meta, arrays


async def write_frame(writer: asyncio.StreamWriter, type: str,
                      meta: dict | None = None,
                      arrays: dict[str, np.ndarray] | None = None,
                      drain: bool = True) -> int:
    """Encode and send one frame; returns bytes written (prefix included)."""
    wire = encode_frame(type, meta, arrays)
    writer.write(wire)
    if drain:
        await writer.drain()
    return len(wire)


async def read_frame(reader: asyncio.StreamReader,
                     max_bytes: int = MAX_FRAME_BYTES) -> Frame:
    """Read one frame.  Raises :class:`ConnectionClosed` on EOF between
    frames, :class:`ProtocolError` on truncation/corruption mid-frame."""
    try:
        prefix = await reader.readexactly(_LEN.size)
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            raise ConnectionClosed("connection closed on a frame boundary") \
                from e
        raise ProtocolError(
            f"truncated frame: EOF after {len(e.partial)} of "
            f"{_LEN.size} length-prefix bytes") from e
    recv_start = time.monotonic()
    (body_len,) = _LEN.unpack(prefix)
    if body_len > max_bytes:
        raise ProtocolError(f"frame of {body_len} bytes exceeds the "
                            f"{max_bytes}-byte limit (corrupt length prefix?)")
    try:
        body = await reader.readexactly(body_len)
    except asyncio.IncompleteReadError as e:
        raise ProtocolError(
            f"truncated frame: EOF after {len(e.partial)} of "
            f"{body_len} body bytes") from e
    recv_end = time.monotonic()
    ftype, meta, arrays = decode_body(body)
    return Frame(type=ftype, meta=meta, arrays=arrays,
                 nbytes=_LEN.size + body_len,
                 recv_start=recv_start, recv_end=recv_end)
