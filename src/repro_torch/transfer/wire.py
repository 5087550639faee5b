"""Wire format — what a flat payload looks like as BYTES (port of the dense
part of ``repro/transfer/wire.py``; frames are byte-identical).

Frame layout (little-endian, fixed 68-byte v2 header + body; version 3
frames append one ``weight f32`` before the crc — 72 bytes)::

    magic 4s "VCWF" | version u16 | kind u8 | dtype u8 | n u64 | k u64 |
    block u32 | density f32 | round u32 | res_norm f32 |
    len_val u64 | len_scl u64 | len_idx u64 | [weight f32, v3] | crc u32

The crc32 covers header-sans-crc || body, so a flip anywhere fails it.
A decoder checks magic and version FIRST and rejects versions newer than
it speaks; truncated, oversized or bit-flipped frames raise ``WireError``
and are never assimilated.

This slice speaks the DENSE kind (0): a raw flat buffer, f32 / bf16 /
f16, emitted at version 2.  Kinds 1 (sparse top-k + int8), 2 (shard) and
3 (aggregate) are validated like any frame and then refused with
``NotImplementedError``: they come with the compressed-upload and
aggregation/sharded-bus slices of the port.  Dense payloads decode to
CPU torch tensors.
"""
from __future__ import annotations

import struct
import zlib
from typing import NamedTuple

import numpy as np
import torch

MAGIC = b"VCWF"
WIRE_VERSION = 3

KIND_DENSE = 0
KIND_SPARSE = 1
KIND_SHARD = 2
KIND_AGG = 3

_LATER_SLICE = {KIND_SPARSE: "the compressed-upload slice",
                KIND_SHARD: "the sharded-bus slice",
                KIND_AGG: "the aggregation-tier slice"}

_EMIT_VERSION = 2
_HDR = struct.Struct("<4sHBBQQIfIfQQQ")      # v1/v2 header minus the crc
_HDR3 = struct.Struct("<4sHBBQQIfIfQQQf")    # v3: + weight f32
_CRC = struct.Struct("<I")
_PEEK = struct.Struct("<4sH")                # magic/version, checked FIRST
HEADER_BYTES = _HDR.size + _CRC.size

_DTYPE_CODES = {"float32": 0, "bfloat16": 1, "float16": 2}
_CODE_TORCH = {0: torch.float32, 1: torch.bfloat16, 2: torch.float16}
_CODE_NUMPY = {0: np.float32, 1: np.int16, 2: np.float16}   # bf16 as bits


class WireError(ValueError):
    """Frame failed validation (magic/version/length/crc) — do NOT
    assimilate anything from it."""


class WireMessage(NamedTuple):
    kind: int
    payload: torch.Tensor         # dense body as a CPU tensor
    round: int                    # error-feedback round counter
    residual_norm: float          # client-side residual mass after sending


def _frame(header_wo_crc: bytes, body: bytes) -> bytes:
    return (header_wo_crc
            + _CRC.pack(zlib.crc32(body, zlib.crc32(header_wo_crc)))
            + body)


def dense_frame_bytes(n: int, dtype: str = "float32") -> int:
    """Exact frame length of a dense buffer payload."""
    itemsize = 2 if dtype in ("bfloat16", "float16") else 4
    return HEADER_BYTES + n * itemsize


def _dense_bytes(buf):
    """(dtype code, element count, raw little-endian bytes) of a 1-D
    buffer: a torch tensor (any device; copied to the host) or a numpy
    array."""
    if isinstance(buf, torch.Tensor):
        t = buf.detach().reshape(-1).to("cpu").contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if name not in _DTYPE_CODES:
            raise WireError(f"unsupported dense wire dtype {name}")
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return _DTYPE_CODES[name], t.numel(), t.numpy().tobytes()
    arr = np.asarray(buf).reshape(-1)
    name = str(arr.dtype)
    if name not in _DTYPE_CODES:
        raise WireError(f"unsupported dense wire dtype {name}")
    return _DTYPE_CODES[name], arr.size, arr.tobytes()


def encode_dense(buf, *, round: int = 0, residual_norm: float = 0.0) -> bytes:
    """Encode a full flat buffer (the uncompressed payload kind)."""
    code, n, raw = _dense_bytes(buf)
    header = _HDR.pack(MAGIC, _EMIT_VERSION, KIND_DENSE, code, n, n, 0, 1.0,
                       int(round), float(residual_norm), len(raw), 0, 0)
    return _frame(header, raw)


def encode(payload, *, round: int = 0, residual_norm: float = 0.0) -> bytes:
    """Dispatch on payload type: a buffer goes dense.  Sparse and
    aggregate payloads are not ported yet."""
    if not isinstance(payload, (torch.Tensor, np.ndarray)):
        raise NotImplementedError(
            f"wire payload {type(payload).__name__}: only dense buffers "
            f"are ported; sparse frames come with the compressed-upload "
            f"slice and aggregate frames with the aggregation-tier slice")
    return encode_dense(payload, round=round, residual_norm=residual_norm)


def decode(frame: bytes) -> WireMessage:
    """Validate and decode one frame.  Raises WireError on ANY structural
    problem — short frame, bad magic, unknown version, length mismatch,
    crc mismatch — so a torn transfer can never be assimilated."""
    if len(frame) < _PEEK.size:
        raise WireError(f"frame too short: {len(frame)} < {_PEEK.size}")
    magic, version = _PEEK.unpack_from(frame)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}")
    if version > WIRE_VERSION:
        raise WireError(f"wire version {version} newer than spoken "
                        f"{WIRE_VERSION}")
    hdr = _HDR3 if version >= 3 else _HDR
    hdr_bytes = hdr.size + _CRC.size
    if len(frame) < hdr_bytes:
        raise WireError(f"frame too short: {len(frame)} < {hdr_bytes}")
    (_, _, kind, dcode, n, k, block, density, rnd, res_norm,
     len_v, len_s, len_i) = hdr.unpack_from(frame)[:13]
    (crc,) = _CRC.unpack_from(frame, hdr.size)
    body = frame[hdr_bytes:]
    if len(body) != len_v + len_s + len_i:
        raise WireError(f"torn frame: body {len(body)}B != declared "
                        f"{len_v + len_s + len_i}B")
    if zlib.crc32(body, zlib.crc32(frame[:hdr.size])) != crc:
        raise WireError("crc mismatch (corrupt frame)")
    if kind == KIND_AGG and version < 3:
        raise WireError(f"kind {KIND_AGG} (aggregate) requires wire v3, "
                        f"got v{version}")
    if kind in _LATER_SLICE:
        raise NotImplementedError(
            f"wire frame kind {kind} is not ported yet: it comes with "
            f"{_LATER_SLICE[kind]}")
    if kind != KIND_DENSE:
        raise WireError(f"unknown frame kind {kind}")
    if dcode not in _CODE_TORCH:
        raise WireError(f"unknown dense dtype code {dcode}")
    arr = np.frombuffer(body, _CODE_NUMPY[dcode])
    if arr.size != n:
        raise WireError(f"dense payload {arr.size} elements != declared n={n}")
    payload = torch.from_numpy(arr.copy()).view(_CODE_TORCH[dcode])
    return WireMessage(KIND_DENSE, payload, rnd, res_norm)
