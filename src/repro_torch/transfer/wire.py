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

The port speaks the DENSE kind (0) — a raw flat buffer, f32 / bf16 /
f16 — and the SPARSE kind (1) — a ``compress_flat`` payload: values int8
[k] || scales f32 [ceil(k/block)] || indices int32 [k] — both emitted at
version 2.  The sparse body is packed on the payload's device by ONE
kernel launch (``kernels/ops.pack_body``, byte copies only) and crosses
to the host in one copy; the crc is taken there.  Kinds 2 (shard) and 3
(aggregate) are validated like any frame and then refused with
``NotImplementedError``: they come with the sharded-bus and
aggregation-tier slices of the port.  Payloads decode to CPU tensors.
"""
from __future__ import annotations

import struct
import zlib
from typing import NamedTuple, Union

import numpy as np
import torch

from repro_torch.core.compression import CompressedDelta
from repro_torch.kernels import ops as K

MAGIC = b"VCWF"
WIRE_VERSION = 3

KIND_DENSE = 0
KIND_SPARSE = 1
KIND_SHARD = 2
KIND_AGG = 3

_LATER_SLICE = {KIND_SHARD: "the sharded-bus slice",
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
    payload: Union[torch.Tensor, CompressedDelta]   # CPU tensors
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


def sparse_frame_bytes(k: int, block: int = 256) -> int:
    """Exact frame length of a top-k + int8 payload: k int8 values,
    ceil(k/block) f32 scales, k int32 indices."""
    return HEADER_BYTES + k + (-(-k // block)) * 4 + k * 4


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


def encode_sparse(p: CompressedDelta, *, round: int = 0,
                  residual_norm: float = 0.0) -> bytes:
    """Encode a compress_flat payload (global top-k + int8).  The body is
    packed on the payload's device in one launch and crosses to the host
    as one buffer; the frame is byte-identical to the reference's."""
    k = int(p.values.numel())
    ng = int(p.scales.numel())
    n = 1
    for s in p.shape:
        n *= int(s)
    body = K.pack_body(p.values.reshape(-1).contiguous(),
                       p.scales.reshape(-1).contiguous(),
                       p.indices.reshape(-1).contiguous())
    header = _HDR.pack(MAGIC, _EMIT_VERSION, KIND_SPARSE, 0,
                       n, k, int(p.block), float(p.density),
                       int(round), float(residual_norm),
                       k, 4 * ng, 4 * k)
    return _frame(header, body.to("cpu").numpy().tobytes())


def encode(payload, *, round: int = 0, residual_norm: float = 0.0) -> bytes:
    """Dispatch on payload type: buffers go dense, CompressedDelta sparse.
    Aggregate payloads are not ported yet."""
    if isinstance(payload, CompressedDelta):
        return encode_sparse(payload, round=round, residual_norm=residual_norm)
    if not isinstance(payload, (torch.Tensor, np.ndarray)):
        raise NotImplementedError(
            f"wire payload {type(payload).__name__}: only dense buffers and "
            f"CompressedDelta are ported; aggregate frames come with the "
            f"aggregation-tier slice")
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
    if kind == KIND_SPARSE:
        return WireMessage(KIND_SPARSE,
                           _sparse_payload(body, n, k, block, density,
                                           len_v, len_s),
                           rnd, res_norm)
    if kind != KIND_DENSE:
        raise WireError(f"unknown frame kind {kind}")
    if dcode not in _CODE_TORCH:
        raise WireError(f"unknown dense dtype code {dcode}")
    arr = np.frombuffer(body, _CODE_NUMPY[dcode])
    if arr.size != n:
        raise WireError(f"dense payload {arr.size} elements != declared n={n}")
    payload = torch.from_numpy(arr.copy()).view(_CODE_TORCH[dcode])
    return WireMessage(KIND_DENSE, payload, rnd, res_norm)


def _sparse_payload(body: bytes, n: int, k: int, block: int, density: float,
                    len_v: int, len_s: int) -> CompressedDelta:
    """The three sections of a validated sparse body, checked against the
    header's k, block and n, as CPU tensors."""
    if len_s % 4 or (len(body) - len_v - len_s) % 4:
        raise WireError(f"sparse scale/index sections of {len_s}B / "
                        f"{len(body) - len_v - len_s}B are not whole 4-byte "
                        f"words")
    vals = np.frombuffer(body[:len_v], np.int8)
    scls = np.frombuffer(body[len_v:len_v + len_s], np.float32)
    idxs = np.frombuffer(body[len_v + len_s:], np.int32)
    if vals.size != k or idxs.size != k:
        raise WireError(f"sparse sections disagree with k={k}: "
                        f"{vals.size} values / {idxs.size} indices")
    if block <= 0 or scls.size != -(-k // block):
        raise WireError(f"scale count {scls.size} != ceil({k}/{block})")
    if k > n:
        raise WireError(f"k={k} exceeds buffer length n={n}")
    return CompressedDelta(values=torch.from_numpy(vals.copy()),
                           scales=torch.from_numpy(scls.copy()),
                           indices=torch.from_numpy(idxs.copy()),
                           shape=(int(n),), density=float(density),
                           block=int(block))
