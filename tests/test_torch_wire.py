"""Port parity: dense and sparse wire frames and the loopback transport
against repro.transfer.

Tolerance: none — frames are compared byte for byte in both directions
(port encode == reference encode; each side decodes the other's frame to
the same values), and every truncated, bit-flipped or inconsistent frame
raises ``WireError``.
"""
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as RC
from repro.kernels import ref as RR
from repro.transfer import wire as RW
from repro_torch.convert import compressed_from_reference
from repro_torch.kernels import ref as PR
from repro_torch.transfer import wire as PW
from repro_torch.transfer.transport import LoopbackTransport, TransportError

torch.set_num_threads(2)


def _buf(seed, n=8192):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("rnd,norm", [(0, 0.0), (7, 1.25), (2 ** 31, 3e-5)])
def test_f32_dense_frames_byte_identical_both_directions(rnd, norm):
    x = _buf(rnd % 97)
    ref = RW.encode_dense(jnp.asarray(x), round=rnd, residual_norm=norm)
    port = PW.encode(torch.from_numpy(x), round=rnd, residual_norm=norm)
    assert port == ref
    assert len(port) == PW.dense_frame_bytes(x.size) == RW.dense_frame_bytes(x.size)
    got = PW.decode(ref)
    assert got.kind == PW.KIND_DENSE and got.round == rnd
    assert got.payload.numpy().tobytes() == x.tobytes()
    back = RW.decode(port)
    assert np.asarray(back.payload).tobytes() == x.tobytes()
    assert back.residual_norm == got.residual_norm


def test_bf16_dense_frames_byte_identical_both_directions():
    x = _buf(3)
    ref = RW.encode_dense(jnp.asarray(x, jnp.bfloat16), round=2)
    port = PW.encode_dense(torch.from_numpy(x).to(torch.bfloat16), round=2)
    assert port == ref and len(port) == PW.dense_frame_bytes(x.size, "bfloat16")
    got = PW.decode(ref).payload
    assert got.dtype == torch.bfloat16
    assert (got.view(torch.int16).numpy().tobytes()
            == np.asarray(RW.decode(port).payload).view(np.int16).tobytes())


def test_cuda_free_numpy_input_encodes_like_tensor():
    x = _buf(4)
    assert PW.encode_dense(x, round=1) == PW.encode_dense(torch.from_numpy(x),
                                                          round=1)


@pytest.mark.parametrize("cut", [0, 3, PW.HEADER_BYTES - 1, PW.HEADER_BYTES,
                                 -1])
def test_truncated_frames_raise(cut):
    frame = PW.encode_dense(torch.from_numpy(_buf(5)))
    with pytest.raises(PW.WireError):
        PW.decode(frame[:cut])


def test_every_header_and_body_bitflip_raises():
    frame = bytearray(PW.encode_dense(torch.from_numpy(_buf(6, 64)), round=3))
    for pos in list(range(PW.HEADER_BYTES)) + [PW.HEADER_BYTES, len(frame) - 1]:
        bad = bytearray(frame)
        bad[pos] ^= 0x10
        with pytest.raises(PW.WireError):
            PW.decode(bytes(bad))


def test_newer_version_and_oversized_frames_raise():
    frame = bytearray(PW.encode_dense(torch.from_numpy(_buf(7, 64))))
    frame[4:6] = (PW.WIRE_VERSION + 1).to_bytes(2, "little")
    with pytest.raises(PW.WireError):
        PW.decode(bytes(frame))
    with pytest.raises(PW.WireError):
        PW.decode(PW.encode_dense(torch.from_numpy(_buf(7, 64))) + b"\0")


def test_later_slice_kinds_refused_after_validation():
    ref_agg = RW.encode_aggregate(jnp.asarray(_buf(8, 64)), weight=0.5)
    ref_shard = RW.encode_shard(jnp.asarray(_buf(9, 64)), shard=1, n_shards=2)
    for frame in (ref_agg, ref_shard):
        with pytest.raises(NotImplementedError):
            PW.decode(frame)
    with pytest.raises(NotImplementedError):
        PW.encode(object())


def test_loopback_transport_exactly_once_and_drop_accounting():
    t = LoopbackTransport()
    a, b = t.send(b"abc"), t.send(b"defgh")
    assert t.in_flight == 2 and t.recv(a) == b"abc"
    with pytest.raises(TransportError):
        t.recv(a)
    t.drop(b)
    t.drop(b)                                          # idempotent
    s = t.stats
    assert (s.frames_sent, s.bytes_sent, s.frames_recv, s.bytes_recv,
            s.frames_dropped, s.bytes_dropped) == (2, 8, 1, 3, 1, 5)
    assert t.in_flight == 0


def _payloads(density, seed=0):
    """The same compress_flat payload in both packages (MLP bus)."""
    d = (np.random.default_rng(seed).standard_normal(16384).astype(np.float32)
         * (np.arange(16384) < 13130))
    rp, _ = RC.compress_flat(jnp.asarray(d), density=density,
                             logical_n=13130)
    return rp, compressed_from_reference(rp, "cpu")


@pytest.mark.parametrize("density,k", [(0.05, 656), (0.1, 1313),
                                       (1 / 13130, 1)])
@pytest.mark.parametrize("rnd,norm", [(0, 0.0), (3, 0.125)])
def test_sparse_frames_byte_identical_both_directions(density, k, rnd, norm):
    rp, pp = _payloads(density, seed=k)
    ref = RW.encode_sparse(rp, round=rnd, residual_norm=norm)
    port = PW.encode(pp, round=rnd, residual_norm=norm)
    assert port == ref
    assert len(port) == PW.sparse_frame_bytes(k) == RW.sparse_frame_bytes(k)
    got = PW.decode(ref)
    assert (got.kind, got.round, got.residual_norm) == (PW.KIND_SPARSE, rnd,
                                                        norm)
    q = got.payload
    back = RW.decode(port).payload      # density rides the header as f32
    assert (q.shape, q.density, q.block) == (back.shape, back.density,
                                             back.block)
    for f in ("values", "scales", "indices"):
        assert getattr(q, f).numpy().tobytes() == np.asarray(
            getattr(rp, f)).tobytes(), f
    for f in ("values", "scales", "indices"):
        assert np.asarray(getattr(back, f)).tobytes() == getattr(
            pp, f).numpy().tobytes(), f


def test_sparse_body_is_the_plain_pack():
    rp, pp = _payloads(0.05)
    frame = PW.encode_sparse(pp)
    body = PR.pack_body(pp.values, pp.scales, pp.indices).numpy().tobytes()
    assert frame[PW.HEADER_BYTES:] == body
    assert body == np.asarray(RR.pack_body(rp.values, rp.scales,
                                           rp.indices)).tobytes()


def _forge(*, n=100, k=10, block=256, len_v=None, len_s=None, body=None):
    """A sparse frame with a VALID crc but the given header fields."""
    len_v = k if len_v is None else len_v
    len_s = 4 * -(-k // block) if len_s is None else len_s
    if body is None:
        body = bytes(len_v + len_s + 4 * k)
    len_i = len(body) - len_v - len_s
    header = struct.pack("<4sHBBQQIfIfQQQ", b"VCWF", 2, 1, 0, n, k, block,
                         0.1, 0, 0.0, len_v, len_s, len_i)
    return PW._frame(header, body)


@pytest.mark.parametrize("case", [
    "values-section", "index-section", "scale-count", "zero-block",
    "k-exceeds-n"])
def test_sparse_frame_inconsistencies_raise(case):
    frame = {
        "values-section": lambda: _forge(len_v=11, body=bytes(11 + 4 + 40)),
        "index-section": lambda: _forge(body=bytes(10 + 4 + 44)),
        "scale-count": lambda: _forge(len_s=8, body=bytes(10 + 8 + 40)),
        "zero-block": lambda: _forge(block=0, len_s=4),
        "k-exceeds-n": lambda: _forge(n=5, k=10),
    }[case]()
    with pytest.raises(PW.WireError):
        PW.decode(frame)
    with pytest.raises(RW.WireError):
        RW.decode(frame)                # the reference refuses it too


def test_sparse_frame_torn_and_corrupt_raise():
    _, pp = _payloads(0.05)
    frame = PW.encode_sparse(pp, round=1, residual_norm=0.5)
    for cut in (PW.HEADER_BYTES + 10, len(frame) - 1):
        with pytest.raises(PW.WireError, match="torn"):
            PW.decode(frame[:cut])
    for pos in (20, PW.HEADER_BYTES + 3, len(frame) - 2):
        bad = bytearray(frame)
        bad[pos] ^= 0x04
        with pytest.raises(PW.WireError):
            PW.decode(bytes(bad))
    assert PW.decode(frame).payload.values.numel() == 656
