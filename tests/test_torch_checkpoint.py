"""The port's checkpoint store against the reference's.

* The port's msgpack codec (``repro_torch/checkpoint/_msgpack.py``) is
  byte-equal to ``msgpack.packb(obj, use_bin_type=True)`` over
  hypothesis-drawn headers and at every length boundary (fixstr / str8 /
  str16 / str32, bin8 / 16 / 32, fixarray / array16 / array32, fixmap /
  map16 / map32, ints at every width, negatives included), decodes
  ``msgpack.packb`` output to what ``msgpack.unpackb(raw=False)`` gives,
  reads a large bin with ``readinto`` into one buffer, and raises
  outside its subset.
* The three record kinds (a tree, a FlatParams, a one-pass train record)
  restore across packages both ways, bit for bit: params, m, v and
  step, on f32 and bf16 buses; every record byte is equal and every
  header field but ``treedef`` (a string readers ignore).
* Kind, layout and shard-layout mismatches raise ``ValueError``; a load
  goes to the device asked for, else to ``like``'s, else to the card
  (and raises without one).
* ``CheckpointManager``: retention and ``latest_step``; an async save is
  not disturbed by an in-place write to the buffer right after ``save``
  returns (the file write is held back until after that write); a
  background failure re-raises at ``wait``.
* The Coordinator's checkpoint hooks: the reference's
  ``test_coordinator_checkpoint_roundtrip`` and
  ``test_restore_rebuilds_scheme_local_state``, a restore dropping live
  leases and the residual ledger, and a server record crossing packages.
* A real SIGKILL of a training process (``slow``): the newest committed
  record loads and resuming from it reproduces the uninterrupted run.
Tolerance: none — every comparison is exact.
"""
import io
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from _hyp import given, settings, st

from repro.checkpoint import CheckpointManager as RefManager
from repro.checkpoint import store as RS
from repro.core import flat as RF
from repro.core.baselines import VCASGD as RefVCASGD
from repro.protocol import Coordinator as RefCoordinator
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                    load_flat_checkpoint,
                                    load_train_checkpoint, save_checkpoint,
                                    save_flat_checkpoint,
                                    save_train_checkpoint)
from repro_torch.checkpoint import _msgpack as M
from repro_torch.checkpoint import store as S
from repro_torch.core import flat as PF
from repro_torch.core.baselines import (VCASGD, CompressedVCASGD,
                                        EASGDFlatPod)
from repro_torch.protocol import Coordinator

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

_INT_EDGES = [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
              2 ** 63, 2 ** 64 - 1, -1, -31, -32, -33, -127, -128, -129,
              -32767, -32768, -32769, -2 ** 31 + 1, -2 ** 31, -2 ** 31 - 1,
              -2 ** 63 + 1, -2 ** 63]
_LEN_EDGES = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


def unpackb(data: bytes):
    """The one object ``data`` holds, by the port's decoder."""
    f = io.BytesIO(data)
    obj = next(M.Unpacker(f))
    assert f.read() == b""
    return obj


def _both_ways(obj):
    want = msgpack.packb(obj, use_bin_type=True)
    assert M.packb(obj) == want
    assert unpackb(want) == msgpack.unpackb(want, raw=False)


@pytest.mark.parametrize("x", _INT_EDGES)
def test_codec_ints_every_width(x):
    _both_ways(x)
    _both_ways([x, -x if -x >= -2 ** 63 else 0])


@pytest.mark.parametrize("n", _LEN_EDGES)
def test_codec_length_boundaries(n):
    _both_ways("s" * n)
    _both_ways("é" * (n // 2))               # utf-8: 2 bytes a char
    _both_ways(b"\x00\xff" * (n // 2) + b"b" * (n % 2))
    _both_ways(bytearray(n))
    _both_ways(list(range(n)))
    _both_ways(tuple(range(n)))
    _both_ways({f"k{i}": i for i in range(n)})


def test_codec_scalars_and_32_bit_lengths():
    for obj in (None, True, False, 0.0, -0.0, 1.5, 1e308, float("inf"),
                [None, [True, {"a": [1.25, b"x"]}]], {}, [], "", b""):
        _both_ways(obj)
    big = b"z" * (2 ** 16 + 3)                # bin32
    _both_ways(big)
    _both_ways("q" * (2 ** 16 + 3))           # str32
    _both_ways(list(range(2 ** 16 + 1)))      # array32
    _both_ways({str(i): None for i in range(2 ** 16 + 1)})   # map32
    _both_ways(memoryview(np.arange(9, dtype=np.float32)))


_leaf = (st.none() | st.booleans()
         | st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
         | st.floats(allow_nan=False) | st.text() | st.binary())
_header = st.recursive(
    _leaf, lambda kids: st.lists(kids) | st.dictionaries(st.text(), kids),
    max_leaves=40)


@settings(max_examples=200, deadline=None)
@given(obj=_header)
def test_codec_byte_equal_on_drawn_headers(obj):
    _both_ways(obj)


def test_codec_rejects_what_is_outside_its_subset():
    for bad in ({1: 2}, object(), 1 + 2j, np.int64(3), {"a": {2.0: 1}}):
        with pytest.raises(TypeError):
            M.packb(bad)
    for bad in (2 ** 64, -2 ** 63 - 1):
        with pytest.raises(ValueError):
            M.packb(bad)
    ext = msgpack.packb(msgpack.ExtType(5, b"abc"))
    for raw in (ext, msgpack.packb(1.5, use_single_float=True),
                msgpack.packb({1: 2}, strict_types=False), b"\xc1",
                msgpack.packb(b"abcdef")[:-2]):
        with pytest.raises(ValueError):
            unpackb(raw)


class _NoBigReads(io.BytesIO):
    """A file that refuses ``read`` of more than a header's worth."""

    def read(self, n=-1):
        assert 0 <= n <= 64, f"read({n}): a bin must come by readinto"
        return super().read(n)


def test_decoder_reads_a_bin_into_one_buffer():
    payload = np.random.default_rng(0).bytes(3 * 2 ** 20)
    f = _NoBigReads(msgpack.packb({"h": 1}) + msgpack.packb(payload))
    objs = list(M.Unpacker(f))
    assert objs[0] == {"h": 1}
    assert isinstance(objs[1], bytearray) and objs[1] == payload


# ---------------------------------------------------------------------------
# records across packages
# ---------------------------------------------------------------------------

def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((33, 17)).astype(np.float32),
            "b": rng.standard_normal(9).astype(np.float32),
            "n": rng.standard_normal((2, 3, 4)).astype(np.float32)}


def _ref_tree(t, dtype=jnp.float32):
    return {k: jnp.asarray(v).astype(dtype) for k, v in t.items()}


def _port_tree(t, dtype=torch.float32):
    return {k: torch.from_numpy(v).to(dtype) for k, v in t.items()}


def _objs(path):
    with open(path, "rb") as f:
        return list(msgpack.Unpacker(f, raw=False, max_buffer_size=2 ** 31))


def _same_file_but_treedef(a, b):
    (ha, *ra), (hb, *rb) = _objs(a), _objs(b)
    assert list(ha) == list(hb)                        # same fields, order
    assert {k: v for k, v in ha.items() if k != "treedef"} == \
        {k: v for k, v in hb.items() if k != "treedef"}
    assert [bytes(r) for r in ra] == [bytes(r) for r in rb]


def _bits(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().tobytes()
    x = np.asarray(x)
    return (x.view(np.uint16) if x.dtype == jnp.bfloat16 else x).tobytes()


def test_tree_records_cross_packages(tmp_path):
    t = _np_tree()
    ref = {"w": jnp.asarray(t["w"]),
           "b": (jnp.asarray(t["b"]).astype(jnp.bfloat16),
                 jnp.arange(5, dtype=jnp.int32)),
           "n": jnp.asarray(t["n"])}
    port = {"w": torch.from_numpy(t["w"]),
            "b": (torch.from_numpy(t["b"]).to(torch.bfloat16),
                  torch.arange(5, dtype=torch.int32)),
            "n": torch.from_numpy(t["n"])}
    RS.save_checkpoint(tmp_path / "r.msgpack", ref, {"step": 7})
    save_checkpoint(tmp_path / "p.msgpack", port, {"step": 7})
    _same_file_but_treedef(tmp_path / "r.msgpack", tmp_path / "p.msgpack")
    got, extra = load_checkpoint(tmp_path / "r.msgpack", port)
    assert extra == {"step": 7}
    for a, b in zip(PF.tree_flatten(got)[0], PF.tree_flatten(port)[0]):
        assert a.dtype == b.dtype and _bits(a) == _bits(b)
    back, _ = RS.load_checkpoint(tmp_path / "p.msgpack", ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype and _bits(a) == _bits(b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_records_cross_packages(tmp_path, dtype):
    t = _np_tree(1)
    rfp = RF.flatten(_ref_tree(t), dtype=getattr(jnp, dtype))
    pfp = PF.flatten(_port_tree(t), dtype=getattr(torch, dtype))
    assert _bits(rfp.buf) == _bits(pfp.buf)
    RS.save_flat_checkpoint(tmp_path / "r.msgpack", rfp, {"v": 3})
    save_flat_checkpoint(tmp_path / "p.msgpack", pfp, {"v": 3})
    _same_file_but_treedef(tmp_path / "r.msgpack", tmp_path / "p.msgpack")
    got, extra = load_flat_checkpoint(tmp_path / "r.msgpack", pfp)
    assert extra == {"v": 3} and got.spec == pfp.spec
    assert got.buf.dtype == pfp.buf.dtype and _bits(got.buf) == _bits(pfp.buf)
    back, _ = RS.load_flat_checkpoint(tmp_path / "p.msgpack", rfp)
    assert back.buf.dtype == rfp.buf.dtype
    assert _bits(back.buf) == _bits(rfp.buf)


def _train_pair(dtype: str, step: int = 7, seed: int = 2):
    """The same (params, m, v, step) in both packages."""
    t = _np_tree(seed)
    rfp = RF.flatten(_ref_tree(t), dtype=getattr(jnp, dtype))
    pfp = PF.flatten(_port_tree(t), dtype=getattr(torch, dtype))
    rng = np.random.default_rng(seed + 100)
    m, v = (rng.standard_normal(pfp.spec.padded).astype(np.float32)
            for _ in range(2))
    ropt = RF.FlatOptState(m=jnp.asarray(m), v=jnp.asarray(np.abs(v)),
                           step=jnp.asarray(step, jnp.int32), spec=rfp.spec)
    popt = PF.FlatOptState(m=torch.from_numpy(m.copy()),
                           v=torch.from_numpy(np.abs(v)), step=step,
                           spec=pfp.spec)
    return (rfp, ropt), (pfp, popt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_records_cross_packages(tmp_path, dtype):
    (rfp, ropt), (pfp, popt) = _train_pair(dtype)
    RS.save_train_checkpoint(tmp_path / "r.msgpack", rfp, ropt, {"step": 7})
    save_train_checkpoint(tmp_path / "p.msgpack", pfp, popt, {"step": 7})
    _same_file_but_treedef(tmp_path / "r.msgpack", tmp_path / "p.msgpack")
    header, record = _objs(tmp_path / "p.msgpack")
    assert header["kind"] == "flat-train" and header["step"] == 7
    assert len(record) == sum(header["lane_bytes"])   # ONE record
    fp, opt, extra = load_train_checkpoint(tmp_path / "r.msgpack", pfp)
    assert extra == {"step": 7} and opt.step == 7
    assert isinstance(opt.step, int)
    assert fp.buf.dtype == pfp.buf.dtype and _bits(fp.buf) == _bits(pfp.buf)
    assert _bits(opt.m) == _bits(popt.m) and _bits(opt.v) == _bits(popt.v)
    rfp2, ropt2, _ = RS.load_train_checkpoint(tmp_path / "p.msgpack", rfp)
    assert int(ropt2.step) == 7
    assert _bits(rfp2.buf) == _bits(rfp.buf)
    assert _bits(ropt2.m) == _bits(ropt.m) and _bits(ropt2.v) == _bits(ropt.v)


def test_kind_layout_and_shard_mismatches_raise(tmp_path):
    (_, _), (pfp, popt) = _train_pair("float32")
    save_train_checkpoint(tmp_path / "train.msgpack", pfp, popt)
    save_flat_checkpoint(tmp_path / "flat.msgpack", pfp)
    with pytest.raises(ValueError, match="train checkpoint"):
        load_flat_checkpoint(tmp_path / "train.msgpack", pfp)
    with pytest.raises(ValueError, match="not a train checkpoint"):
        load_train_checkpoint(tmp_path / "flat.msgpack", pfp)
    other = PF.flatten({"z": torch.zeros(5)})
    for load, name in ((load_train_checkpoint, "train"),
                       (load_flat_checkpoint, "flat")):
        with pytest.raises(ValueError, match="layout mismatch"):
            load(tmp_path / f"{name}.msgpack", other)
    with pytest.raises(ValueError, match="share a layout"):
        save_train_checkpoint(tmp_path / "x.msgpack", pfp,
                              PF.init_opt_state(other.spec, "cpu"))
    # a sharded bus's record (the reference's ShardedTreeSpec)
    t = _np_tree(1)
    RS.save_flat_checkpoint(tmp_path / "sharded.msgpack",
                            RF.flatten_sharded(_ref_tree(t), 2))
    with pytest.raises(ValueError, match="shard-layout"):
        load_flat_checkpoint(tmp_path / "sharded.msgpack",
                             PF.flatten(_port_tree(t)))


def test_load_device_rule(tmp_path, monkeypatch):
    fp = PF.flatten(_port_tree(_np_tree()))
    save_flat_checkpoint(tmp_path / "f.msgpack", fp)
    got, _ = load_flat_checkpoint(tmp_path / "f.msgpack", fp)   # like's
    assert got.buf.device.type == "cpu"
    got, _ = load_flat_checkpoint(tmp_path / "f.msgpack", fp.spec,
                                  device="cpu")
    assert torch.equal(got.buf, fp.buf)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_flat_checkpoint(tmp_path / "f.msgpack", fp.spec)  # the card


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------

def test_manager_retention_latest_step_and_resume(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    t = _port_tree(_np_tree(3))
    for step in (1, 2, 3, 4):
        mgr.save(step, {k: v + step for k, v in t.items()}, {"round": step})
    assert mgr.latest_step() == 4
    assert [p.name for p in sorted(tmp_path.glob("ckpt_*.msgpack"))] == [
        "ckpt_00000003.msgpack", "ckpt_00000004.msgpack"]
    restored, extra, step = CheckpointManager(tmp_path).restore_or_init(
        t, lambda: t)
    assert step == 4 and extra == {"round": 4}
    assert torch.equal(restored["w"], t["w"] + 4)
    fresh, extra, step = CheckpointManager(
        tmp_path / "empty").restore_or_init(t, lambda: "init")
    assert (fresh, extra, step) == ("init", {}, 0)
    # a reference manager reads the port's directory and the other way
    rt, _, rstep = RefManager(tmp_path).restore_or_init(
        _ref_tree(_np_tree(3)), None)
    assert rstep == 4 and _bits(rt["w"]) == _bits(t["w"] + 4)


def test_async_save_snapshot_survives_in_place_write(tmp_path, monkeypatch):
    """The file is written only after the caller has overwritten its
    buffers in place: what lands is still the state ``save`` saw."""
    gate = threading.Event()
    for name in ("save_flat_checkpoint", "save_train_checkpoint"):
        real = getattr(S, name)

        def held(*a, _real=real, **k):
            assert gate.wait(30)
            return _real(*a, **k)

        monkeypatch.setattr(S, name, held)
    mgr = CheckpointManager(tmp_path, keep=5, async_save=True)
    (_, _), (fp, opt) = _train_pair("float32")
    want_p, want_m = fp.buf.clone(), opt.m.clone()
    mgr.save(1, fp, {"k": 1})
    fp.buf.add_(1.0)                     # the next step reuses the buffer
    gate.set()
    mgr.wait()
    got, _ = load_flat_checkpoint(tmp_path / "ckpt_00000001.msgpack", fp)
    assert torch.equal(got.buf, want_p)
    gate.clear()
    mgr.save_train(2, fp.with_buf(want_p.clone()), opt)
    opt.m.mul_(3.0)
    gate.set()
    (fp2, opt2), _, step = mgr.restore_train_or_init(fp, None)
    assert step == 2 and torch.equal(opt2.m, want_m)
    assert torch.equal(fp2.buf, want_p)


def test_async_failure_reraises_at_wait(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(S, "save_flat_checkpoint", boom)
    mgr = CheckpointManager(tmp_path, async_save=True)
    mgr.save(1, PF.flatten(_port_tree(_np_tree())))
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                           # reported once


# ---------------------------------------------------------------------------
# the Coordinator's checkpoint hooks
# ---------------------------------------------------------------------------

def _params(seed=0):
    return PF.flatten({"w": torch.from_numpy(
        np.random.default_rng(seed).standard_normal((64, 32))
        .astype(np.float32))})


def test_coordinator_checkpoint_roundtrip(tmp_path):
    fp = _params()
    coord = Coordinator(VCASGD(0.9), fp)
    lease = coord.issue(cid=0, uid=1, round=0, base=fp)
    coord.submit(lease, fp.buf + 1.0)
    coord.assimilate(lease, coord.deliver(lease), server_version=0)
    mgr = CheckpointManager(tmp_path, async_save=False)
    coord.save_checkpoint(mgr, step=7, extra={"next_uid": 42})
    coord2 = Coordinator(VCASGD(0.9), _params(seed=99))
    assert coord2.restore_checkpoint(mgr) == 7
    assert coord2.restored_extra["next_uid"] == 42
    assert coord2.state.version == coord.state.version == 1
    assert torch.equal(coord2.state.params.buf, coord.state.params.buf)
    coord3 = Coordinator(VCASGD(0.9), _params(seed=5))
    before = coord3.state.params.buf.clone()
    assert coord3.restore_checkpoint(
        CheckpointManager(tmp_path / "empty", async_save=False)) is None
    assert torch.equal(coord3.state.params.buf, before)


def test_restore_rebuilds_scheme_local_state(tmp_path):
    fp = _params()
    coord = Coordinator(EASGDFlatPod(n_replicas=2, beta=0.1), fp)
    mgr = CheckpointManager(tmp_path, async_save=False)
    coord.save_checkpoint(mgr, step=3)
    resumed = Coordinator(EASGDFlatPod(n_replicas=2, beta=0.1),
                          _params(seed=123))
    assert resumed.restore_checkpoint(mgr) == 3
    lease = resumed.issue(cid=0, uid=0, round=0, base=resumed.state.params)
    assert torch.equal(lease.base.buf, fp.buf)
    assert torch.equal(resumed.state.replicas[1], fp.buf)


def test_restore_drops_live_leases_and_the_residual_ledger(tmp_path):
    fp = _params()
    coord = Coordinator(CompressedVCASGD(0.9, density=0.1), fp,
                        timeout_s=10.0)
    mgr = CheckpointManager(tmp_path, async_save=False)
    coord.save_checkpoint(mgr, step=1)
    held = [coord.issue(cid=c, uid=c, round=0, base=fp, now=0.0)
            for c in range(3)]
    coord.submit(held[0], fp.buf + 0.5)
    assert coord.residual_mass() > 0 and coord.transport.in_flight == 1
    assert coord.restore_checkpoint(mgr) == 1
    assert coord.leases == {} and coord._lease_heap == []
    assert all(l.terminal and l.released for l in held)
    assert coord._residuals == {} and coord.residual_mass() == 0.0
    assert coord.transport.in_flight == 0
    assert coord.handout_cache.frames_held == 0
    lease = coord.issue(cid=0, uid=0, round=0, base=coord.state.params)
    assert torch.equal(lease.base.buf, fp.buf)      # reissued from record


def test_server_record_crosses_packages(tmp_path):
    """A reference coordinator's server checkpoint resumes a port
    coordinator (and the other way), params bit for bit, version and
    extra as saved."""
    w = np.random.default_rng(4).standard_normal((64, 32)).astype(np.float32)
    ref = RefCoordinator(RefVCASGD(0.9), RF.flatten({"w": jnp.asarray(w)}))
    lease = ref.issue(cid=0, uid=0, round=0, base=ref.state.params)
    ref.submit(lease, ref.state.params.buf * 0.5)
    ref.assimilate(lease, ref.deliver(lease), server_version=0)
    ref.save_checkpoint(RefManager(tmp_path / "r", async_save=False), 5,
                        extra={"next_uid": 1})
    port = Coordinator(VCASGD(0.9), _params(seed=8))
    assert port.restore_checkpoint(CheckpointManager(tmp_path / "r")) == 5
    assert port.state.version == 1 and port.restored_extra["next_uid"] == 1
    assert _bits(port.state.params.buf) == _bits(ref.state.params.buf)
    port.save_checkpoint(CheckpointManager(tmp_path / "p", async_save=False),
                         6)
    ref2 = RefCoordinator(RefVCASGD(0.9), RF.flatten({"w": jnp.zeros_like(
        jnp.asarray(w))}))
    assert ref2.restore_checkpoint(RefManager(tmp_path / "p")) == 6
    assert ref2.state.version == 1
    assert _bits(ref2.state.params.buf) == _bits(ref.state.params.buf)


# ---------------------------------------------------------------------------
# a REAL kill: SIGKILL the training process mid-run, then restore
# ---------------------------------------------------------------------------

_CHILD = """
import sys, time
sys.path.insert(0, sys.argv[2])
import torch
torch.set_num_threads(1)
from repro_torch.core.simulator import run_preemptible_training
from repro_torch.core.tasks import MLPTask, make_classification_data

task = MLPTask()
data = make_classification_data(n_train=600, n_val=100)
print("READY", flush=True)
run_preemptible_training(task, data, steps=10 ** 9, batch=32, ckpt_every=3,
                         ckpt_dir=sys.argv[1], seed=5, device="cpu",
                         on_step=lambda s: time.sleep(0.01))
"""


@pytest.mark.slow
def test_sigkill_mid_training_restores_and_matches(tmp_path):
    from repro_torch.core.simulator import run_preemptible_training
    from repro_torch.core.tasks import MLPTask, make_classification_data

    ckpt_dir = tmp_path / "ckpt"
    proc = subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(ckpt_dir), str(ROOT / "src")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        assert proc.stdout.readline().strip() == b"READY"
        deadline = time.time() + 60
        while time.time() < deadline:
            time.sleep(0.5)
            if len(list(ckpt_dir.glob("ckpt_*.msgpack"))) >= 3:
                break
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == -signal.SIGKILL
    assert list(ckpt_dir.glob("ckpt_*.msgpack")), (
        "the child wrote no checkpoint before the kill")

    task = MLPTask()
    data = make_classification_data(n_train=600, n_val=100)
    like = PF.flatten(task.init_params(5, device="cpu"))
    (fp, fos), extra, step = CheckpointManager(ckpt_dir).restore_train_or_init(
        like, lambda: None)
    assert step > 0 and step % 3 == 0 and extra["step"] == step
    assert fos.step == step
    horizon = step + 6
    resumed = run_preemptible_training(task, data, steps=horizon, batch=32,
                                       ckpt_every=3, ckpt_dir=ckpt_dir,
                                       seed=5, device="cpu")
    clean = run_preemptible_training(task, data, steps=horizon, batch=32,
                                     ckpt_every=3, ckpt_dir=tmp_path / "clean",
                                     seed=5, device="cpu")
    for s in range(step, horizon):
        assert resumed.losses[s] == clean.losses[s], s
    assert torch.equal(resumed.final_params.buf, clean.final_params.buf)
