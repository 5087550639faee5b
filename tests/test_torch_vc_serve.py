"""Port parity: ``repro_torch.launch.vc_serve`` against the reference's
``repro.launch.vc_serve`` run live, in one process, on the same argv.

The port is handed the reference's initial tree (``params0``) and the
reference's minibatch draws (``InjectedDraws``).  The reference is read
through the names ``repro.launch.vc_serve`` imports — ``Coordinator``,
``Aggregator``, ``HandoutService`` and ``MLPTask`` are swapped for
subclasses that record their instances and the accuracies — never by
editing that module.  Its ``ProcessTransport`` is swapped for a subclass
that holds a lock over each call: the reference's has none, and its
prefetch thread's handout RPCs can interleave with the main thread's
submit on the one socket (seen under a loaded test run: a handout recv
returned an empty frame, WireError).

Held exactly, on each argv set: every ``wire_stats`` field of the hub
and of each edge, ``handout_frames`` / ``handout_bytes``, the upload
frames by kind, ``assimilated`` / ``dropped`` / ``expired``,
``state.version``, the next uid, the checkpoint steps on disk, and the
subscribers' ``bytes_served`` / ``encoded_bytes`` / ``dedup_ratio``.

Held within a tolerance:
* each round's accuracy within 0.02 (measured: equal to 1 f32 ulp);
* the final bus within 1e-5 absolute (measured: <= 1.01e-7 over the four
  argv sets) and every coordinator's ``residual_mass()`` within 1e-5
  relative (measured: 2.3e-8).  Both sides round differently at the ulp
  level (the reference trains under jit) and Adam can turn an ulp into
  an lr-sized step, so the buses are not compared bit for bit.

Resume: the reference's test_vc_serve_resume_rounds_monotonic on the
port; a checkpoint directory written by one package and resumed by the
other, both ways; a SIGKILLed child resumed at a later round with its
steps monotone, nothing rewritten and its broker gone.  And the handout
prefetch: a threaded run equals a run whose pool issues inline, frame
for frame.
"""
import dataclasses
import os
import re
import signal
import subprocess
import sys
import threading
import time
from concurrent.futures import Future
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.launch.vc_serve as RVS
from repro.core.tasks import MLPTask as RefMLP
from repro_torch.launch import vc_serve as PVS
from repro_torch.transfer import transport as PT
from test_torch_tasks import InjectedDraws

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ACC_TOL = 0.02
BUS_TOL = 1e-5
RESIDUAL_RTOL = 1e-5

ARGV_SETS = {
    "smoke": ["--smoke"],
    "smoke-tier": ["--smoke", "--tier"],
    "compressed-sharded-bf16-tier2-subs8": [
        "--density", "0.05", "--shards", "4", "--handout-dtype", "bf16",
        "--tier", "2", "--subscribers", "8"],
    "default": [],
}


def _ref_tree(seed=0):
    p = RefMLP().init_params(jax.random.PRNGKey(seed))
    return {k: np.asarray(v) for k, v in p.items()}


_RefProcessTransport = RVS.ProcessTransport


class _LockedRefTransport(_RefProcessTransport):
    """The reference's broker transport with one lock over each call
    (what the port's ``ProcessTransport`` does itself)."""

    def __init__(self, *a, **k):
        self._call_lock = threading.RLock()
        super().__init__(*a, **k)

    def send(self, frame):
        with self._call_lock:
            return super().send(frame)

    def recv(self, msg_id):
        with self._call_lock:
            return super().recv(msg_id)

    def drop(self, msg_id):
        with self._call_lock:
            return super().drop(msg_id)

    @property
    def in_flight(self):
        with self._call_lock:
            return _RefProcessTransport.in_flight.fget(self)


def _ref_run(monkeypatch, capsys, argv):
    """Run the reference's ``main(argv)``; return its recorded objects
    and its stdout."""
    cap = {"coord": None, "aggs": [], "service": None, "acc": []}

    class Coord(RVS.Coordinator):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            cap["coord"] = self

    class Agg(RVS.Aggregator):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            cap["aggs"].append(self)

    class Svc(RVS.HandoutService):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            cap["service"] = self

    class Task(RVS.MLPTask):
        def evaluate(self, *a):
            acc = super().evaluate(*a)
            cap["acc"].append(acc)
            return acc

    capsys.readouterr()
    with monkeypatch.context() as m:
        for name, cls in (("Coordinator", Coord), ("Aggregator", Agg),
                          ("HandoutService", Svc), ("MLPTask", Task),
                          ("ProcessTransport", _LockedRefTransport)):
            m.setattr(RVS, name, cls)
        assert RVS.main(argv) == 0
    cap["out"] = capsys.readouterr().out
    return cap


def _port_run(argv, capsys=None, **kw):
    if capsys is not None:
        capsys.readouterr()
    run = PVS.run(argv + ["--device", "cpu"], task=InjectedDraws(),
                  params0=_ref_tree(), **kw)
    out = capsys.readouterr().out if capsys is not None else ""
    return run, out


def _counters(c):
    return {"wire": dataclasses.asdict(c.wire_stats),
            "handout": (c.handout_frames, c.handout_bytes),
            "frames": dict(c.frames),
            "leases": (c.assimilated, c.dropped, c.expired),
            "version": c.state.version}


def _steps(d):
    return sorted(int(p.stem.split("_")[1])
                  for p in Path(d).glob("ckpt_*.msgpack"))


def _next_uid(out):
    return int(re.search(r"next uid (\d+)", out).group(1))


@pytest.mark.parametrize("argv", list(ARGV_SETS.values()),
                         ids=list(ARGV_SETS))
def test_vc_serve_matches_reference(argv, tmp_path, monkeypatch, capsys):
    ref = _ref_run(monkeypatch, capsys,
                   argv + ["--ckpt-dir", str(tmp_path / "ref")])
    run, out = _port_run(argv + ["--ckpt-dir", str(tmp_path / "port")],
                         capsys)
    rc, pc = ref["coord"], run.coord
    assert _counters(pc) == _counters(rc)
    assert len(run.aggs) == len(ref["aggs"])
    for pa, ra in zip(run.aggs, ref["aggs"]):
        assert _counters(pa) == _counters(ra)
        assert pa.flushes == ra.flushes
        assert pa.residual_mass() == pytest.approx(ra.residual_mass(),
                                                   rel=RESIDUAL_RTOL)
    assert run.next_uid == _next_uid(ref["out"]) == _next_uid(out)
    assert _steps(tmp_path / "port") == _steps(tmp_path / "ref")
    if ref["service"] is None:
        assert run.service is None
    else:
        ps, rs = run.service, ref["service"]
        assert (ps.pulls, ps.frames_served, ps.bytes_served) == \
            (rs.pulls, rs.frames_served, rs.bytes_served)
        assert pc.handout_cache.encoded_bytes == rc.handout_cache.encoded_bytes
        assert pc.handout_cache.dedup_ratio == rc.handout_cache.dedup_ratio
        assert ps.bytes_served > pc.handout_cache.encoded_bytes > 0
    # the tolerances of the module docstring
    assert len(run.accuracy) == len(ref["acc"])
    np.testing.assert_allclose(run.accuracy, ref["acc"], rtol=0,
                               atol=ACC_TOL)
    assert pc.residual_mass() == pytest.approx(rc.residual_mass(),
                                               rel=RESIDUAL_RTOL)
    np.testing.assert_allclose(pc.state.params.buf.numpy(),
                               np.asarray(rc.state.params.buf), rtol=0,
                               atol=BUS_TOL)
    # the port prints the reference's lines, apart from numbers that come
    # from the floats (accuracy, residual mass) and the clocks
    strip = lambda s: re.sub(r"acc=\S+|mass \S+|\[\S+s\]|p99 \S+|pids?[= ]"
                             r"\[?[\d, ]+\]?|checkpoints in \S+", "", s)
    assert strip(out).splitlines() == strip(ref["out"]).splitlines()


def test_vc_serve_resume_rounds_monotonic(tmp_path, capsys):
    """The reference's resume test on the port: a restarted run continues
    at the checkpointed round with the persisted uid — rounds, wire
    headers and checkpoint steps are monotone, steps 1..k never
    overwritten."""
    d = str(tmp_path)
    assert PVS.main(["--smoke", "--device", "cpu", "--ckpt-dir", d]) == 0
    first = capsys.readouterr().out
    assert "round 0:" in first and "round 1:" in first
    assert PVS.main(["--smoke", "--device", "cpu", "--ckpt-dir", d]) == 0
    second = capsys.readouterr().out
    assert "resumed" in second
    assert "round 2:" in second and "round 3:" in second
    assert "round 0:" not in second                  # never rewinds
    # smoke = 2 rounds x 2 clients per run: uid continues, not restarts
    assert "next uid 8" in second
    assert _steps(d)[-1] == 4                        # advanced past run one


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_resume_across_packages(writer, tmp_path, monkeypatch, capsys):
    """A checkpoint directory written by one package is resumed by the
    other: rounds 2-3, next uid 8, last step 4, and the resumed server
    starts from the written bus."""
    d = str(tmp_path)
    argv = ["--smoke", "--ckpt-dir", d]
    if writer == "reference":
        first = _ref_run(monkeypatch, capsys, argv)["coord"]
        run, second = _port_run(argv, capsys)
    else:
        first = _port_run(argv)[0].coord
        cap = _ref_run(monkeypatch, capsys, argv)
        second = cap["out"]
    assert re.search(rf"resumed server v{first.state.version} from "
                     r"checkpoint step 2 \(continuing at round 2, uid 4\)",
                     second)
    assert "round 2:" in second and "round 3:" in second
    assert "round 0:" not in second and "round 1:" not in second
    assert "next uid 8" in second
    assert _steps(d)[-1] == 4


def _proc_gone(pid: int) -> bool:
    try:
        status = Path(f"/proc/{pid}/status").read_text()
    except FileNotFoundError:
        return True
    return re.search(r"^State:\s+Z", status, re.M) is not None   # exited


def test_sigkilled_server_resumes_and_leaves_no_broker(tmp_path):
    """A child server SIGKILLed after its ``round 2:`` line: its broker
    exits on EOF, and a restarted server resumes past the last
    checkpoint with no gap, no rewritten step and the uid sequence
    continued."""
    d = str(tmp_path)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    cmd = [sys.executable, "-m", "repro_torch.launch.vc_serve", "--device",
           "cpu", "--ckpt-dir", d]
    child = subprocess.Popen(cmd + ["--rounds", "50"], cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, text=True)
    broker = None
    try:
        for line in child.stdout:
            m = re.search(r"broker pid=(\d+)", line)
            if m:
                broker = int(m.group(1))
            if "round 2:" in line:
                break
        child.send_signal(signal.SIGKILL)
    finally:
        child.kill()
        child.wait(timeout=30)
    assert child.returncode == -signal.SIGKILL and broker is not None
    deadline = time.monotonic() + 20
    while not _proc_gone(broker) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert _proc_gone(broker), f"broker {broker} outlived its server"
    before = _steps(d)
    k = before[-1]
    assert k >= 3                     # round 2's checkpoint was written
    kept = {s: Path(d, f"ckpt_{s:08d}.msgpack").read_bytes()
            for s in before}
    out = subprocess.run(cmd + ["--rounds", "2"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert f"from checkpoint step {k} (continuing at round {k}, " \
           f"uid {3 * k})" in out.stdout
    rounds = [int(r) for r in re.findall(r"round (\d+):", out.stdout)]
    assert rounds == [k, k + 1]
    assert f"next uid {3 * (k + 2)}" in out.stdout
    after = _steps(d)
    assert after[-1] == k + 2 and after == list(range(after[0], k + 3))
    for s in set(before) & set(after):                # nothing rewritten
        assert Path(d, f"ckpt_{s:08d}.msgpack").read_bytes() == kept[s]


class _InlinePool:
    """A pool that runs each submit at once, on the caller's thread."""

    def __init__(self, max_workers=None):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def submit(self, fn, *args):
        f = Future()
        f.set_result(fn(*args))
        return f


@pytest.mark.parametrize("argv", [
    ["--density", "0.05", "--shards", "4", "--tier", "2", "--subscribers",
     "4"],
    ["--shards", "2", "--handout-dtype", "bf16", "--tier", "1"]],
    ids=["compressed-tier2", "bf16-tier1"])
def test_prefetch_equals_inline_issue(argv, tmp_path, monkeypatch):
    """The handout prefetch thread changes no frame: a threaded run and a
    run whose pool issues each lease inline send the same frames through
    every broker (as multisets: only the interleaving of a prefetched
    handout with the previous client's upload may differ), reach the
    same counters and the same bus, bit for bit."""
    def run(pool_cls, d):
        sent = []

        class Recording(PT.ProcessTransport):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                self.frames_seen = []
                sent.append(self.frames_seen)

            def send(self, frame):
                self.frames_seen.append(bytes(frame))
                return super().send(frame)

        with monkeypatch.context() as m:
            m.setattr(PVS, "ProcessTransport", Recording)
            m.setattr(PVS, "ThreadPoolExecutor", pool_cls)
            r, _ = _port_run(argv + ["--ckpt-dir", str(d)])
        return r, [sorted(s) for s in sent]

    threaded, frames_t = run(PVS.ThreadPoolExecutor, tmp_path / "t")
    inline, frames_i = run(_InlinePool, tmp_path / "i")
    assert frames_t == frames_i and sum(map(len, frames_t)) > 0
    assert _counters(threaded.coord) == _counters(inline.coord)
    for a, b in zip(threaded.aggs, inline.aggs):
        assert _counters(a) == _counters(b)
    assert torch.equal(threaded.coord.state.params.buf,
                       inline.coord.state.params.buf)
    assert threaded.accuracy == inline.accuracy


def test_vc_serve_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PVS.main(["--smoke"])
