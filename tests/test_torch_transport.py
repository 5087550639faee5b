"""The port's ``ProcessTransport``: frames cross a real OS process boundary.

* the reference's semantics test (tests/test_protocol.py) on the port:
  out-of-order delivery by id, exactly-once recv, idempotent drop, byte
  accounting;
* a full VC round over the broker equal to the loopback run (the
  reference's test_full_vc_round_over_process_transport, through the
  port's ``run_simulation(..., transport=t, device="cpu")``): the
  transport is invisible to the math, so every trace field, the
  accuracy and the final bus are EQUAL, and every byte count is a sum of
  measured frame lengths;
* a broker that never connects is killed and reaped (the reference's
  tests/test_aggregator.py::test_broker_reaped_when_handshake_times_out);
* a broker whose socket reaches EOF exits by itself (a killed server
  leaves no broker);
* two threads sending and receiving 256 KiB frames at once: every frame
  comes back byte-equal and the stats add up (the lock keeps their
  requests from interleaving on the one socket).
"""
import os
import subprocess
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import flat as F
from repro_torch.core.baselines import VCASGD
from repro_torch.core.simulator import SimConfig, run_simulation
from repro_torch.core.tasks import MLPTask, make_classification_data
from repro_torch.transfer import ProcessTransport, TransportError, wire
from repro_torch.transfer import transport as transport_mod

torch.set_num_threads(2)


def test_process_transport_semantics():
    with ProcessTransport() as t:
        assert t.broker_pid != os.getpid()     # a REAL second process
        frames = [wire.encode(torch.arange(8192, dtype=torch.float32)),
                  b"short-frame"]
        ids = [t.send(f) for f in frames]
        assert t.in_flight == 2
        assert t.recv(ids[1]) == frames[1]     # out-of-order by id
        assert t.recv(ids[0]) == frames[0]
        with pytest.raises(TransportError):
            t.recv(ids[0])                     # exactly-once delivery
        mid = t.send(frames[0])
        t.drop(mid)
        t.drop(mid)                            # idempotent
        assert t.stats.frames_dropped == 1
        assert t.stats.bytes_dropped == len(frames[0])
        assert t.in_flight == 0
        assert t.stats.bytes_sent == t.stats.bytes_recv + t.stats.bytes_dropped
        assert t.rpc_s > 0
    with pytest.raises(TypeError):
        ProcessTransport.send(t, "not bytes")


def test_full_vc_round_over_process_transport():
    """A full VC round (dispatch -> train -> upload -> assimilate) with
    every payload crossing a REAL OS process boundary: results equal the
    loopback run and byte counts equal the wire's frame lengths."""
    task = MLPTask()
    data = make_classification_data(n_train=600, n_val=150, seed=0)
    cfg = SimConfig(n_param_servers=2, n_clients=3, tasks_per_client=2,
                    n_shards=6, max_epochs=1, local_steps=2,
                    subtask_compute_s=120.0, seed=3)
    loop = run_simulation(task, data, VCASGD(0.95), cfg, device="cpu")
    with ProcessTransport() as t:
        proc = run_simulation(task, data, VCASGD(0.95), cfg, device="cpu",
                              transport=t)
        assert t.broker_pid != os.getpid()
        assert t.in_flight == 0
        stats = t.stats
    padded = F.flatten(task.init_params(0, device="cpu")).spec.padded
    per_frame = wire.dense_frame_bytes(padded)
    assert proc.results_assimilated > 0
    # both legs crossed the broker: handout frames at issue + one upload
    # frame per result; totals are sums of the measured frame lengths
    assert proc.handout_frames > 0
    assert proc.handout_bytes == proc.handout_frames * per_frame
    uploads = stats.frames_sent - proc.handout_frames
    assert uploads == proc.results_assimilated + stats.frames_dropped
    assert stats.bytes_sent == proc.handout_bytes + uploads * per_frame
    assert stats.bytes_recv == proc.handout_bytes \
        + proc.results_assimilated * per_frame
    # the transport is invisible to the math: equal to loopback
    assert proc.wall_time_s == loop.wall_time_s
    assert proc.final_accuracy == loop.final_accuracy
    assert proc.results_assimilated == loop.results_assimilated
    assert stats.bytes_sent == loop.wire.bytes_sent
    assert stats.frames_dropped == loop.wire.frames_dropped
    assert torch.equal(proc.scheme_state.params.buf,
                       loop.scheme_state.params.buf)


def test_broker_reaped_when_handshake_times_out(monkeypatch):
    """A broker that spawns but never connects: the constructor raises
    (accept timeout) and must kill AND reap its subprocess."""
    procs = []
    real_popen = subprocess.Popen

    def capturing_popen(*args, **kwargs):
        p = real_popen(*args, **kwargs)
        procs.append(p)
        return p

    monkeypatch.setattr(transport_mod.subprocess, "Popen", capturing_popen)
    monkeypatch.setattr(transport_mod, "_BROKER_SRC",
                        "import time; time.sleep(600)")
    with pytest.raises(OSError):
        ProcessTransport(timeout_s=0.5)
    assert len(procs) == 1
    # killed and waited on: returncode is populated, no zombie left
    assert procs[0].returncode is not None


def test_broker_exits_when_its_server_goes_away():
    """The broker ends on EOF: a server that dies without sending the
    exit op (SIGKILL closes its socket) leaves no broker behind."""
    t = ProcessTransport()
    proc = t._proc
    t.send(b"x" * 1000)
    t._conn.close()                            # as the kernel would
    t._conn = None
    assert proc.wait(timeout=10) == 0
    t.close()


def test_two_threads_share_one_broker():
    """The runtime's prefetch thread and its main thread use one
    transport at once: 2 threads x 24 frames of 256 KiB, each sent and
    received in turn, every frame back byte-equal, ids unique, the stats
    exact."""
    n, size = 24, 256 * 1024
    rng = np.random.default_rng(0)
    payloads = [[rng.integers(0, 256, size, dtype=np.uint8).tobytes()
                 for _ in range(n)] for _ in range(2)]
    got = [[None] * n for _ in range(2)]
    ids = [[None] * n for _ in range(2)]
    errors = []
    with ProcessTransport() as t:
        def worker(w):
            try:
                for i, f in enumerate(payloads[w]):
                    ids[w][i] = t.send(f)
                    got[w][i] = t.recv(ids[w][i])
            except BaseException as e:      # surfaced below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not errors, errors
        assert t.in_flight == 0
        assert got == payloads
        assert len({i for row in ids for i in row}) == 2 * n
        assert t.stats.frames_sent == t.stats.frames_recv == 2 * n
        assert t.stats.bytes_sent == t.stats.bytes_recv == 2 * n * size
