"""Kill-and-restore training, the serial baseline and the cost model,
held to the reference's.

* ``run_preemptible_training`` killed at steps 13 and 27 (40 steps,
  checkpoints every 10) equals the uninterrupted run bit for bit on the
  CPU: the loss at every step and the final bus; 2 restores, 10
  recomputed steps.  A run resumed from an existing record goes on from
  it.
* Against the reference's ``run_preemptible_training``, with its initial
  params carried across and its minibatch draws
  (``fold_in(PRNGKey(seed + 987654), step)`` / ``randint``) injected:
  ``restores``, ``recomputed_steps``, ``steps_done`` and the set of steps
  are exact; each step's loss within 1e-5 absolute (both sides compute
  the same f32 math, but the reference's is fused under jit and the
  port's is eager, so they round differently in the last bits; measured
  at most 4.8e-7, two f32 ulps of a loss near 2, on these cases).
* ``run_single_instance`` against the reference's, with the same
  injection: each epoch's validation accuracy within 0.02 (measured:
  the same count of correct samples), the simulated epoch times exact.
* ``fleet_cost``, ``preemption_overhead_hours`` and ``cost_bench`` equal
  the reference's live output exactly, and ``cost_bench`` equals
  ``results/BENCH_cost.json``.
* Without ``device="cpu"`` the entry points run on the card, and raise
  without one.
"""
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import cost_model as RC
from repro.core.preemption import KillSchedule as RefKillSchedule
from repro.core.simulator import \
    run_preemptible_training as ref_preemptible
from repro.core.simulator import run_single_instance as ref_single
from repro.core.tasks import MLPTask as RefMLP
from repro.core.tasks import make_classification_data as ref_data
from repro_torch.benchmarks import paper_figs as PFIGS
from repro_torch.convert import params_from_reference
from repro_torch.core import cost_model as PC
from repro_torch.core import flat as PF
from repro_torch.core import simulator as PS
from repro_torch.core.preemption import PAPER_FLEET, KillSchedule
from repro_torch.core.tasks import MLPTask, make_classification_data
from test_torch_tasks import InjectedDraws

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from benchmarks import paper_figs as REF_FIGS  # noqa: E402

torch.set_num_threads(2)
LOSS_TOL = 1e-5


class ReferenceTask(InjectedDraws):
    """The port's MLP started from the reference's initial params and
    drawing its minibatches as the reference does."""

    def init_params(self, seed, device="cuda"):
        p = RefMLP().init_params(jax.random.PRNGKey(seed))
        return PF.unflatten(params_from_reference(
            {k: np.asarray(v) for k, v in p.items()}, device))


def reference_step_indices(seed, step, batch, n):
    """The reference's ``run_preemptible_training`` draw of one step."""
    k = jax.random.fold_in(jax.random.PRNGKey(seed + 987654), step)
    return torch.from_numpy(np.asarray(
        jax.random.randint(k, (batch,), 0, n)).astype(np.int64))


def _preemptible(tmp_path, name, kills=None, **kw):
    args = dict(steps=40, batch=64, ckpt_every=10, seed=3, device="cpu")
    args.update(kw)
    return PS.run_preemptible_training(
        MLPTask(), make_classification_data(n_train=800, n_val=200),
        ckpt_dir=tmp_path / name,
        kill_schedule=KillSchedule.at(*kills) if kills else None, **args)


def test_kill_and_restore_bit_equal_to_clean(tmp_path):
    clean = _preemptible(tmp_path, "clean")
    killed = _preemptible(tmp_path, "killed", kills=(13, 27))
    assert (clean.restores, clean.recomputed_steps, clean.steps_done) == \
        (0, 0, 40)
    assert (killed.restores, killed.recomputed_steps, killed.steps_done) == \
        (2, 10, 40)
    assert clean.trajectory() == killed.trajectory()   # every step, exact
    assert len(clean.losses) == 40
    assert torch.equal(clean.final_params.buf, killed.final_params.buf)
    assert sorted(p.name for p in (tmp_path / "killed").iterdir()) == [
        f"ckpt_{s:08d}.msgpack" for s in (20, 30, 40)]       # keep=3
    # a fresh run over the same directory resumes from step 40's record
    more = _preemptible(tmp_path, "killed", steps=45)
    assert sorted(more.losses) == list(range(40, 45))
    longer = _preemptible(tmp_path, "longer", steps=45)
    assert [more.losses[s] for s in range(40, 45)] == \
        [longer.losses[s] for s in range(40, 45)]


def test_step_batches_depend_on_the_step_alone():
    a = PS.step_batch_indices(3, 17, 64, 800)
    assert a.dtype == torch.int64 and a.shape == (64,)
    assert torch.equal(a, PS.step_batch_indices(3, 17, 64, 800))
    assert not torch.equal(a, PS.step_batch_indices(3, 18, 64, 800))
    assert not torch.equal(a, PS.step_batch_indices(4, 17, 64, 800))
    assert int(a.min()) >= 0 and int(a.max()) < 800


@pytest.mark.parametrize("kills,ckpt_every", [((13, 27), 10), ((5, 6, 33), 4),
                                              ((), 10)])
def test_preemptible_training_matches_reference(tmp_path, monkeypatch, kills,
                                                ckpt_every):
    monkeypatch.setattr(PS, "step_batch_indices", reference_step_indices)
    rdata = ref_data(n_train=800, n_val=200)
    ref = ref_preemptible(RefMLP(), rdata, steps=40, batch=64,
                          ckpt_every=ckpt_every, ckpt_dir=tmp_path / "ref",
                          kill_schedule=RefKillSchedule.at(*kills), seed=3)
    port = PS.run_preemptible_training(
        ReferenceTask(), make_classification_data(n_train=800, n_val=200),
        steps=40, batch=64, ckpt_every=ckpt_every, ckpt_dir=tmp_path / "port",
        kill_schedule=KillSchedule.at(*kills), seed=3, device="cpu")
    for f in ("restores", "recomputed_steps", "steps_done"):
        assert getattr(port, f) == getattr(ref, f), f
    assert sorted(port.losses) == sorted(ref.losses) == list(range(40))
    worst = max(abs(port.losses[s] - ref.losses[s]) for s in range(40))
    assert worst <= LOSS_TOL, worst


def test_single_instance_matches_reference():
    rdata = ref_data(n_train=1000, n_val=300)
    ref = ref_single(RefMLP(), rdata, max_epochs=5, steps_per_epoch=60,
                     seed=2, epoch_time_s=600.0)
    port = PS.run_single_instance(
        ReferenceTask(), make_classification_data(n_train=1000, n_val=300),
        max_epochs=5, steps_per_epoch=60, seed=2, epoch_time_s=600.0,
        device="cpu")
    assert port.client_steps == 300
    for a, b in zip(port.points, ref.points):
        assert (a.epoch, a.t_complete) == (b.epoch, b.t_complete)
        assert abs(a.acc_mean - b.acc_mean) <= 0.02
    assert (port.wall_time_s, port.epochs_done, port.results_assimilated) \
        == (ref.wall_time_s, ref.epochs_done, ref.results_assimilated)
    assert port.points[-1].acc_mean > port.points[0].acc_mean


def test_cost_model_matches_reference():
    for include_server in (False, True):
        for hours in (1.0, 8.0, 3.25):
            a = PC.fleet_cost(PC.paper_p5c5_fleet(), hours, include_server)
            b = RC.fleet_cost(RC.paper_p5c5_fleet(), hours, include_server)
            assert vars(a) == vars(b)
    assert PC.paper_p5c5_fleet() is PAPER_FLEET
    assert [vars(t) for t in PAPER_FLEET] == [vars(t) for t in
                                              RC.paper_p5c5_fleet()]
    assert PC.fleet_cost([], 2.0).saving_frac == 0.0
    for args in ((8.0, 0.5, 5, 120.0, 600.0), (40.0, 0.1, 1, 60.0, 0.0),
                 (3.0, 0.0, 0, 10.0, 10.0)):
        assert PC.preemption_overhead_hours(*args) == \
            RC.preemption_overhead_hours(*args)


def test_cost_bench_matches_reference_and_pin():
    port = PFIGS.cost_bench(True, device="cpu")
    assert port == REF_FIGS.cost_bench(True)
    assert port == json.loads((ROOT / "results" / "BENCH_cost.json")
                              .read_text())
    assert all(port["_claims"].values())


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = make_classification_data(n_train=80, n_val=20)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PS.run_preemptible_training(MLPTask(), data, steps=2,
                                    ckpt_dir=tmp_path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PS.run_single_instance(MLPTask(), data, max_epochs=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PFIGS.fig6_vs_serial(True)
    assert not list(tmp_path.iterdir())          # nothing was written
