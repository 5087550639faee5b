"""Where jamba's gradient spread between the port and the JAX package
comes from, on the CPU.

For the reduced jamba-v0.1-52b in f32, it prints:

1. the mamba block alone (block 0 of ``tests/test_torch_lm_loss.py``'s
   setup, one random cotangent): per leaf ||port - ref|| / ||ref||, and
   the reference's own step-by-step scan against its associative one;
2. the whole model's loss gradient (seq 64, batch 2): the worst leaf of
   the reference with only its scan re-associated (the step-by-step
   recurrence of ``ref.mamba_scan`` for the associative scan), of the
   reference at its weights moved by one ulp (a random sign each), and of
   the port, each against the reference;
3. four train steps (``make_train_step``, Adam lr 1e-3, batch 4 x 32, as
   ``tests/test_torch_llm_train.py``): loss and grad norm of the
   reference, of the reference with its scan step by step, and of the
   port;
4. that file's 3 VC rounds (2 islands x 2 steps, a dead island): round
   losses of the port and the reference, and the largest server-leaf
   difference of the port and of the re-associated reference from it.

  PYTHONPATH=src python tools/jamba_grad_spread.py
"""
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import test_torch_llm_train as LT  # noqa: E402
import test_torch_lm_loss as LL  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro.optim import Adam as RefAdam  # noqa: E402
from repro.runtime.train import make_train_step as ref_train_step  # noqa
from repro.runtime.vc_runtime import make_vc_round  # noqa: E402
from repro_torch import convert as C  # noqa: E402
from repro_torch.core import flat as F  # noqa: E402
from repro_torch.models import mamba as PM  # noqa: E402
from repro_torch.optim.optimizers import Adam  # noqa: E402
from repro_torch.runtime.train import make_train_step  # noqa: E402

ARCH = "jamba-v0.1-52b"
REAL_SCAN = JM._chunk_scan


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def step_scan(on: bool) -> None:
    JM._chunk_scan = LL._stepwise_chunk_scan if on else REAL_SCAN


def block_alone() -> None:
    rmodel, _, pmodel, pparams, _ = LL._setup(ARCH)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((LL.BATCH, LL.SEQ, pmodel.cfg.d_model)).astype(
        np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    pp = pparams["blocks"][0]["mamba"]
    rp = {k: jnp.asarray(v.numpy()) for k, v in pp.items()}

    def ref_grad():
        return jax.grad(lambda p: jnp.sum(
            JM.mamba_chunked(p, jnp.asarray(x), rmodel.cfg)[0] * cot))(rp)
    want = ref_grad()
    step_scan(True)
    step = ref_grad()
    step_scan(False)
    req = {k: v.detach().clone().requires_grad_(True) for k, v in pp.items()}
    out, _ = PM.mamba_forward(req, torch.from_numpy(x), pmodel.cfg)
    (out * torch.from_numpy(cot)).sum().backward()
    print("1. the mamba block alone, per leaf against the reference:")
    for k in sorted(pp):
        print(f"   {k:9s} port {rel(req[k].grad, want[k]):.3g}   "
              f"reference step by step {rel(step[k], want[k]):.3g}")


def whole_model() -> None:
    rmodel, rparams, pmodel, pparams, tokens = LL._setup(ARCH)
    loss = jax.jit(jax.grad(lambda p: rmodel.loss(
        p, {"tokens": jnp.asarray(tokens)})[0]))
    to_port = lambda g: F.tree_flatten(C.lm_params_from_reference(
        jax.tree.map(np.asarray, g), pmodel.cfg, "cpu"))[0]
    want = to_port(loss(rparams))
    rng = np.random.default_rng(7)
    moved = jax.tree.map(lambda a: jnp.asarray(
        (np.asarray(a) * (1 + 2.0 ** -24 * rng.choice(
            [-1.0, 1.0], size=np.shape(a)))).astype(np.asarray(a).dtype)),
        rparams)
    ulp = to_port(loss(moved))
    step_scan(True)
    step = to_port(jax.grad(lambda p: rmodel.loss(
        p, {"tokens": jnp.asarray(tokens)})[0])(rparams))
    step_scan(False)
    port = F.tree_flatten(LL._port_value_and_grad(pmodel, pparams,
                                                  tokens)[2])[0]
    worst = lambda got: max(rel(g, w) for g, w in zip(got, want))
    print("2. the whole model's gradient, worst leaf against the reference: "
          f"scan step by step {worst(step):.3g}, weights one ulp off "
          f"{worst(ulp):.3g}, the port {worst(port):.3g}")


def train_steps() -> None:
    print("3. four train steps (loss, grad norm):")
    runs = {}
    for name in ("reference", "reference, scan step by step", "port"):
        step_scan(name.endswith("by step"))
        rmodel, pmodel, rparams, plan, mesh = LT._models(ARCH)
        rng = np.random.default_rng(4)
        if name == "port":
            step = make_train_step(pmodel, optimizer=Adam(lr=LT.LR))
            params = LT._port_tree(rparams, pmodel.cfg)
            state = Adam(lr=LT.LR).init(params)
        else:
            opt = RefAdam(lr=LT.LR)
            step = jax.jit(ref_train_step(rmodel, plan, opt))
            params, state = rparams, opt.init(rparams)
        out = []
        for _ in range(4):
            toks = rng.integers(0, 256, (4, 32)).astype(np.int32)
            if name == "port":
                params, state, m = step(params, state,
                                        {"tokens": torch.from_numpy(toks)})
            else:
                with mesh:
                    params, state, m = step(params, state,
                                            {"tokens": jnp.asarray(toks)})
            out.append((float(m["loss"]), float(m["grad_norm"])))
        runs[name] = out
    step_scan(False)
    for name, out in runs.items():
        print(f"   {name:29s} " + "  ".join(f"{a:.6f} / {b:.4f}"
                                            for a, b in out))


def vc_rounds() -> None:
    losses, got, want, *_ = LT._run_rounds(ARCH, "float32")
    step_scan(True)
    rmodel, _, rparams, plan, mesh = LT._models(ARCH)
    rround = make_vc_round(rmodel, plan, 2, 2, RefAdam(lr=LT.LR))
    server = rparams
    isl = jax.tree.map(lambda s: jnp.stack([s] * 2), rparams)
    opts = jax.vmap(RefAdam(lr=LT.LR).init)(isl)
    rng = np.random.default_rng(0)
    for rnd in range(3):
        toks = rng.integers(0, 256, (2, 2, 4, 32)).astype(np.int32)
        with mesh:
            server, isl, opts, _ = rround(
                server, isl, opts, {"tokens": jnp.asarray(toks)},
                jnp.asarray(0.5, jnp.float32),
                jnp.asarray(np.array([True, rnd != 1])))
    step_scan(False)
    want_t = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), want)
    port = max(float((g.double() - w.double()).abs().max()) for g, w in
               zip(F.tree_flatten(got)[0], F.tree_flatten(want_t)[0]))
    step = max(float(np.abs(np.asarray(x, np.float64)
                            - np.asarray(y, np.float64)).max())
               for x, y in zip(jax.tree.leaves(server),
                               jax.tree.leaves(want)))
    print("4. three VC rounds: losses (reference, port) "
          + ", ".join(f"({r:.6f}, {p:.6f})" for r, p in losses)
          + f"; largest server-leaf difference from the reference: the "
          f"port {port:.3g}, the reference with its scan step by step "
          f"{step:.3g}")


if __name__ == "__main__":
    torch.set_num_threads(2)
    block_alone()
    whole_model()
    train_steps()
    vc_rounds()
