"""End-to-end VC-ASGD LLM trainer (port of ``repro/launch/train.py``).

The paper's loop at pod scale on one card: client islands, each doing
local steps from the server snapshot, Eq. 2 assimilation between rounds
with island preemption masked out, the epoch-varying alpha schedule, and
checkpoint / restart of the server copy.  The round is
``runtime.vc_runtime.make_vc_round``: the islands are rows of one flat
f32 matrix, each step one B13 forward (and its remat recompute) and one
backward launch a layer, one B3 launch; B2 once a round.

  PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
      --reduced --rounds 20 --local-steps 4 --islands 2 --device cpu

Without ``--device cpu`` it runs on the card (and raises without one).

Checkpoints: after every ``--ckpt-every`` rounds (every round by
default, as the reference), a record whose leaves are, first, the server
in the reference's tree layout (``convert.lm_params_to_reference``) and
then each island's Adam moments m and v, each as a tree of leaves shaped
like this package's parameters (a msgpack bin holds under 4 GiB, and a
whole f32 lane of a 1.1B-parameter bus does not fit one).  The
reference's launcher reads the server leaves and stops there, so either
package resumes from the other's record.  On resume the islands are
rebroadcast from the server; their optimizer states come back from the
record when it holds them (this package's: the resume is then bit-equal
to the run that was not stopped) and start fresh otherwise (a reference
record: what the reference does on every resume).
"""
from __future__ import annotations

import argparse
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch import convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.store import checkpoint_extra, load_checkpoint
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import flat as F
from repro_torch.core.vc_asgd import const_alpha, var_alpha
from repro_torch.data import make_batch_for
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import Mesh
from repro_torch.models.common import ModelConfig
from repro_torch.models.plan import NULL_PLAN, require_one_card_plan
from repro_torch.models.registry import build_model
from repro_torch.optim.optimizers import Adam
from repro_torch.runtime.sharding import MeshPlan
from repro_torch.runtime.vc_runtime import (init_islands, make_vc_round,
                                            redistribute_flat)


@dataclass
class TrainResult:
    """Per round ``{"round", "alpha", "loss", "wall_s"}`` (host clock
    around a round that ends in a device synchronise), the server bus
    after the last round, and the round the run started from."""
    rounds: List[dict]
    server: F.FlatParams
    start_round: int


def _round_batches(cfg: ModelConfig, n_pods: int, local_steps: int,
                   batch: int, seq: int, seed: int) -> dict:
    """Every key of ``make_batch_for``'s batch (``tokens``, and whisper's
    ``frame_embeds`` or the VLM's ``patch_embeds``) stacked
    ``[n_pods, local_steps, ...]`` on the CPU, the reference's draws
    (seed ``seed * 31 + p * 7 + s``)."""
    steps = [[make_batch_for(cfg, batch, seq, seed=seed * 31 + p * 7 + s)
              for s in range(local_steps)] for p in range(n_pods)]
    return {k: torch.stack([torch.stack([b[k] for b in pod])
                            for pod in steps]) for k in steps[0][0]}


def _skeleton(cfg: ModelConfig) -> dict:
    """The port's parameter tree on the meta device: shapes and dtypes,
    no storage, no draws (``Model.param_specs``)."""
    return build_model(cfg).param_specs()


def train(cfg: ModelConfig, *, islands: int = 2, rounds: int = 10,
          local_steps: int = 4, batch: int = 8, seq: int = 128,
          alpha="var", lr: float = 1e-3, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 1, keep: int = 3, preempt_round: int = -1,
          seed: int = 0, device="cuda", plan=NULL_PLAN,
          log: Callable[[str], None] = print) -> TrainResult:
    """Train ``cfg`` (a published config, a reduced one, or one a caller
    cut in depth) for rounds ``[start, rounds)``, resuming from the newest
    record in ``ckpt_dir`` (None: no checkpoints).  The weights are the
    port's init from ``seed``, on ``device`` (the card unless the caller
    names the CPU).  ``plan``: a one-card plan (``models/plan.py``), or
    a mesh plan over one mesh position (``--mesh 1,1``)."""
    dev = resolve_device(device)
    model = build_model(cfg)
    n_pods = islands
    optimizer = Adam(lr=lr)
    alpha_fn = var_alpha() if alpha == "var" else const_alpha(float(alpha))
    vc_round = make_vc_round(model, n_pods, local_steps, optimizer,
                             plan=plan)

    skel = _skeleton(cfg)
    spec = F.tree_spec(skel)
    ref_skel = convert.lm_params_to_reference(skel, cfg)
    opt_skel = [skel] * (2 * n_pods)
    ckpt = CheckpointManager(ckpt_dir, keep=keep) if ckpt_dir else None

    def init_server():
        return F.flatten(model.init(seed, device=dev))

    start, saved_opts = 0, None
    if ckpt is not None and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        path = ckpt.dir / f"ckpt_{start:08d}.msgpack"
        extra = checkpoint_extra(path)
        if "opt_steps" not in extra:                # a reference record
            ref_tree, _ = load_checkpoint(path, ref_skel, dev)
        else:
            (ref_tree, lanes), _ = load_checkpoint(path, [ref_skel, opt_skel],
                                                   dev)
            lanes.reverse()
            saved_opts = [F.FlatOptState(m=F.flatten_like(lanes.pop(), spec),
                                         v=F.flatten_like(lanes.pop(), spec),
                                         step=int(extra["opt_steps"][j]),
                                         spec=spec) for j in range(n_pods)]
        tree = convert.lm_params_from_reference(ref_tree, cfg, dev)
        server = F.flatten(tree)
        del tree, ref_tree
    else:
        server = init_server()
    if saved_opts is None:
        isl, opts = init_islands(server, n_pods, optimizer)
    else:                   # the record's Adam lanes: no fresh ones made
        isl, opts = redistribute_flat(server.buf, n_pods), saved_opts

    log(f"[train] {cfg.describe()}")
    log(f"[train] islands={n_pods} device={dev} resume_round={start}")
    records = []
    for rnd in range(start, rounds):
        t0 = time.perf_counter()
        batches = _round_batches(cfg, n_pods, local_steps, batch, seq,
                                 seed=seed * 7919 + rnd)
        survivors = np.ones((n_pods,), bool)
        if rnd == preempt_round:
            survivors[0] = False        # island 0 preempted this round
            log(f"[train] round {rnd}: island 0 PREEMPTED (masked out of "
                f"assimilation)")
        a = float(np.float32(alpha_fn(rnd + 1)))
        server, isl, opts, metrics = vc_round(server, isl, opts, batches, a,
                                              survivors)
        loss = float(metrics["loss"])       # waits for the round
        wall = time.perf_counter() - t0
        records.append({"round": rnd, "alpha": a, "loss": loss,
                        "wall_s": wall})
        log(f"[train] round {rnd:3d} alpha={a:.3f} loss={loss:.4f} "
            f"({wall:.1f}s)")
        if ckpt is not None and (rnd + 1) % ckpt_every == 0:
            ref_tree = convert.lm_params_to_reference(F.unflatten(server),
                                                      cfg)
            lanes = [t for o in opts for t in (o.leaf_m(), o.leaf_v())]
            ckpt.save(rnd + 1, [ref_tree, lanes],
                      {"round": rnd + 1, "opt_steps": [o.step for o in opts]})
            del ref_tree, lanes
    if ckpt is not None:
        ckpt.wait()
        log(f"[train] done; server checkpoint at {ckpt_dir}")
    return TrainResult(rounds=records, server=server, start_round=start)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU)")
    ap.add_argument("--islands", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--alpha", default="var",
                    help="'var' (paper schedule) or a float")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", default="1,1",
                    help="data,model mesh inside each island: one position "
                         "(1,1); larger meshes wait for the layouts across "
                         "cards")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a fresh temp dir)")
    ap.add_argument("--ckpt-every", type=int, default=1,
                    help="rounds between checkpoints")
    ap.add_argument("--preempt-round", type=int, default=-1,
                    help="simulate island-0 preemption at this round")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    plan = MeshPlan.build(cfg, Mesh(("data", "model"), tuple(
        int(x) for x in args.mesh.split(","))))
    require_one_card_plan(plan)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="vctorch_ckpt_")
    train(cfg, islands=args.islands, rounds=args.rounds,
          local_steps=args.local_steps, batch=args.batch, seq=args.seq,
          alpha=args.alpha, lr=args.lr, ckpt_dir=ckpt_dir,
          ckpt_every=args.ckpt_every, preempt_round=args.preempt_round,
          seed=args.seed, device=args.device, plan=plan,
          log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
