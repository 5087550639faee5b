"""End-to-end on the PyTorch port: train a ~100M-parameter LM for a few
hundred steps with the pod-scale VC-ASGD round (islands, Eq. 2
assimilation, a mid-run island preemption) and restart from the server
checkpoint it wrote.  Counterpart of ``examples/vc_train_llm.py``.

Every step runs on the card: the flash-attention forward and its
backward kernel in each layer, one fused Adam launch a step, one fused
Eq. 2 launch a round.

  PYTHONPATH=src python examples/torch_vc_train_llm.py --rounds 60
  PYTHONPATH=src python examples/torch_vc_train_llm.py --smoke --device cpu
"""
import argparse
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np                                      # noqa: E402
import torch                                            # noqa: E402

from repro_torch.checkpoint import CheckpointManager   # noqa: E402
from repro_torch.core import flat as F                  # noqa: E402
from repro_torch.core.vc_asgd import var_alpha          # noqa: E402
from repro_torch.data import make_batch_for             # noqa: E402
from repro_torch.models.common import (BlockSpec, ModelConfig,  # noqa: E402
                                       uniform_groups)
from repro_torch.models.registry import build_model     # noqa: E402
from repro_torch.optim.optimizers import Adam, cosine_schedule  # noqa: E402
from repro_torch.runtime.vc_runtime import (init_islands,  # noqa: E402
                                            make_vc_round)


def hundred_m_config(d_model: int) -> ModelConfig:
    """~100M params at d_model=640: 10L, ff 2560, 32k vocab (the
    reference example's config)."""
    return ModelConfig(
        arch="demo-100m", family="dense", d_model=d_model,
        n_heads=d_model // 80, n_kv_heads=max(1, d_model // 160),
        d_ff=d_model * 4, vocab_size=32768,
        layer_groups=uniform_groups(10, BlockSpec()),
        norm="rmsnorm", mlp_act="swiglu", max_seq=2048,
        attn_q_block=256, attn_kv_block=256)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--islands", type=int, default=2)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--d-model", type=int, default=640)
    ap.add_argument("--preempt-round", type=int, default=25)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: a fresh temp dir)")
    ap.add_argument("--smoke", action="store_true",
                    help="d_model 160, 4 rounds of 1 step, batch 2 x 32: "
                         "the fast test size")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.smoke:
        args.d_model, args.rounds, args.local_steps = 160, 4, 1
        args.batch, args.seq, args.preempt_round, args.ckpt_every = \
            2, 32, 1, 2

    cfg = hundred_m_config(args.d_model)
    model = build_model(cfg)
    server = F.flatten(model.init(0, device=args.device))
    print(f"[llm] {cfg.describe()}  ({server.spec.n / 1e6:.1f}M params)")
    opt = Adam(lr=cosine_schedule(3e-4, warmup=20,
                                  total=args.rounds * args.local_steps))
    vc_round = make_vc_round(model, args.islands, args.local_steps, opt)
    alpha_fn = var_alpha()
    ckpt_dir = args.ckpt or tempfile.mkdtemp(prefix="vc_llm_ckpt_")
    ckpt = CheckpointManager(ckpt_dir, keep=2)
    islands, opts = init_islands(server, args.islands, opt)

    t_start = time.time()
    for rnd in range(args.rounds):
        toks = [[make_batch_for(cfg, args.batch, args.seq,
                                seed=rnd * 97 + p * 13 + s)["tokens"]
                 for s in range(args.local_steps)]
                for p in range(args.islands)]
        batches = {"tokens": torch.stack([torch.stack(t) for t in toks])}
        surv = np.ones((args.islands,), bool)
        if rnd == args.preempt_round:
            surv[0] = False
            print(f"[llm] round {rnd}: island 0 preempted -> masked")
        alpha = float(np.float32(alpha_fn(rnd + 1)))
        server, islands, opts, m = vc_round(server, islands, opts, batches,
                                            alpha, surv)
        if rnd % 5 == 0 or rnd == args.rounds - 1:
            print(f"[llm] round {rnd:3d} loss={float(m['loss']):.4f} "
                  f"({time.time() - t_start:.0f}s)")
        if (rnd + 1) % args.ckpt_every == 0:
            ckpt.save(rnd + 1, server, {"round": rnd + 1})
    ckpt.wait()

    # restart: a fresh manager (a new process would do the same) restores
    # the newest server record, and the islands restart from it
    restored, extra, step = CheckpointManager(ckpt_dir).restore_or_init(
        server, lambda: None)
    last = (args.rounds // args.ckpt_every) * args.ckpt_every
    if last == args.rounds and not torch.equal(restored.buf, server.buf):
        raise SystemExit("[llm] the restored server differs from the run's")
    islands, opts = init_islands(restored, args.islands, opt)
    print(f"[llm] restart: server of round {extra.get('round', step)} "
          f"restored from {ckpt_dir}, {args.islands} islands rebroadcast")
    print(f"[llm] done in {time.time() - t_start:.0f}s")


if __name__ == "__main__":
    main()
