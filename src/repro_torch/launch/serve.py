"""Serving driver (port of ``repro/launch/serve.py``): batched prefill,
then greedy decode against the per-layer decode states — the two-tier KV
cache of an attention layer, whose recent ring folds into the old tier
every ``RECENT_RING`` steps, or the O(1) recurrent state of a mamba or
rwkv layer.  One card, no mesh.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch internlm2-1.8b \\
      --batch 4 --prompt-len 2048 --gen 96                # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --reduced --batch 4 --prompt-len 64 --gen 96 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \\
      --reduced --batch 4 --prompt-len 64 --gen 96 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \\
      --batch 4 --prompt-len 376 --gen 72                 # on the card

Prefill runs every attention layer through the hand-written flash
kernel, every rwkv layer's WKV6 recurrence through the hand-written
WKV6 kernel and every mamba layer's selective scan through the
hand-written scan kernel (one launch per layer on the card); decode
(attention against the cache, the one-step recurrences, the MoE's
gathered experts), the norms, rope, the MLPs, the MoE dispatch and the
cache compaction are PyTorch ops, as they are jnp outside any Pallas
kernel in the reference.  The batch is ``make_batch_for``'s: whisper's
prefill encodes its ``frame_embeds``, the VLM's prepends its
``patch_embeds`` (``prompt_len`` counts them).  As in the reference, an
encoder-decoder's ring is never compacted (from step 64 on each step
overwrites the oldest ring slot), and the VLM decodes at
``prompt_len + n_patches + i``: positions start n_patches past the
prompt's last (ROADMAP.md, "Reference defects").  ``serve`` runs a
given ``ModelConfig`` (a caller may cut a published config's depth);
``run`` parses the command line and calls it.  Times are host clocks
around work that ends in ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.data import make_batch_for
from repro_torch.device import resolve_device
from repro_torch.kernels.launches import launch_counts
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import RECENT_RING, DecodeCache, compact_cache
from repro_torch.models.registry import Model, build_model


@dataclass
class ServeResult:
    """What one run did: its configuration, the model state after the
    last step (so a caller can go on decoding), the tokens, the times (s)
    and the kernel launches of each phase."""
    cfg: ModelConfig
    model: Model
    params: dict
    caches: list
    tokens: torch.Tensor               # [b, gen + 1], prefill's then decode's
    next_pos: int                      # position of the last token
    init_s: float                      # weights drawn and placed
    prefill_s: float
    decode_s: float                    # the whole loop, compactions included
    compact_s: float
    compactions: int
    logits_finite: bool
    launches_prefill: Dict[str, int] = field(default_factory=dict)
    launches_decode: Dict[str, int] = field(default_factory=dict)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _delta(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in launch_counts().items()}


def compact_all(caches: List, pos: int) -> List:
    """Fold the recent ring into the old tier for every attention layer;
    other layers' states (mamba's, rwkv's) pass through as they are."""
    return [compact_cache(c, pos) if isinstance(c, DecodeCache) else c
            for c in caches]


def greedy(lg: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return lg[:, :cfg.vocab_size].argmax(-1).to(torch.int32)


def serve(cfg: ModelConfig, batch: int, prompt_len: int, gen: int,
          seed: int = 0, device="cuda") -> ServeResult:
    """Serve ``cfg`` with weights from ``seed``: prefill ``batch`` prompts
    of ``prompt_len`` tokens, then ``gen`` greedy decode steps.  The
    matmul weights are cast to the compute dtype as each layer is placed
    (``Model.init(cast=True)``), so the card never holds them in f32."""
    dev = resolve_device(device)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed, device=dev, cast=True)
    _sync(dev)
    t_init = time.perf_counter() - t0
    inputs = {k: v.to(dev) for k, v in
              make_batch_for(cfg, batch, prompt_len, seed).items()}

    _sync(dev)
    before = launch_counts()
    t0 = time.perf_counter()
    lg, caches = model.prefill(params, inputs)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    launches_prefill = _delta(before)
    print(f"[serve] {cfg.arch}: prefill {batch}x{prompt_len} "
        f"in {t_prefill:.2f}s")

    tok = greedy(lg, cfg)
    finite = torch.isfinite(lg).all()
    out_tokens = [tok]
    compact_s, compactions = 0.0, 0
    compacts = not cfg.is_enc_dec and any(isinstance(c, DecodeCache)
                                          for c in caches)
    prefix = cfg.vision.n_patches if cfg.vision is not None else 0
    pos = prompt_len - 1
    before = launch_counts()
    t0 = time.perf_counter()
    for i in range(gen):
        pos = prompt_len + prefix + i
        lg, caches = model.decode_step(params, caches, tok, pos)
        finite = finite & torch.isfinite(lg).all()
        tok = greedy(lg, cfg)
        out_tokens.append(tok)
        if compacts and (i + 1) % RECENT_RING == 0:
            _sync(dev)
            tc = time.perf_counter()
            caches = compact_all(caches, pos)
            _sync(dev)
            compact_s += time.perf_counter() - tc
            compactions += 1
    _sync(dev)
    dt = time.perf_counter() - t0
    launches_decode = _delta(before)
    print(f"[serve] generated {gen} tokens/seq in {dt:.2f}s "
        f"({gen * batch / max(dt, 1e-9):.1f} tok/s)")
    print(f"[serve] {compactions} compaction(s) in {compact_s:.3f}s")
    toks = torch.stack(out_tokens, 1).cpu()
    print("[serve] sample continuations:")
    for row in toks[: min(4, batch)]:
        print("   ", row[:16].tolist())
    return ServeResult(cfg=cfg, model=model, params=params, caches=caches,
                       tokens=toks, next_pos=pos, init_s=t_init,
                       prefill_s=t_prefill, decode_s=dt, compact_s=compact_s,
                       compactions=compactions,
                       logits_finite=bool(finite),
                       launches_prefill=launches_prefill,
                       launches_decode=launches_decode)


def run(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--greedy", action="store_true", default=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    return serve(cfg, args.batch, args.prompt_len, args.gen, args.seed, dev)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
