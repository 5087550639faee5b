"""Warm prefill time of a model served at its full published config, on
the card, so that two checkouts can be read in turns.

    python src/repro_torch/benchmarks/serve_prefill.py [--src DIR] \\
        [--label L] [--arch rwkv6-1.6b] [--groups N] [--batch 4] \\
        [--prompt-len 2048] [--reps 5]

Needs one CUDA card.  ``--src`` imports ``repro_torch`` from DIR (default:
this checkout's ``src``); run two trees each in its own process (A, B,
B, A).  ``--groups N`` cuts the config's depth to N repeats of its first
layer group at full width (``--arch jamba-v0.1-52b --groups 1``: the
published 8-layer period once, as ``chip_smoke.py``'s ``jamba_config``
builds it; the whole model does not fit one card).  The weights are the
port's init from seed 0, cast as
``launch/serve.py`` places them; the prompt is ``make_batch_for``'s from
seed 0.  One prefill (cold: the first use of every kernel), then
``--reps`` prefills (warm), each timed by the host clock around work that
ends in ``torch.cuda.synchronize()``.  Prints one JSON line: the device,
the cold ms, each warm ms and their median, and the kernel launches of
one prefill.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]),
                    help="the src directory to import repro_torch from")
    ap.add_argument("--label", default="", help="a name for this tree")
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--groups", type=int, default=0,
                    help="repeats of the first layer group (0: the config's)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=2048)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("serve_prefill needs a CUDA card")
    from repro_torch.configs import get_config
    from repro_torch.models.common import LayerGroup
    from repro_torch.data import make_batch_for
    from repro_torch.kernels.launches import launch_counts
    from repro_torch.models.registry import build_model

    cfg = get_config(args.arch)
    if args.groups:
        cfg = cfg.replace(layer_groups=(
            LayerGroup(cfg.layer_groups[0].blocks, args.groups),))
    model = build_model(cfg)
    params = model.init(0, device="cuda", cast=True)
    tokens = make_batch_for(cfg, args.batch, args.prompt_len, 0)["tokens"]
    tokens = tokens.cuda()

    def prefill() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    before = launch_counts()
    cold = prefill()
    launches = {k: v - before[k] for k, v in launch_counts().items()
                if v != before[k]}
    warm = [prefill() for _ in range(args.reps)]
    print(json.dumps({
        "label": args.label, "src": args.src, "arch": args.arch,
        "groups": args.groups or None,
        "device": torch.cuda.get_device_name(0),
        "batch": args.batch, "prompt_len": args.prompt_len,
        "cold_ms": cold, "warm_ms": warm,
        "warm_median_ms": statistics.median(warm),
        "launches": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
