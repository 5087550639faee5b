"""Wall time of the simulator's training loop at ``examples/quickstart.py``'s
full configuration on the card, so that two checkouts can be read in
turns.

    python src/repro_torch/benchmarks/quickstart_wall.py [--src DIR] \\
        [--label L] [--epochs 4] [--reps 1]

Needs one CUDA card.  ``--src`` imports ``repro_torch`` from DIR (default:
this checkout's ``src``); run two trees each in its own process (A, B,
B, A).  The configuration is ``chip_smoke.py`` phase 4c's: 5 preemptible
clients, 3 eventual parameter servers, 25 shards of 4,000 rows, VC-ASGD
with the variable alpha, seed 0, cut to ``--epochs`` epochs.  One smoke
run of 1 epoch first builds the kernels and warms the allocator; then
``--reps`` runs, each timed by the host clock around work that ends in
``torch.cuda.synchronize()``.  Prints one JSON line: the card's
``nvidia-smi`` name and power limit, each wall and their median, and the
run's results, client steps, events and kernel launches.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]),
                    help="the src directory to import repro_torch from")
    ap.add_argument("--label", default="", help="a name for this tree")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--reps", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("quickstart_wall needs a CUDA card")
    from repro_torch.core.baselines import VCASGD
    from repro_torch.core.simulator import SimConfig, run_simulation
    from repro_torch.core.tasks import MLPTask, make_classification_data
    from repro_torch.core.vc_asgd import var_alpha
    from repro_torch.kernels.launches import launch_counts

    def run(smoke: bool, epochs: int):
        data = make_classification_data(n_train=800 if smoke else 4000,
                                        n_val=200 if smoke else 800)
        cfg = SimConfig(n_param_servers=3, n_clients=5, tasks_per_client=2,
                        n_shards=8 if smoke else 25, max_epochs=epochs,
                        preemptible=True, mean_lifetime_s=2400.0,
                        consistency="eventual", seed=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_simulation(MLPTask(), data, VCASGD(alpha=var_alpha()), cfg,
                             device="cuda")
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    run(True, 1)
    walls = []
    for _ in range(args.reps):
        before = launch_counts()
        res, wall = run(False, args.epochs)
        walls.append(wall)
        launches = {k: v - before[k] for k, v in launch_counts().items()
                    if v != before[k]}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(json.dumps({
        "label": args.label, "src": args.src, "smi": smi.strip(),
        "device": torch.cuda.get_device_name(0), "epochs": args.epochs,
        "wall_s": walls, "wall_median_s": statistics.median(walls),
        "results": res.results_assimilated, "client_steps": res.client_steps,
        "events": res.events_processed,
        "final_accuracy": res.final_accuracy,
        "launches": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
