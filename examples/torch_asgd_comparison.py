"""Compare VC-ASGD against every baseline scheme the paper discusses —
Downpour, DC-ASGD, persistent-replica EASGD, synchronous BSP, plus the
compressed sparse-frame variant — under an aggressive preemption regime,
on the PyTorch port.  All schemes run through the same typed
Lease/Coordinator protocol (repro_torch.protocol); only the assimilation
algorithm differs.  Reproduces the paper's §IV-C argument: the
cluster-paradigm schemes degrade or stall when clients die; VC-ASGD
doesn't.  Client steps and the server's folds run on the card.

  PYTHONPATH=src python examples/torch_asgd_comparison.py          # full demo
  PYTHONPATH=src python examples/torch_asgd_comparison.py --smoke  # fast size
  PYTHONPATH=src python examples/torch_asgd_comparison.py --smoke --device cpu
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.baselines import (CompressedVCASGD, DCASGD, Downpour,
                                        EASGDPersistent, SyncBSP, VCASGD)
from repro_torch.core.simulator import SimConfig, run_simulation
from repro_torch.core.tasks import MLPTask, make_classification_data
from repro_torch.core.vc_asgd import var_alpha


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="tiny configuration for the fast test gate")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    task = MLPTask()
    data = make_classification_data(n_train=800 if args.smoke else 3000,
                                    n_val=200 if args.smoke else 800)
    n_shards = 8 if args.smoke else 15

    def cfg():
        return SimConfig(n_param_servers=3, n_clients=5, tasks_per_client=2,
                         n_shards=n_shards,
                         max_epochs=2 if args.smoke else 6, local_steps=2,
                         preemptible=True, mean_lifetime_s=1200.0, seed=3)

    schemes = {
        "vc-asgd(0.95)": VCASGD(0.95),
        "vc-asgd(var)": VCASGD(var_alpha()),
        "vc-asgd(0.999)~easgd": VCASGD(0.999),   # §IV-C equivalence
        "vc-asgd-compressed": CompressedVCASGD(0.95, density=0.05),
        "downpour": Downpour(server_lr=0.5),
        "dc-asgd": DCASGD(server_lr=0.5, lam=0.05),
        "easgd-persistent": EASGDPersistent(beta=0.05),
        "sync-bsp": SyncBSP(n_shards),
    }
    print(f"{'scheme':>22} {'hours':>7} {'final acc':>10} "
          f"{'preempt':>8} {'reassigned':>10} {'wire MB':>8}")
    for name, scheme in schemes.items():
        res = run_simulation(task, data, scheme, cfg(), device=args.device)
        print(f"{name:>22} {res.wall_time_s / 3600:>7.2f} "
              f"{res.final_accuracy:>10.3f} {res.preemptions:>8} "
              f"{res.reassignments:>10} {res.wire.bytes_sent / 1e6:>8.1f}")
    print("\nNote how alpha=0.999 (the EASGD-equivalent moving rate) trains "
          "far slower in the\nVC regime — exactly the paper's Fig. 4 "
          "observation — how the barriered BSP\nround time stretches under "
          "preemption while VC-ASGD shrugs it off, and how\nthe compressed "
          "variant ships a fraction of the bytes (sparse wire frames).")
    return 0


if __name__ == "__main__":
    sys.exit(main())
