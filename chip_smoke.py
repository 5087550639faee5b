#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch/``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (sm_90a: H100/H200) and the CUDA toolkit's nvcc; run
it from the root of a checkout.  It imports nothing of JAX or of the JAX
package, and exits non-zero (printing no result) on any failure, without
a card, or outside a checkout.  Phases:

1. device   — torch/CUDA versions, the card's name and power limit;
              TF32 off for matmuls and convolutions.
2. build    — nvcc builds every kernel source under
              src/repro_torch/kernels/csrc/ (all at once).
3. parity   — each kernel against its plain PyTorch version on the card,
              at the MLP bus (N = 16,384) and at N = 2^27: Eq. 1 and
              Eq. 2 bit-exact in f32 and bf16 storage (Eq. 2 with 1 and 4
              clients), Adam bit-exact or within 2e-6 relative.  Each
              kernel's time, its plain version's, one PyTorch library
              call's (torch.lerp / torch.addmv / torch._fused_adam_, a
              yardstick the port never calls) and the bound.
4. the main path, through the entry points a user calls:
   a. the quickstart --smoke configuration (examples/quickstart.py:30-45,
      VC-ASGD with var_alpha) on the card and on the CPU from one seed:
      the Eq. 1 launch count equals the results assimilated, the Adam
      count equals the client steps, the event traces are identical and
      each epoch's accuracy agrees within ACC_BAND;
   b. Eq. 2: four clients train from the server copy and return in one
      batch, folded by assimilate_many_flat (one Eq. 2 launch), held
      against folding Eq. 1 four times;
   c. the full quickstart configuration on the card: counts, accuracy
      table, wall time and where the host time goes.
5. a ``kernels`` JSON line, the nvidia-smi line, and the last line
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
CSRC = "src/repro_torch/kernels/csrc/vc_asgd_update.cu"
REPLACES = {
    "vc_asgd_lerp_flat": "src/repro/kernels/vc_asgd_update.py:49",
    "assimilate_flat": "src/repro/kernels/vc_asgd_update.py:69",
    "adam_update_flat": "src/repro/kernels/vc_asgd_update.py:80",
}
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_OPS_PER_S = 67e12            # H100 SXM f32, outside the tensor cores
MAIN_N = 16384                   # the MLP's 13,130 params on the BLOCK bus
BIG_N = 2 ** 27                  # order of the ~100M-parameter demo LM
ADAM_REL_TOL = 2e-6              # tests/test_kernels.py TOL[f32]
ACC_BAND = 0.03                  # card vs CPU epoch accuracy (6 of 200)


class SmokeFailure(SystemExit):
    def __init__(self, msg: str):
        print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
        super().__init__(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls,
    after a warm-up, by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(nbytes: float, ops: float):
    t_mem, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations")


def bits_equal(torch, a, b) -> bool:
    view = torch.int16 if a.dtype in (torch.bfloat16, torch.float16) else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


# ---------------------------------------------------------------------------
# phase 3: kernel parity
# ---------------------------------------------------------------------------

def parity(torch, np, VK, R, n_elems: int, timed: bool) -> dict:
    """Check every kernel against its plain version at ``n_elems``; time
    them (f32) when ``timed``.  Returns per-kernel numbers."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(n_elems)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)
    iters = 50 if n_elems <= MAIN_N else 10
    out = {}

    # B1: Eq. 1
    alpha = 2.0 / 3.0
    for dtype in (torch.float32, torch.bfloat16):
        s, c = rnd(n_elems).to(dtype), rnd(n_elems).to(dtype)
        k, p = VK.vc_asgd_lerp_flat(s, c, alpha), R.vc_asgd_lerp(s, c, alpha)
        torch.cuda.synchronize()
        check(bits_equal(torch, k, p),
              f"Eq. 1 {dtype} N={n_elems}: kernel != plain version")
        say(f"parity B1 vc_asgd_lerp_flat {str(dtype)[6:]} N={n_elems}: bit-exact")
    s, c = rnd(n_elems), rnd(n_elems)
    err = float((VK.vc_asgd_lerp_flat(s, c, alpha)
                 - R.vc_asgd_lerp(s, c, alpha)).abs().max())
    rec = {"max_abs_err": err}
    if timed:
        a32 = float(np.float32(alpha))
        rec["ms"] = time_ms(torch, lambda: VK.vc_asgd_lerp_flat(s, c, alpha), iters)
        rec["plain_ms"] = time_ms(torch, lambda: R.vc_asgd_lerp(s, c, alpha), iters)
        rec["library_ms"] = time_ms(torch, lambda: torch.lerp(c, s, a32), iters)
        rec["bound_ms"], rec["bound_by"] = bound_ms(12 * n_elems, 3 * n_elems)
    out["vc_asgd_lerp_flat"] = rec

    # B2: Eq. 2
    for dtype in (torch.float32, torch.bfloat16):
        for n in (1, 4):
            s, cl = rnd(n_elems).to(dtype), rnd(n, n_elems).to(dtype)
            w = [alpha ** n] + [(1 - alpha) * alpha ** (n - 1 - j) for j in range(n)]
            k, p = VK.assimilate_flat(s, cl, w), R.assimilate(s, cl, w)
            torch.cuda.synchronize()
            check(bits_equal(torch, k, p),
                  f"Eq. 2 {dtype} n={n} N={n_elems}: kernel != plain version")
            say(f"parity B2 assimilate_flat {str(dtype)[6:]} n={n} N={n_elems}: bit-exact")
    n = 4
    s, cl = rnd(n_elems), rnd(n, n_elems)
    w = [alpha ** n] + [(1 - alpha) * alpha ** (n - 1 - j) for j in range(n)]
    err = float((VK.assimilate_flat(s, cl, w) - R.assimilate(s, cl, w)).abs().max())
    rec = {"max_abs_err": err}
    if timed:
        w32 = torch.tensor(np.asarray(w[1:], np.float32), device=dev)
        clt = cl.t()
        w0 = float(np.float32(w[0]))
        rec["ms"] = time_ms(torch, lambda: VK.assimilate_flat(s, cl, w), iters)
        rec["plain_ms"] = time_ms(torch, lambda: R.assimilate(s, cl, w), iters)
        rec["library_ms"] = time_ms(
            torch, lambda: torch.addmv(s, clt, w32, beta=w0), iters)
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            4 * (n + 2) * n_elems, (2 * n + 1) * n_elems)
    out["assimilate_flat"] = rec

    # B3: fused Adam (t = 3: every bias correction term is live)
    t = 3
    c1 = np.float32(1) - np.float32(0.9) ** np.float32(t)
    c2 = np.float32(1) - np.float32(0.999) ** np.float32(t)
    p, gr, m = rnd(n_elems), rnd(n_elems), rnd(n_elems)
    v = rnd(n_elems).abs()
    hyper = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    kern = VK.adam_update_flat(p, gr, m, v, hyper["lr"], hyper["b1"],
                               hyper["b2"], hyper["eps"], 0.0, c1, c2)
    plain = R.adam_update(p, gr, m, v, c1=c1, c2=c2, weight_decay=0.0, **hyper)
    torch.cuda.synchronize()
    err, worst_ulp = 0.0, 0
    for name, a, b in zip(("p", "m", "v"), kern, plain):
        if not bits_equal(torch, a, b):
            ulp = int((a.view(torch.int32).long() - b.view(torch.int32).long())
                      .abs().max())
            rel = float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
            say(f"parity B3 adam lane {name}: {ulp} ulp max, rel {rel:.3g} — "
                f"IEEE ops in the same order on both sides, so a difference "
                f"is a rounding mode the plain path's PyTorch kernel chose")
            check(rel <= ADAM_REL_TOL, f"Adam lane {name} off by rel {rel}")
            worst_ulp = max(worst_ulp, ulp)
        err = max(err, float((a - b).abs().max()))
    say(f"parity B3 adam_update_flat f32 N={n_elems}: "
        + ("bit-exact" if worst_ulp == 0 else f"{worst_ulp} ulp max"))
    rec = {"max_abs_err": err}
    if timed:
        rec["ms"] = time_ms(torch, lambda: VK.adam_update_flat(
            p, gr, m, v, hyper["lr"], hyper["b1"], hyper["b2"], hyper["eps"],
            0.0, c1, c2), iters)
        rec["plain_ms"] = time_ms(torch, lambda: R.adam_update(
            p, gr, m, v, c1=c1, c2=c2, weight_decay=0.0, **hyper), iters)
        lp, lm, lv = p.clone(), m.clone(), v.clone()
        step = [torch.tensor(float(t), device=dev)]
        rec["library_ms"] = time_ms(torch, lambda: torch._fused_adam_(
            [lp], [gr], [lm], [lv], [], step, lr=hyper["lr"],
            beta1=hyper["b1"], beta2=hyper["b2"], weight_decay=0.0,
            eps=hyper["eps"], amsgrad=False, maximize=False), iters)
        rec["bound_ms"], rec["bound_by"] = bound_ms(28 * n_elems, 14 * n_elems)
    out["adam_update_flat"] = rec
    if timed:
        for name, r in out.items():
            say(f"timing {name} N={n_elems}: kernel {r['ms']:.6f} ms")
            say(f"timing {name} N={n_elems}: plain {r['plain_ms']:.6f} ms")
            say(f"timing {name} N={n_elems}: library {r['library_ms']:.6f} ms")
            say(f"timing {name} N={n_elems}: bound {r['bound_ms']:.6f} ms "
                f"({r['bound_by']})")
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

TRACE = ("wall_time_s", "epochs_done", "reassignments", "preemptions",
         "results_assimilated", "handout_frames", "handout_bytes",
         "leases_expired", "leases_dropped", "events_processed",
         "wire_dense_frames", "client_steps")


def quickstart(smoke: bool):
    """(data, SimConfig) of examples/quickstart.py."""
    from repro_torch.core.simulator import SimConfig
    from repro_torch.core.tasks import make_classification_data
    data = make_classification_data(n_train=800 if smoke else 4000,
                                    n_val=200 if smoke else 800)
    cfg = SimConfig(n_param_servers=3, n_clients=5, tasks_per_client=2,
                    n_shards=8 if smoke else 25,
                    max_epochs=2 if smoke else 10, preemptible=True,
                    mean_lifetime_s=2400.0, consistency="eventual", seed=0)
    return data, cfg


def run(device, smoke: bool, task=None):
    from repro_torch.core.baselines import VCASGD
    from repro_torch.core.simulator import run_simulation
    from repro_torch.core.tasks import MLPTask
    from repro_torch.core.vc_asgd import var_alpha
    data, cfg = quickstart(smoke)
    t0 = time.perf_counter()
    res = run_simulation(task or MLPTask(), data, VCASGD(alpha=var_alpha()),
                         cfg, device=device)
    if device == "cuda":
        import torch
        torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def check_counts(VK, res, label: str) -> dict:
    counts = VK.launch_counts()
    say(f"{label}: launches {counts}, results_assimilated "
        f"{res.results_assimilated}, client_steps {res.client_steps}")
    check(counts["vc_asgd_lerp_flat"] == res.results_assimilated > 0,
          f"{label}: Eq. 1 launches {counts['vc_asgd_lerp_flat']} != "
          f"results assimilated {res.results_assimilated}")
    check(counts["adam_update_flat"] == res.client_steps > 0,
          f"{label}: Adam launches {counts['adam_update_flat']} != "
          f"client steps {res.client_steps}")
    return counts


def profile_smoke(torch, VK):
    """The smoke run on the card under torch.profiler: device busy share
    and the top kernels/ops.  Prints "not measured" where the profiler
    saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = run("cuda", smoke=True)
    avgs = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    busy_us = sum(dev_us(e) for e in avgs)
    if busy_us <= 0:
        say("profile: device time not measured (profiler saw none)")
        return
    say(f"profile smoke (profiled wall {wall:.3f} s): device busy "
        f"{busy_us / 1e6:.4f} s = {100 * busy_us / 1e6 / wall:.2f}% of wall")
    for e in sorted(avgs, key=dev_us, reverse=True)[:12]:
        say(f"profile device {dev_us(e) / 1e3:10.3f} ms  x{e.count:<7d} {e.key[:70]}")
    for e in sorted(avgs, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]:
        say(f"profile host   {e.self_cpu_time_total / 1e3:10.3f} ms  "
            f"x{e.count:<7d} {e.key[:70]}")


def host_breakdown(run_fn):
    """Host wall time spent inside each layer of the loop during
    ``run_fn()``: client training, the coordinator's wire legs, the
    server fold and evaluation (each sums to its own sync points, so a
    layer that waits on the device carries the device work before it)."""
    from repro_torch.core.tasks import MLPTask
    from repro_torch.protocol.coordinator import Coordinator
    spans = {}
    targets = [(MLPTask, "client_train"), (MLPTask, "evaluate"),
               (Coordinator, "issue"), (Coordinator, "submit"),
               (Coordinator, "deliver"), (Coordinator, "assimilate")]
    saved = [(cls, name, getattr(cls, name)) for cls, name in targets]

    def timed(key, fn):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            spans[key] = spans.get(key, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    for cls, name, fn in saved:
        setattr(cls, name, timed(f"{cls.__name__}.{name}", fn))
    try:
        result = run_fn()
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)
    return result, spans


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: needs a GPU")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        raise SmokeFailure(f"{SRC / 'repro_torch'} not found: run from the "
                           f"root of a checkout")
    sys.path.insert(0, str(SRC))
    import numpy as np
    from repro_torch.core import vc_asgd as V
    from repro_torch.kernels import build
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import vc_asgd_update as VK

    # ---- 1. device --------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    say(f"nvidia-smi: {smi}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build_all()
    say(f"build: {len(libs)} source(s) in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.build_seconds:.2f} s)")
    for name, log in build.build_log.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                say(f"ptxas {name}: {line.strip()}")

    # ---- 3. kernel parity -------------------------------------------------
    numbers = parity(torch, np, VK, R, MAIN_N, timed=True)
    parity(torch, np, VK, R, BIG_N, timed=True)
    torch.cuda.empty_cache()

    # ---- 4a. quickstart --smoke: card vs CPU ------------------------------
    VK.reset_launch_count()
    res_gpu, wall_gpu = run("cuda", smoke=True)
    check_counts(VK, res_gpu, "smoke on cuda")
    check(VK.launch_count("assimilate_flat") == 0, "Eq. 2 ran in the Eq. 1 loop")
    VK.reset_launch_count()
    res_cpu, wall_cpu = run("cpu", smoke=True)
    check(VK.launch_count() == 0, "the CPU run launched a CUDA kernel")
    say(f"smoke wall: cuda {wall_gpu:.3f} s, cpu {wall_cpu:.3f} s")
    for f in TRACE:
        check(getattr(res_gpu, f) == getattr(res_cpu, f),
              f"trace field {f}: cuda {getattr(res_gpu, f)} != cpu "
              f"{getattr(res_cpu, f)}")
    check(dataclasses.asdict(res_gpu.wire) == dataclasses.asdict(res_cpu.wire),
          "wire stats differ between cuda and cpu")
    check(len(res_gpu.points) == len(res_cpu.points) == 2, "epoch count")
    worst = 0.0
    for a, b in zip(res_gpu.points, res_cpu.points):
        check(a.t_complete == b.t_complete, f"epoch {a.epoch} t_complete")
        worst = max(worst, abs(a.acc_mean - b.acc_mean))
        say(f"smoke epoch {a.epoch}: t {a.t_complete:.3f} s, acc_mean cuda "
            f"{a.acc_mean:.4f} cpu {b.acc_mean:.4f}")
    check(worst <= ACC_BAND, f"acc_mean differs by {worst} > {ACC_BAND}")
    buf = res_gpu.scheme_state.params.buf
    check(bool(torch.isfinite(buf).all()) and buf.shape == (MAIN_N,),
          "server bus not finite or wrong shape")
    say(f"smoke trace identical cuda vs cpu; acc_mean max diff {worst:.4f} "
        f"(band {ACC_BAND})")

    # ---- 4b. Eq. 2: four results folded in one batch -----------------------
    from repro_torch.core import flat as F
    from repro_torch.core.tasks import MLPTask
    data, _ = quickstart(smoke=True)
    task = MLPTask()
    x = torch.from_numpy(data.x_train).cuda()
    y = torch.from_numpy(data.y_train).cuda().long()
    server = res_gpu.scheme_state.params
    alpha = V.var_alpha()(2)
    VK.reset_launch_count()
    trained = [task.client_train(server, x[100 * j:100 * (j + 1)],
                                 y[100 * j:100 * (j + 1)], steps=120, seed=j)
               for j in range(4)]
    merged = V.assimilate_many_flat(server, [server.with_buf(t) for t in trained],
                                    alpha)
    torch.cuda.synchronize()
    eq2_counts = VK.launch_counts()
    say(f"eq2 path: launches {eq2_counts}")
    check(eq2_counts["assimilate_flat"] == 1 and
          eq2_counts["adam_update_flat"] == 4 * 120, "Eq. 2 path launches")
    stacked = F.stack_flats([server.with_buf(t) for t in trained])
    plain = R.assimilate(server.buf, stacked,
                         V.assimilation_weights(4, alpha))
    check(bits_equal(torch, merged.buf, plain), "Eq. 2 path: kernel != plain")
    fold = server
    for t in trained:
        fold = V.vc_asgd_update_flat(fold, t, alpha)
    gap = float((fold.buf - merged.buf).abs().max())
    say(f"eq2 path: Eq. 2 vs Eq. 1 folded 4x max abs diff {gap:.3g}")
    check(gap <= 1e-5, f"Eq. 2 disagrees with the Eq. 1 fold by {gap}")

    # ---- 4c. the full quickstart configuration -----------------------------
    profile_smoke(torch, VK)
    VK.reset_launch_count()
    (res, wall), spans = host_breakdown(lambda: run("cuda", smoke=False))
    main_counts = check_counts(VK, res, "quickstart on cuda")
    check(res.epochs_done == 10 and np.isfinite(res.final_accuracy),
          "quickstart did not finish its 10 epochs")
    say(f"quickstart: {res.results_assimilated} results, {res.client_steps} "
        f"client steps, wall {wall:.3f} s")
    say(f"{'epoch':>6} {'sim hours':>10} {'val acc':>8} {'spread':>7}")
    for p in res.points:
        say(f"{p.epoch:>6} {p.t_complete / 3600:>10.2f} {p.acc_mean:>8.3f} "
            f"±{p.acc_std:.3f}")
    say(f"quickstart final accuracy {res.final_accuracy:.4f}, preemptions "
        f"{res.preemptions}, reassignments {res.reassignments}, wire "
        f"{res.wire.frames_sent} frames / {res.wire.bytes_sent} B")
    for key, sec in sorted(spans.items(), key=lambda kv: -kv[1]):
        say(f"host span {key}: {sec:.3f} s ({100 * sec / wall:.1f}% of wall)")

    # ---- 5. result lines --------------------------------------------------
    kernels = []
    for name in VK.KERNELS:
        r = numbers[name]
        launches = (eq2_counts[name] if name == "assimilate_flat"
                    else main_counts[name])
        check(launches > 0, f"{name} was never launched on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": CSRC,
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
