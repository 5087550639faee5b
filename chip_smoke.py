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
              src/repro_torch/kernels/csrc/ (one nvcc each, all at once).
3. parity   — each kernel against its plain PyTorch version on the card,
              at the main path's sizes (the MLP bus, N = 16,384; the
              sparse payload's k = 656 and 1,313) and at N = 2^27
              (k = 0.05 * 2^27 = 6,710,886): Eq. 1 and Eq. 2 bit-exact in
              f32 and bf16 storage (Eq. 2 with 1 and 4 clients), Adam
              bit-exact or within 2e-6 relative, the elastic EASGD round
              bit-exact in f32 and bf16 with 1 and 3 replicas, int8
              quantize / dequantize and the sparse-body pack bit-exact.
              Each kernel's time, its plain version's, one PyTorch
              library call's where one computes the same function
              (torch.lerp / torch.addmv / torch._fused_adam_ / a scale
              multiply / torch.cat of byte views: yardsticks the port
              never calls) and the bound.
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
      table, wall time and where the host time goes;
   d. the pinned replay: the 12 flat MLP cases of
      results/PINNED_sim_regression.json (every server scheme, dense and
      compressed uploads; configurations of tools/pin_sim_regression.py)
      on the card and on the CPU from one seed.  Every event-trace and
      wire field equals the pinned JSON and card equals CPU; accuracy
      agrees card vs CPU within ACC_BAND; each kernel's launches equal
      what the path implies (quantize = pack = compressed submits,
      dequantize = compressed submits + sparse assimilations, EASGD =
      pod barrier rounds, Eq. 1 = VC-ASGD-family assimilations);
   e. the paper's §IV-C comparison at examples/asgd_comparison.py's full
      configuration on the card: the eight schemes' table (hours, final
      accuracy, preemptions, reassignments, wire MB), each scheme's wall
      time and the host share spent in compress_flat and encode_sparse.
6. serve — the port's LLM serving path (launch/serve.py) for the dense
   transformer family:
   a. flash attention (B13) against its plain version at internlm2's
      prefill shape ([4,16/8,2048,128] bf16, causal; timed with its bound
      and torch's scaled_dot_product_attention as the library yardstick,
      which the port never calls), gemma3's local layers (hd 256, window
      1,024, a ragged 2,300 tokens), non-causal cross attention with a
      softcap in f32 and h == kvh at hd 16 (2e-5 in f32, 2e-2 in bf16);
   b. serve.run at internlm2-1.8b's full width (24 layers, 1.89B
      parameters from the port's init, --seed 0): batch 4 x 2,048 prompt
      tokens, 96 greedy decode steps; finite logits, 24 B13 launches in
      prefill, none in decode, one compaction (after step 64); prefill
      and decode times and tokens/s, the compaction's time, and the
      profiler's device-busy share of 32 further decode steps;
   c. the same architecture at full width cut to 2 layers, batch 2 x 256
      prompt tokens and 72 decode steps (one compaction) on the card and
      on the CPU from one draw of the weights, in f32 and in the shipped
      bf16 compute; the f32 card run decodes greedily and the other runs
      are fed its tokens: prefill and every step's logits card vs CPU
      within CMP_TOL; the CPU run launches nothing.
7. serve rwkv6 — launch/serve.py for the SSM family:
   a. the WKV6 recurrence (B14) against its plain version at rwkv6's
      prefill shape ([4,32,2048,64] f32), the reduced head dim (hd 16,
      a ragged 37 steps), T = 1 and [b, T, h, hd] strided views as the
      model passes them (2e-5 on out and the final state); kernel,
      plain and bound ms at each (no PyTorch call computes WKV6);
   b. serve.run at rwkv6-1.6b's full width and depth (24 layers,
      1,599,819,776 parameters from the port's init, --seed 0): batch 4
      x 2,048 prompt tokens, 96 greedy decode steps against the O(1)
      recurrent state; finite logits, 24 B14 launches in prefill, none in
      decode, no compaction; prefill (cold and warm) and decode times,
      tokens/s, peak device memory and the profiler's device-busy share
      of the warm prefill and of 32 further decode steps;
   c. the same architecture at full width cut to 2 layers, batch 2 x 256
      prompt tokens and 72 decode steps on the card and on the CPU from
      the same weights, as 6c.
8. serve jamba — launch/serve.py for the hybrid mamba / attention / MoE
   family:
   a. the selective scan (B15) against its plain version at jamba's
      prefill shape ([4, 2048, 8192], ds 16, u in bf16, dt/B/C in f32),
      the reduced shape (di 128, ds 4, a ragged 37 steps, f32), T = 1,
      and B/C as the column views of an x_proj output the model passes
      (y within 2e-5 in f32 and 2e-2 in bf16, h_T within 2e-5); kernel,
      plain and bound ms at each (the bound counts bytes, the exps at
      the SFU's rate and the FMAs; no PyTorch call computes the scan);
   b. serve.serve at jamba-v0.1's full width cut to one layer group (the
      published 8-layer period: 7 mamba layers, attention at index 4, MoE
      on the odd layers; 13,295,235,072 parameters from the port's init,
      seed 0, cast to bf16 as each layer is placed): batch 4 x 2,048
      prompt tokens, 96 greedy decode steps; finite logits, 7 B15 and 1
      B13 launches in prefill, none in decode, one compaction; init
      seconds, prefill (cold and warm), decode and compaction times,
      tokens/s, peak device memory and the profiler's device-busy share
      of the warm prefill and of 32 further decode steps;
   c. blocks 3 and 4 of the period (mamba + MoE, then attention + dense)
      at full width on the card and on the CPU, as 6c, with the MoE
      routes that differ between card and CPU counted.
9. a ``kernels`` JSON line, the nvidia-smi line, and the last line
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
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
F32_OPS_PER_S = 67e12            # H100 SXM f32, outside the tensor cores
MAIN_N = 16384                   # the MLP's 13,130 params on the BLOCK bus
BIG_N = 2 ** 27                  # order of the ~100M-parameter demo LM
ADAM_REL_TOL = 2e-6              # tests/test_kernels.py TOL[f32]
ACC_BAND = 0.03                  # card vs CPU epoch accuracy (6 of 200)
MAIN_K = (656, 1313)             # sparse payload at densities 0.05 / 0.1
BIG_K = int(BIG_N * 0.05)        # 6,710,886
QBLOCK = 256

# results/PINNED_sim_regression.json's 12 flat MLP cases, with the
# configurations of tools/pin_sim_regression.py:33-62, 90-93:
# name -> (scheme class in repro_torch.core.baselines, its kwargs,
# SimConfig overrides of PIN_BASE).  tests/test_torch_simulator.py holds
# this table to the pin tool's own.
PIN_BASE = dict(n_param_servers=2, n_clients=3, tasks_per_client=2,
                n_shards=8, max_epochs=2, local_steps=2,
                subtask_compute_s=120.0, seed=5)
PIN_DATA = dict(n_train=1500, n_val=300, seed=0)
_PREEMPT = dict(preemptible=True, mean_lifetime_s=900.0, restart_delay_s=60.0)
_TWIN = dict(n_param_servers=1, consistency="strong", tasks_per_client=3,
             n_shards=9, max_epochs=1)
PINNED_CASES = {
    "vc-asgd": ("VCASGD", dict(alpha=0.95), {}),
    "vc-asgd-preempt": ("VCASGD", dict(alpha=0.95), _PREEMPT),
    "vc-asgd-compressed": ("CompressedVCASGD",
                           dict(alpha=0.95, density=0.05), _PREEMPT),
    "downpour": ("Downpour", dict(server_lr=0.5), {}),
    "dc-asgd": ("DCASGD", dict(server_lr=0.5, lam=0.05), {}),
    "easgd-persistent": ("EASGDPersistent", dict(beta=0.05), _PREEMPT),
    "easgd-flat-pod": ("EASGDFlatPod", dict(n_replicas=3, beta=0.05), {}),
    "easgd-flat-pod-compressed": (
        "EASGDFlatPod", dict(n_replicas=3, beta=0.05, compress_density=0.1),
        {}),
    "sync-bsp": ("SyncBSP", dict(n_shards=8), {}),
    "vc-asgd-strong": ("VCASGD", dict(alpha=0.95), dict(consistency="strong")),
    "vc-asgd-contended": ("VCASGD", dict(alpha=0.95),
                          dict(n_param_servers=2, tasks_per_client=4,
                               server_proc_s=45.0)),
    "tier-flat-twin": ("VCASGD", dict(alpha=0.9), _TWIN),
}
# the pinned fields that do not depend on the parameter values
PIN_TRACE = ("wall_time_s", "epochs_done", "results_assimilated",
             "reassignments", "preemptions", "lost_updates", "store_updates",
             "t_complete", "wire_frames_sent", "wire_bytes_sent",
             "wire_frames_recv", "wire_bytes_recv", "wire_frames_dropped",
             "wire_bytes_dropped", "wire_dense_frames", "wire_sparse_frames",
             "wire_handout_frames", "wire_handout_bytes", "leases_expired",
             "leases_dropped")


def pinned_case(name: str):
    """(scheme, SimConfig) of one pinned case, fresh."""
    from repro_torch.core import baselines
    from repro_torch.core.simulator import SimConfig
    cls, kwargs, overrides = PINNED_CASES[name]
    return (getattr(baselines, cls)(**kwargs),
            SimConfig(**{**PIN_BASE, **overrides}))


def pinned_fields(res) -> dict:
    """The pinned fixture's fields of one SimResult (the pin tool's
    run_case, without the accuracy)."""
    return {
        "wall_time_s": float(res.wall_time_s),
        "epochs_done": int(res.epochs_done),
        "results_assimilated": int(res.results_assimilated),
        "reassignments": int(res.reassignments),
        "preemptions": int(res.preemptions),
        "lost_updates": int(res.store_stats.lost_updates),
        "store_updates": int(res.store_stats.updates),
        "t_complete": [float(p.t_complete) for p in res.points],
        "wire_frames_sent": int(res.wire.frames_sent),
        "wire_bytes_sent": int(res.wire.bytes_sent),
        "wire_frames_recv": int(res.wire.frames_recv),
        "wire_bytes_recv": int(res.wire.bytes_recv),
        "wire_frames_dropped": int(res.wire.frames_dropped),
        "wire_bytes_dropped": int(res.wire.bytes_dropped),
        "wire_dense_frames": int(res.wire_dense_frames),
        "wire_sparse_frames": int(res.wire_sparse_frames),
        "wire_handout_frames": int(res.handout_frames),
        "wire_handout_bytes": int(res.handout_bytes),
        "leases_expired": int(res.leases_expired),
        "leases_dropped": int(res.leases_dropped),
    }


def implied_launches(scheme, res) -> dict:
    """The launches of each kernel that a run of ``scheme`` implies."""
    compressed = (getattr(scheme, "density", None) is not None
                  or getattr(scheme, "compress_density", None) is not None)
    submits = res.wire.frames_sent - res.handout_frames
    sparse_submits = submits if compressed else 0
    vc_family = scheme.name.startswith("vc-asgd")
    pod = scheme.name == "easgd-flat-pod"
    return {
        "vc_asgd_lerp_flat": res.results_assimilated if vc_family else 0,
        "assimilate_flat": 0,
        "adam_update_flat": res.client_steps,
        "easgd_elastic_flat": res.scheme_state.version if pod else 0,
        "quantize_int8": sparse_submits,
        "dequantize_int8": sparse_submits + res.wire_sparse_frames,
        "pack_body": sparse_submits,
        "flash_attention": 0,
        "wkv6": 0,
        "mamba_scan": 0,
    }


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


def parity_scheme_kernels(torch, np, KK, R, n_elems: int, ks, timed: bool
                          ) -> dict:
    """The scheme-comparison path's kernels against their plain versions:
    the elastic EASGD round (B5) at ``n_elems`` with 1 and 3 replicas in
    f32 and bf16, int8 quantize / dequantize (B9, B10) and the sparse-body
    pack (B12) at each payload size in ``ks``.  Timed (B5 f32 with 3
    replicas, the codec and pack at ``ks[0]``) when ``timed``."""
    VK, QK, SK = KK
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(n_elems + 7)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)
    iters = 50 if n_elems <= MAIN_N else 10
    out = {}

    # B5: elastic EASGD round, replicas in slot order
    beta = 0.05
    for dtype in (torch.float32, torch.bfloat16):
        for n in (1, 3):
            c, x = rnd(n_elems).to(dtype), rnd(n, n_elems).to(dtype)
            (kc, kx), (pc, px) = (VK.easgd_elastic_flat(c, x, beta),
                                  R.easgd_elastic(c, x, beta))
            torch.cuda.synchronize()
            check(bits_equal(torch, kc, pc) and bits_equal(torch, kx, px),
                  f"EASGD {dtype} n={n} N={n_elems}: kernel != plain version")
            say(f"parity B5 easgd_elastic_flat {str(dtype)[6:]} n={n} "
                f"N={n_elems}: bit-exact")
    n = 3
    c, x = rnd(n_elems), rnd(n, n_elems)
    (kc, kx), (pc, px) = (VK.easgd_elastic_flat(c, x, beta),
                          R.easgd_elastic(c, x, beta))
    rec = {"max_abs_err": max(float((kc - pc).abs().max()),
                              float((kx - px).abs().max())),
           "library_ms": None}
    if timed:
        rec["ms"] = time_ms(torch, lambda: VK.easgd_elastic_flat(c, x, beta),
                            iters)
        rec["plain_ms"] = time_ms(torch, lambda: R.easgd_elastic(c, x, beta),
                                  iters)
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            2 * 4 * (n + 1) * n_elems, (4 * n + 2) * n_elems)
    out["easgd_elastic_flat"] = rec
    del c, x, kc, kx, pc, px

    # B9 / B10 / B12 at each payload size
    for k in ks:
        ng = -(-k // QBLOCK)
        sel = rnd(k) * 0.01
        sel[k // 3] = 0.0
        (kq, ks_), (pq, ps) = QK.quantize_int8(sel), R.quantize_int8(sel)
        torch.cuda.synchronize()
        check(torch.equal(kq, pq) and bits_equal(torch, ks_, ps),
              f"quantize k={k}: kernel != plain version")
        kd, pd = QK.dequantize_int8(kq, ks_, k), R.dequantize_int8(kq, ks_, k)
        torch.cuda.synchronize()
        check(bits_equal(torch, kd, pd), f"dequantize k={k}: kernel != plain")
        idx = torch.arange(k, dtype=torch.int32, device=dev) * 13 + 5
        kb, pb = SK.pack_body(kq, ks_, idx), R.pack_body(kq, ks_, idx)
        torch.cuda.synchronize()
        check(kb.numel() == 5 * k + 4 * ng and torch.equal(kb, pb),
              f"pack_body k={k}: kernel != plain version")
        say(f"parity B9/B10/B12 quantize/dequantize/pack_body k={k}: "
            f"bit-exact")
        if k != ks[0]:
            continue
        recs = {"quantize_int8": {"max_abs_err": float(
                    (kq.float() - pq.float()).abs().max()), "library_ms": None},
                "dequantize_int8": {"max_abs_err": float(
                    (kd - pd).abs().max())},
                "pack_body": {"max_abs_err": float(
                    (kb.int() - pb.int()).abs().max())}}
        if timed:
            q_pad = torch.zeros(ng * QBLOCK, dtype=torch.int8, device=dev)
            q_pad[:k] = kq
            r = recs["quantize_int8"]
            r["ms"] = time_ms(torch, lambda: QK.quantize_int8(sel), iters)
            r["plain_ms"] = time_ms(torch, lambda: R.quantize_int8(sel), iters)
            r["bound_ms"], r["bound_by"] = bound_ms(4 * k + k + 4 * ng, 5 * k)
            r = recs["dequantize_int8"]
            r["ms"] = time_ms(torch, lambda: QK.dequantize_int8(kq, ks_, k),
                              iters)
            r["plain_ms"] = time_ms(
                torch, lambda: R.dequantize_int8(kq, ks_, k), iters)
            r["library_ms"] = time_ms(torch, lambda: torch.mul(
                q_pad.view(ng, QBLOCK), ks_[:, None]), iters)
            r["bound_ms"], r["bound_by"] = bound_ms(k + 4 * ng + 4 * k, k)
            r = recs["pack_body"]
            r["ms"] = time_ms(torch, lambda: SK.pack_body(kq, ks_, idx), iters)
            r["plain_ms"] = time_ms(
                torch, lambda: R.pack_body(kq, ks_, idx), iters)
            r["library_ms"] = time_ms(torch, lambda: torch.cat(
                [kq.view(torch.uint8), ks_.view(torch.uint8),
                 idx.view(torch.uint8)]), iters)
            r["bound_ms"], r["bound_by"] = bound_ms(2 * (5 * k + 4 * ng), 0)
        out.update(recs)
    if timed:
        for name, r in out.items():
            size = f"N={n_elems}" if name == "easgd_elastic_flat" \
                else f"k={ks[0]}"
            say(f"timing {name} {size}: kernel {r['ms']:.6f} ms")
            say(f"timing {name} {size}: plain {r['plain_ms']:.6f} ms")
            lib = r["library_ms"]
            say(f"timing {name} {size}: library "
                + ("none" if lib is None else f"{lib:.6f} ms"))
            say(f"timing {name} {size}: bound {r['bound_ms']:.6f} ms "
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
    and the top kernels/ops."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = run("cuda", smoke=True)
    report_profile(prof, f"smoke (profiled wall {wall:.3f} s)", wall)


def host_breakdown(run_fn, targets=None):
    """Host wall time spent inside each of ``targets`` ((class or module,
    attribute) pairs; by default the layers of the loop: client training,
    the coordinator's wire legs, the server fold and evaluation) during
    ``run_fn()``.  Each sums to its own sync points, so a layer that waits
    on the device carries the device work before it."""
    from repro_torch.core.tasks import MLPTask
    from repro_torch.protocol.coordinator import Coordinator
    spans = {}
    if targets is None:
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
        owner = cls.__name__.rsplit(".", 1)[-1]
        setattr(cls, name, timed(f"{owner}.{name}", fn))
    try:
        result = run_fn()
    finally:
        for cls, name, fn in saved:
            setattr(cls, name, fn)
    return result, spans


def pinned_replay(torch, VK) -> dict:
    """Phase 4d: the 12 flat MLP cases of the pinned fixture on the card
    and on the CPU from one seed.  Returns the card runs' launches summed
    over the cases."""
    from repro_torch.core.simulator import run_simulation
    from repro_torch.core.tasks import MLPTask, make_classification_data
    pin = json.loads((ROOT / "results" / "PINNED_sim_regression.json")
                     .read_text())
    check(pin["base_cfg"] == PIN_BASE and pin["data"] == PIN_DATA,
          "the pinned fixture's base configuration is not the one replayed")
    data = make_classification_data(**PIN_DATA)
    totals = dict.fromkeys(VK.KERNELS, 0)
    for name in PINNED_CASES:
        want = pin["cases"][name]
        runs = {}
        for device in ("cuda", "cpu"):
            scheme, cfg = pinned_case(name)
            VK.reset_launch_count()
            res = run_simulation(MLPTask(), data, scheme, cfg, device=device)
            if device == "cuda":
                torch.cuda.synchronize()
            runs[device] = (scheme, res, VK.launch_counts())
        scheme, res_g, counts = runs["cuda"]
        _, res_c, counts_cpu = runs["cpu"]
        check(sum(counts_cpu.values()) == 0,
              f"pinned {name}: the CPU run launched a CUDA kernel")
        implied = implied_launches(scheme, res_g)
        check(counts == implied, f"pinned {name}: launches {counts} != "
              f"implied by the path {implied}")
        got_g, got_c = pinned_fields(res_g), pinned_fields(res_c)
        for f in PIN_TRACE:
            check(got_g[f] == want[f], f"pinned {name}: {f} on cuda "
                  f"{got_g[f]} != pinned {want[f]}")
            check(got_c[f] == want[f], f"pinned {name}: {f} on cpu "
                  f"{got_c[f]} != pinned {want[f]}")
        accs_g = [p.acc_mean for p in res_g.points] + [res_g.final_accuracy]
        accs_c = [p.acc_mean for p in res_c.points] + [res_c.final_accuracy]
        gap = max(abs(a - b) for a, b in zip(accs_g, accs_c))
        check(gap <= ACC_BAND, f"pinned {name}: accuracy cuda vs cpu {gap}")
        buf = res_g.scheme_state.params.buf
        check(bool(torch.isfinite(buf).all()) and buf.shape == (MAIN_N,),
              f"pinned {name}: server bus not finite or wrong shape")
        say(f"pinned {name}: trace == pin (cuda and cpu), acc gap "
            f"{gap:.4f}, final acc cuda {res_g.final_accuracy:.4f}, "
            f"launches " + ", ".join(f"{k}={v}" for k, v in counts.items()
                                     if v))
        for k, v in counts.items():
            totals[k] += v
    return totals


def comparison(torch, VK) -> None:
    """Phase 4e: examples/asgd_comparison.py's full configuration (3,000
    training rows, 15 shards, 6 epochs, 5 preemptible clients), its eight
    schemes on the card."""
    from repro_torch.core import baselines as B
    from repro_torch.core import compression
    from repro_torch.core.simulator import SimConfig, run_simulation
    from repro_torch.core.tasks import MLPTask, make_classification_data
    from repro_torch.core.vc_asgd import var_alpha
    from repro_torch.transfer import wire
    data = make_classification_data(n_train=3000, n_val=800)
    n_shards = 15
    schemes = {
        "vc-asgd(0.95)": lambda: B.VCASGD(0.95),
        "vc-asgd(var)": lambda: B.VCASGD(var_alpha()),
        "vc-asgd(0.999)~easgd": lambda: B.VCASGD(0.999),
        "vc-asgd-compressed": lambda: B.CompressedVCASGD(0.95, density=0.05),
        "downpour": lambda: B.Downpour(server_lr=0.5),
        "dc-asgd": lambda: B.DCASGD(server_lr=0.5, lam=0.05),
        "easgd-persistent": lambda: B.EASGDPersistent(beta=0.05),
        "sync-bsp": lambda: B.SyncBSP(n_shards),
    }
    say(f"{'scheme':>22} {'hours':>7} {'final acc':>10} {'preempt':>8} "
        f"{'reassigned':>10} {'wire MB':>8} {'wall s':>8} {'steps':>6} "
        f"{'ms/step':>8} {'compress %':>10} {'encode_sparse %':>15}")
    for name, make in schemes.items():
        scheme = make()
        cfg = SimConfig(n_param_servers=3, n_clients=5, tasks_per_client=2,
                        n_shards=n_shards, max_epochs=6, local_steps=2,
                        preemptible=True, mean_lifetime_s=1200.0, seed=3)

        def go():
            t0 = time.perf_counter()
            res = run_simulation(MLPTask(), data, scheme, cfg, device="cuda")
            torch.cuda.synchronize()
            return res, time.perf_counter() - t0

        VK.reset_launch_count()
        (res, wall), spans = host_breakdown(
            go, [(compression, "compress_flat"), (wire, "encode_sparse")])
        counts = VK.launch_counts()
        implied = implied_launches(scheme, res)
        check(counts == implied, f"comparison {name}: launches {counts} != "
              f"implied by the path {implied}")
        check(res.epochs_done == 6 and 0.0 <= res.final_accuracy <= 1.0,
              f"comparison {name}: did not finish its 6 epochs")
        share = lambda key: 100 * spans.get(key, 0.0) / wall
        say(f"{name:>22} {res.wall_time_s / 3600:>7.2f} "
            f"{res.final_accuracy:>10.3f} {res.preemptions:>8} "
            f"{res.reassignments:>10} {res.wire.bytes_sent / 1e6:>8.1f} "
            f"{wall:>8.3f} {res.client_steps:>6} "
            f"{1e3 * wall / res.client_steps:>8.3f} "
            f"{share('compression.compress_flat'):>10.2f} "
            f"{share('wire.encode_sparse'):>15.2f}")


# ---------------------------------------------------------------------------
# phase 6: serve
# ---------------------------------------------------------------------------

BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16, tensor cores
# kernel vs plain: 2e-5 in f32 (the reference's blocked-vs-plain
# tolerance), tests/test_kernels.py TOL in bf16 (outputs rounded to bf16)
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# B13 at the serving path's shape and the family's others:
# (b, h, kvh, sq, skv, hd, dtype, causal, window, softcap)
ATTN_SHAPES = {
    "a internlm2 prefill": (4, 16, 8, 2048, 2048, 128, "bfloat16", True,
                            None, None),
    "b gemma3 local": (2, 8, 4, 2300, 2300, 256, "bfloat16", True, 1024,
                       None),
    "c cross softcap": (1, 4, 4, 333, 517, 64, "float32", False, None, 50.0),
    "d h=kvh hd16": (2, 4, 4, 512, 512, 16, "bfloat16", True, None, None),
}
SERVE_ARGS = ["--arch", "internlm2-1.8b", "--batch", "4", "--prompt-len",
              "2048", "--gen", "96"]
SERVE_LAYERS = 24                # internlm2-1.8b: one B13 launch a layer
PROFILE_STEPS = 32               # decode steps under the profiler
# card vs CPU: internlm2-1.8b's full width, depth cut to 2 layers
CMP_LAYERS, CMP_BATCH, CMP_PROMPT, CMP_STEPS = 2, 2, 256, 72
# logits, card vs CPU: 2e-3 in f32 compute (the reference's own
# prefill/decode tolerance); bf16 as tests/test_torch_models.py states it
CMP_TOL = {"float32": 2e-3, "bfloat16": 0.15}


def attn_pairs(np, sq: int, skv: int, causal: bool, window) -> int:
    """Visible (query, key) pairs: the work this call's masks leave."""
    q = np.arange(sq, dtype=np.int64)
    hi = np.minimum(skv, q + 1) if causal else np.full(sq, skv)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def attention_parity(torch, np, FK, R) -> dict:
    """B13 against its plain version at ATTN_SHAPES; kernel, plain and
    (where one PyTorch call computes the same function) SDPA times and
    the bound at each.  Returns the record of shape (a)."""
    import math
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    out = None
    for name, (b, h, kvh, sq, skv, hd, dt, causal, window,
               softcap) in ATTN_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(sq + hd)
        dtype = getattr(torch, dt)
        q = (torch.randn(b, h, sq, hd, generator=g, device=dev) * 0.5).to(dtype)
        k = (torch.randn(b, kvh, skv, hd, generator=g, device=dev) * 0.5
             ).to(dtype)
        v = torch.randn(b, kvh, skv, hd, generator=g, device=dev).to(dtype)
        kw = dict(causal=causal, window=window, softcap=softcap)
        kern, plain = FK.flash_attention(q, k, v, **kw), R.attention(q, k, v,
                                                                     **kw)
        torch.cuda.synchronize()
        err = float((kern.float() - plain.float()).abs().max())
        tol = ATTN_TOL[dt]
        check(torch.allclose(kern.float(), plain.float(), rtol=tol, atol=tol),
              f"B13 {name}: kernel vs plain max abs err {err} (tol {tol})")
        del kern, plain
        esize = 2 if dt == "bfloat16" else 4
        ops = 4 * hd * b * h * attn_pairs(np, sq, skv, causal, window)
        nbytes = esize * (2 * b * h * sq * hd + 2 * b * kvh * skv * hd)
        peak = BF16_OPS_PER_S if dt == "bfloat16" else F32_OPS_PER_S
        t_mem, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
        rec = {"max_abs_err": err, "bound_ms": 1e3 * max(t_mem, t_ops),
               "bound_by": "bytes" if t_mem >= t_ops else "operations",
               "ms": time_ms(torch, lambda: FK.flash_attention(q, k, v, **kw),
                             10),
               "plain_ms": time_ms(torch, lambda: R.attention(q, k, v, **kw),
                                   3),
               "library_ms": None}
        if window is None and softcap is None:      # SDPA has neither
            rec["library_ms"] = time_ms(torch, lambda: sdpa(
                q, k, v, is_causal=causal, scale=1.0 / math.sqrt(hd),
                enable_gqa=h != kvh), 10)
        torch.cuda.empty_cache()
        lib = rec["library_ms"]
        say(f"B13 {name} [{b},{h}/{kvh},{sq}x{skv},{hd}] {dt} causal={causal} "
            f"window={window} softcap={softcap}: max abs err {err:.3g} "
            f"(tol {tol}); kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, SDPA "
            + ("none" if lib is None else f"{lib:.4f} ms")
            + f", bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
            f"{ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)")
        if out is None:
            out = rec
    return out


def profile_decode(torch, res) -> None:
    """PROFILE_STEPS more decode steps from the serve run's state under
    torch.profiler: the device-busy share of the decode loop."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import greedy
    caches, tok = res.caches, res.tokens[:, -1].cuda()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for j in range(PROFILE_STEPS):
            lg, caches = res.model.decode_step(res.params, caches, tok,
                                               res.next_pos + 1 + j)
            tok = greedy(lg, res.cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_profile(prof, f"decode ({PROFILE_STEPS} steps, profiled wall "
                         f"{wall:.3f} s, {1e3 * wall / PROFILE_STEPS:.3f} "
                         f"ms/step)", wall)


def serve_full_width(torch, VK) -> dict:
    """Phase 6b: launch/serve.py at internlm2-1.8b's full width, batch 4 x
    2,048 prompt tokens, 96 greedy decode steps, weights from the port's
    own init (--seed 0).  Returns the run's launches."""
    from repro_torch.launch import serve
    zero = dict.fromkeys(VK.KERNELS, 0)
    torch.cuda.reset_peak_memory_stats()
    VK.reset_launch_count()
    t0 = time.perf_counter()
    res = serve.run(SERVE_ARGS)
    wall = time.perf_counter() - t0
    counts = VK.launch_counts()
    arg = lambda flag: int(SERVE_ARGS[SERVE_ARGS.index(flag) + 1])
    b, s, gen = arg("--batch"), arg("--prompt-len"), arg("--gen")
    check(res.logits_finite, "serve: non-finite logits")
    check(tuple(res.tokens.shape) == (b, gen + 1)
          and int(res.tokens.max()) < res.cfg.vocab_size
          and int(res.tokens.min()) >= 0, "serve: tokens out of range")
    check(res.launches_prefill == {**zero, "flash_attention": SERVE_LAYERS},
          f"serve: prefill launches {res.launches_prefill}")
    check(res.launches_decode == zero,
          f"serve: decode launches {res.launches_decode}")
    check(res.compactions == 1, f"serve: {res.compactions} compactions")
    check(counts == res.launches_prefill, f"serve: launches {counts}")
    step_s = (res.decode_s - res.compact_s) / gen
    say(f"serve {res.cfg.describe()}")
    say(f"serve prefill {b}x{s}: {1e3 * res.prefill_s:.3f} ms, "
        f"{b * s / res.prefill_s:.1f} tok/s; B13 launches "
        f"{res.launches_prefill['flash_attention']}")
    say(f"serve decode {gen} steps: loop {1e3 * res.decode_s:.3f} ms, "
        f"{1e3 * step_s:.3f} ms/step without compaction, "
        f"{b * gen / res.decode_s:.1f} tok/s; B13 launches "
        f"{res.launches_decode['flash_attention']}")
    say(f"serve compaction: {res.compactions} in {1e3 * res.compact_s:.3f} ms")
    say(f"serve peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f}"
        f" GB; serve.run wall {wall:.3f} s (weight init included)")
    profile_prefill(torch, res, b, s)
    profile_decode(torch, res)
    del res
    torch.cuda.empty_cache()
    return counts


def profile_prefill(torch, res, b: int, s: int) -> None:
    """The serve run's prefill again, warm (its first call includes the
    first use of every kernel): host-clock time, then once more under
    torch.profiler for the device-busy share and the top device items."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import make_batch_for
    tokens = make_batch_for(res.cfg, b, s, 0)["tokens"].cuda()
    go = lambda: res.model.prefill(res.params, {"tokens": tokens})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    go()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        go()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    say(f"serve prefill {b}x{s} warm: {1e3 * warm:.3f} ms, "
        f"{b * s / warm:.1f} tok/s")
    report_profile(prof, f"prefill (profiled wall {wall:.3f} s)", wall)
    torch.cuda.empty_cache()


def report_profile(prof, label: str, wall: float) -> None:
    """Device-busy share of ``wall`` and the top device and host items.
    Busy time sums the device-side events only (kernels, copies, fills):
    the host-side rows of the ops that launched them carry the same time
    again as their own device time."""
    from torch.autograd import DeviceType
    avgs = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
    device = [e for e in avgs if e.device_type == DeviceType.CUDA]
    busy_us = sum(dev_us(e) for e in device)
    if busy_us <= 0:
        say(f"profile {label}: device time not measured (profiler saw none)")
        return
    say(f"profile {label}: device busy {busy_us / 1e3:.3f} ms = "
        f"{100 * busy_us / 1e6 / wall:.2f}% of wall")
    for e in sorted(device, key=dev_us, reverse=True)[:10]:
        say(f"profile device {dev_us(e) / 1e3:10.3f} ms  x{e.count:<6d} "
            f"{e.key[:70]}")
    for e in sorted(avgs, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:6]:
        say(f"profile host   {e.self_cpu_time_total / 1e3:10.3f} ms  "
            f"x{e.count:<6d} {e.key[:70]}")


def depth_cut(arch: str, n_layers: int = CMP_LAYERS):
    """``arch`` at full width, its first block repeated ``n_layers`` times
    (a uniform stack: the dense family, rwkv6)."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import uniform_groups
    full = get_config(arch)
    return full.replace(layer_groups=uniform_groups(n_layers,
                                                    full.all_blocks[0]))


def _tree_to(node, dev):
    """A parameter tree of dicts and lists with every tensor on ``dev``."""
    if isinstance(node, dict):
        return {k: _tree_to(v, dev) for k, v in node.items()}
    if isinstance(node, list):
        return [_tree_to(v, dev) for v in node]
    return node.to(dev)


# A (token, layer) MoE route that differs between card and CPU must be a
# near-tie: the CPU's router log-probabilities of the experts swapped
# differ by at most 2^-4, four bf16 ulps of a router logit below 4 (bf16
# rounds the logits before the softmax, and card and CPU round their
# inputs in different places)
ROUTE_TIE_GAP = 2.0 ** -4


class RouteLog:
    """Records each MoE router call (``layers.route``) of a run, in call
    order: the router's probabilities and the experts it picks.  With
    ``replay`` (another run's log of the same schedule) the run is fed
    that run's experts instead, as a run is fed another's tokens: it
    gates them with its own probabilities, renormalised as ``route``
    does, and its own picks are still recorded."""

    def __init__(self, replay=None):
        self.probs, self.calls, self.replay = [], [], replay

    def __enter__(self):
        from repro_torch.models import layers as L
        self._L, self._route = L, L.route

        def spy(p, x, cfg):
            probs, top_p, top_i = self._route(p, x, cfg)
            self.probs.append(probs.cpu())
            self.calls.append(top_i.cpu())
            if self.replay is not None:
                top_i = self.replay.calls[len(self.calls) - 1].to(
                    top_i.device)
                top_p = probs.gather(-1, top_i)
                top_p = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
            return probs, top_p, top_i
        L.route = spy
        return self

    def __exit__(self, *exc):
        self._L.route = self._route


def routes_differing(ref: "RouteLog", run: "RouteLog") -> tuple:
    """(routes whose expert sets differ between the two runs, routes
    compared, the largest log-probability gap under ``run``'s router
    between an expert only ``run`` picked and one only ``ref`` picked)."""
    import torch
    diff = total = 0
    gap = 0.0
    for a, b, probs in zip(ref.calls, run.calls, run.probs):
        a, b = a.reshape(-1, a.shape[-1]), b.reshape(-1, b.shape[-1])
        logp = probs.reshape(-1, probs.shape[-1]).clamp(min=1e-30).log()
        rows = (a.sort(-1).values != b.sort(-1).values).any(-1)
        diff += int(rows.sum())
        total += a.shape[0]
        for r in torch.nonzero(rows).flatten().tolist():
            only_run = [e for e in b[r].tolist() if e not in a[r].tolist()]
            only_ref = [e for e in a[r].tolist() if e not in b[r].tolist()]
            gap = max(gap, float(logp[r, only_run].min()
                                 - logp[r, only_ref].max()))
    return diff, total, gap


def serve_card_vs_cpu(torch, VK, cut, launches: dict) -> None:
    """Phases 6c, 7c and 8c: the depth-cut config ``cut`` (full width) at
    batch 2 x 256 prompt tokens, then 72 decode steps (across step 64,
    where attention caches are compacted), on the card and on the CPU
    from one set of weights (drawn once, in f32), in f32 and in the
    shipped bf16 compute.  The f32 card run decodes greedily; the other
    three runs are fed its tokens, so every run sees one schedule, and an
    MoE's CPU run is fed the card's expert routes (RouteLog): a route
    that differs is a discrete choice at a near-tie, which would move
    that token's output by a whole expert's.  Prefill and every step's
    logits compared card vs CPU; every route that differs must be a
    near-tie (ROUTE_TIE_GAP); the card's prefill launches ``launches``,
    the CPU run nothing.  Also reported: each bf16 run's distance from
    the CPU's f32 logits."""
    from repro_torch.data import make_batch_for
    from repro_torch.launch.serve import compact_all, greedy
    from repro_torch.models.layers import RECENT_RING
    from repro_torch.models.registry import build_model
    t0 = time.perf_counter()
    master = build_model(cut).init(0, device="cpu")     # parameter dtype
    tokens = make_batch_for(cut, CMP_BATCH, CMP_PROMPT, 0)["tokens"]
    t_init = time.perf_counter() - t0
    fed, f32_cpu = [], None
    for dt in ("float32", "bfloat16"):
        cfg = cut.replace(compute_dtype=dt)
        model = build_model(cfg)
        p_cpu = model.compute_params(master)
        p_gpu = _tree_to(p_cpu, torch.device("cuda"))
        runs = {}
        for run, dev, params in (("card", "cuda", p_gpu),
                                 ("cpu", "cpu", p_cpu)):
            VK.reset_launch_count()
            t0 = time.perf_counter()
            replay = runs["card"][3] if run == "cpu" else None
            with RouteLog(replay) as routes:
                lg, caches = model.prefill(params,
                                           {"tokens": tokens.to(dev)})
                logits = [lg.float().cpu()]
                for i in range(CMP_STEPS):
                    if len(fed) == i:       # the f32 card run's greedy
                        fed.append(greedy(lg, cfg).cpu())
                    lg, caches = model.decode_step(
                        params, caches, fed[i].to(dev), CMP_PROMPT + i)
                    logits.append(lg.float().cpu())
                    if (i + 1) % RECENT_RING == 0:
                        caches = compact_all(caches, CMP_PROMPT + i)
            runs[run] = (logits, VK.launch_counts(),
                         time.perf_counter() - t0, routes)
        g_logits, g_counts, g_wall, g_routes = runs["card"]
        c_logits, c_counts, c_wall, c_routes = runs["cpu"]
        check(g_counts == {**dict.fromkeys(VK.KERNELS, 0), **launches},
              f"card vs cpu {dt}: card launches {g_counts}")
        check(sum(c_counts.values()) == 0,
              f"card vs cpu {dt}: the CPU run launched {c_counts}")
        v = cfg.vocab_size
        dist = lambda xs, ys: [float((a[:, :v] - b[:, :v]).abs().max())
                               for a, b in zip(xs, ys)]
        errs = dist(g_logits, c_logits)
        scale = max(float(a[:, :v].abs().max()) for a in g_logits)
        agree = sum(bool(torch.equal(a[:, :v].argmax(-1), b[:, :v].argmax(-1)))
                    for a, b in zip(g_logits, c_logits))
        finite = all(bool(torch.isfinite(a).all()) for a in g_logits)
        worst = max(range(CMP_STEPS), key=lambda i: errs[1 + i])
        say(f"card vs cpu {cut.arch} {dt} ({cut.n_layers} layers "
            f"{''.join(b.short() for b in cut.all_blocks)}, "
            f"{CMP_BATCH}x{CMP_PROMPT} + {CMP_STEPS} steps): logits max abs "
            f"err prefill {errs[0]:.4g}, decode {max(errs[1:]):.4g} (step "
            f"{worst}), mean over steps {sum(errs) / len(errs):.4g}; "
            f"logit scale {scale:.3f}; argmax equal in {agree}/{len(errs)} "
            f"steps; wall card {g_wall:.2f} s, cpu {c_wall:.2f} s, init "
            f"{t_init:.2f} s; tol {CMP_TOL[dt]}")
        if g_routes.calls:
            diff, total, gap = routes_differing(g_routes, c_routes)
            say(f"card vs cpu {cut.arch} {dt}: {diff} of {total} (token, "
                f"layer) MoE routes differ (the CPU fed the card's); "
                f"largest log-probability gap of a differing route {gap:.4g}"
                f" (near-tie bound {ROUTE_TIE_GAP})")
            check(gap <= ROUTE_TIE_GAP,
                  f"card vs cpu {dt}: an MoE route differs by a "
                  f"log-probability gap of {gap} > {ROUTE_TIE_GAP}")
        if dt == "float32":
            f32_cpu = c_logits
        else:
            for run, xs in (("card", g_logits), ("cpu", c_logits)):
                e = dist(xs, f32_cpu)
                say(f"card vs cpu {cut.arch}: {run} bf16 vs cpu f32 logits "
                    f"max abs err {max(e):.4g}, mean over steps "
                    f"{sum(e) / len(e):.4g}")
        check(finite, f"card vs cpu {dt}: non-finite card logits")
        check(max(errs) <= CMP_TOL[dt],
              f"card vs cpu {dt}: logits differ by {max(errs)} > "
              f"{CMP_TOL[dt]}")
        del p_gpu, p_cpu, runs
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 7: serve rwkv6
# ---------------------------------------------------------------------------

WKV_TOL = 2e-5                   # the reference's test_wkv6 tolerance
# B14 at the serving path's prefill shape and the others:
# (b, h, T, hd, [b, T, h, hd] strided views)
WKV_SHAPES = {
    "a rwkv6 prefill": (4, 32, 2048, 64, False),
    "b reduced hd16 ragged": (2, 4, 37, 16, False),
    "c T=1": (4, 32, 1, 64, False),
    "d strided views": (4, 32, 2048, 64, True),
}
RWKV_ARGS = ["--arch", "rwkv6-1.6b", "--batch", "4", "--prompt-len",
             "2048", "--gen", "96"]
RWKV_LAYERS = 24                 # rwkv6-1.6b: one B14 launch a layer
RWKV_PARAMS = 1_599_819_776      # the published config's parameter count


def wkv6_parity(torch, WK, R) -> dict:
    """B14 against its plain version at WKV_SHAPES (out and the final
    state); kernel, plain and bound ms at each.  Returns the record of
    shape (a)."""
    dev = torch.device("cuda")
    out = None
    for name, (b, h, T, hd, strided) in WKV_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(T + hd)
        shape = (b, T, h, hd) if strided else (b, h, T, hd)
        rnd = lambda: torch.randn(*shape, generator=g, device=dev)
        args = [rnd() * 0.4, rnd() * 0.4, rnd(),
                torch.sigmoid(rnd()) * 0.6 + 0.35]      # w in (0.35, 0.95)
        if strided:
            args = [t.transpose(1, 2) for t in args]
        args.append(torch.randn(h, hd, generator=g, device=dev) * 0.2)
        (o, S), (o_p, S_p) = WK.wkv6(*args), R.wkv6(*args)
        torch.cuda.synchronize()
        err = max(float((o - o_p).abs().max()), float((S - S_p).abs().max()))
        check(torch.allclose(o, o_p, rtol=WKV_TOL, atol=WKV_TOL)
              and torch.allclose(S, S_p, rtol=WKV_TOL, atol=WKV_TOL),
              f"B14 {name}: kernel vs plain max abs err {err} (tol "
              f"{WKV_TOL})")
        del o, S, o_p, S_p
        n = b * h * T * hd
        nbytes = 4 * (5 * n + b * h * hd * hd + h * hd)
        ops = 2 * 3 * n * hd                # 3 FMAs per (i, j) and step
        bound, by = bound_ms(nbytes, ops)
        rec = {"max_abs_err": err, "bound_ms": bound, "bound_by": by,
               "ms": time_ms(torch, lambda: WK.wkv6(*args), 10),
               "plain_ms": time_ms(torch, lambda: R.wkv6(*args), 1),
               "library_ms": None}      # no PyTorch call computes WKV6
        say(f"B14 {name} [{b},{h},{T},{hd}]{' strided' if strided else ''}"
            f" f32: max abs err {err:.3g} (tol {WKV_TOL}); kernel "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library "
            f"none, bound {bound:.4f} ms ({by}: {ops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB)")
        if out is None:
            out = rec
        del args
    torch.cuda.empty_cache()
    return out


def serve_rwkv_full_width(torch, VK) -> dict:
    """Phase 7b: launch/serve.py at rwkv6-1.6b's full width and depth,
    batch 4 x 2,048 prompt tokens, 96 greedy decode steps against the
    recurrent state, weights from the port's own init (--seed 0).
    Returns the run's launches."""
    from repro_torch.launch import serve
    from repro_torch.models.rwkv import RWKVState
    zero = dict.fromkeys(VK.KERNELS, 0)
    torch.cuda.reset_peak_memory_stats()
    VK.reset_launch_count()
    t0 = time.perf_counter()
    res = serve.run(RWKV_ARGS)
    wall = time.perf_counter() - t0
    counts = VK.launch_counts()
    arg = lambda flag: int(RWKV_ARGS[RWKV_ARGS.index(flag) + 1])
    b, s, gen = arg("--batch"), arg("--prompt-len"), arg("--gen")
    n_params = sum(t.numel() for t in _leaves(res.params))
    check(n_params == RWKV_PARAMS, f"rwkv serve: {n_params} parameters")
    check(res.logits_finite, "rwkv serve: non-finite logits")
    check(tuple(res.tokens.shape) == (b, gen + 1)
          and int(res.tokens.max()) < res.cfg.vocab_size
          and int(res.tokens.min()) >= 0, "rwkv serve: tokens out of range")
    check(res.launches_prefill == {**zero, "wkv6": RWKV_LAYERS},
          f"rwkv serve: prefill launches {res.launches_prefill}")
    check(res.launches_decode == zero,
          f"rwkv serve: decode launches {res.launches_decode}")
    check(res.compactions == 0, f"rwkv serve: {res.compactions} compactions")
    check(len(res.caches) == RWKV_LAYERS
          and all(isinstance(c, RWKVState) for c in res.caches),
          "rwkv serve: decode states are not one RWKVState a layer")
    check(counts == res.launches_prefill, f"rwkv serve: launches {counts}")
    step_s = res.decode_s / gen
    say(f"rwkv serve {res.cfg.describe()}, {n_params:,} parameters")
    say(f"rwkv serve prefill {b}x{s}: {1e3 * res.prefill_s:.3f} ms, "
        f"{b * s / res.prefill_s:.1f} tok/s; B14 launches "
        f"{res.launches_prefill['wkv6']}")
    say(f"rwkv serve decode {gen} steps: loop {1e3 * res.decode_s:.3f} ms, "
        f"{1e3 * step_s:.3f} ms/step, {b * gen / res.decode_s:.1f} tok/s; "
        f"B14 launches {res.launches_decode['wkv6']}")
    say(f"rwkv serve peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; serve.run wall "
        f"{wall:.3f} s (weight init included)")
    profile_prefill(torch, res, b, s)
    profile_decode(torch, res)
    del res
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 8: serve jamba
# ---------------------------------------------------------------------------

# kernel vs plain: y 2e-5 in f32 (the reference's test_mamba_scan
# tolerance), 2e-2 in bf16 storage (one rounding of y to bf16, as B13);
# the f32 final state h_T 2e-5
SCAN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# B15 at the serving path's prefill shape and the others:
# (b, T, di, ds, u / y dtype, B / C as column views of an x_proj output)
SCAN_SHAPES = {
    "a jamba prefill": (4, 2048, 8192, 16, "bfloat16", False),
    "b reduced ragged": (2, 37, 128, 4, "float32", False),
    "c T=1": (4, 1, 8192, 16, "bfloat16", False),
    "d strided views": (4, 2048, 8192, 16, "bfloat16", True),
}
SFU_PER_CLOCK = 16               # exp results a clock per SM (sm_90)
JAMBA_BATCH, JAMBA_PROMPT, JAMBA_GEN = 4, 2048, 96
JAMBA_PARAMS = 13_295_235_072    # one layer group (8 layers), full width
JAMBA_SCANS, JAMBA_ATTNS = 7, 1  # B15 / B13 launches per one-group prefill
JAMBA_CMP_BLOCKS = (3, 4)        # mamba + MoE, then attention + dense


def jamba_config(blocks=None):
    """jamba-v0.1-52b at its full published width cut to one layer group:
    the published 8-layer period (attention at index 4, MoE on the odd
    layers), or the period's ``blocks``."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import LayerGroup
    full = get_config("jamba-v0.1-52b")
    period = full.layer_groups[0].blocks
    picked = period if blocks is None else tuple(period[i] for i in blocks)
    return full.replace(layer_groups=(LayerGroup(picked, 1),))


def sfu_exps_per_s(torch) -> float:
    """The card's exp rate: SFU_PER_CLOCK a clock per SM at the SM clock's
    maximum (nvidia-smi)."""
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    say(f"SFU exp rate: {SFU_PER_CLOCK} a clock x {sms} SMs x {mhz:.0f} MHz"
        f" = {SFU_PER_CLOCK * sms * mhz * 1e6:.4g} /s")
    return SFU_PER_CLOCK * sms * mhz * 1e6


def mamba_scan_parity(torch, MK, R) -> dict:
    """B15 against its plain version at SCAN_SHAPES (y and the final
    state); kernel, plain and bound ms at each.  Returns the record of
    shape (a)."""
    dev = torch.device("cuda")
    exp_rate = sfu_exps_per_s(torch)
    out = None
    for name, (b, T, di, ds, dt, strided) in SCAN_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(T + di + ds)
        rnd = lambda *shape: torch.randn(*shape, generator=g, device=dev)
        dtype = getattr(torch, dt)
        u = (rnd(b, T, di) * 0.4).to(dtype)
        dts = torch.nn.functional.softplus(rnd(b, T, di))
        if strided:                     # [dt_r | B | C] as x_proj writes it
            xdbc = rnd(b, T, 256 + 2 * ds) * 0.4
            B, C = xdbc[..., 256:256 + ds], xdbc[..., 256 + ds:]
        else:
            B, C = rnd(b, T, ds) * 0.4, rnd(b, T, ds) * 0.4
        A = -torch.exp(rnd(di, ds) * 0.3)
        D = torch.ones(di, device=dev)
        args = (u, dts, B, C, A, D)
        (y, h), (y_p, h_p) = MK.mamba_scan(*args), R.mamba_scan(*args)
        torch.cuda.synchronize()
        err = max(float((y.float() - y_p.float()).abs().max()),
                  float((h - h_p).abs().max()))
        tol = SCAN_TOL[dt]
        check(torch.allclose(y.float(), y_p.float(), rtol=tol, atol=tol)
              and torch.allclose(h, h_p, rtol=2e-5, atol=2e-5),
              f"B15 {name}: kernel vs plain max abs err {err} (tol {tol}, "
              f"h_T 2e-5)")
        del y, h, y_p, h_p
        n, esize = b * T * di, u.element_size()
        nbytes = (2 * esize * n + 4 * n + 4 * 2 * b * T * ds
                  + 4 * (b * di * ds + di * ds + di))
        t_mem = nbytes / HBM_BYTES_PER_S
        t_exp = n * ds / exp_rate       # one exp per state per step
        t_fma = 5 * n * ds / F32_OPS_PER_S
        bound = 1e3 * max(t_mem, t_exp, t_fma)
        rec = {"max_abs_err": err, "bound_ms": bound,
               "bound_by": "bytes" if t_mem >= max(t_exp, t_fma)
               else "operations",
               "ms": time_ms(torch, lambda: MK.mamba_scan(*args), 10),
               "plain_ms": time_ms(torch, lambda: R.mamba_scan(*args), 1),
               "library_ms": None}      # no PyTorch call computes the scan
        say(f"B15 {name} [{b},{T},{di}] ds {ds} u {dt}"
            f"{' strided B/C' if strided else ''}: max abs err {err:.3g} "
            f"(tol {tol}); kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, library none, bound {bound:.4f} ms "
            f"({rec['bound_by']}: {nbytes / 1e6:.1f} MB {1e3 * t_mem:.4f} "
            f"ms, {n * ds / 1e9:.3f} G exps {1e3 * t_exp:.4f} ms, "
            f"{5 * n * ds / 1e9:.2f} GFLOP {1e3 * t_fma:.4f} ms)")
        if out is None:
            out = rec
        del args, u, dts, B, C
    torch.cuda.empty_cache()
    return out


def serve_jamba_full_width(torch, VK) -> dict:
    """Phase 8b: launch/serve.py's ``serve`` at jamba-v0.1's full width,
    one layer group (JAMBA_PARAMS parameters, weights from the port's own
    init, seed 0), batch 4 x 2,048 prompt tokens, 96 greedy decode steps
    (one compaction of the attention layer's cache; the mamba states pass
    through).  Returns the run's launches."""
    from repro_torch.launch import serve
    from repro_torch.models.layers import DecodeCache
    from repro_torch.models.mamba import MambaState
    cfg = jamba_config()
    b, s, gen = JAMBA_BATCH, JAMBA_PROMPT, JAMBA_GEN
    zero = dict.fromkeys(VK.KERNELS, 0)
    torch.cuda.reset_peak_memory_stats()
    VK.reset_launch_count()
    t0 = time.perf_counter()
    res = serve.serve(cfg, b, s, gen, seed=0, device="cuda")
    wall = time.perf_counter() - t0
    counts = VK.launch_counts()
    n_params = sum(t.numel() for t in _leaves(res.params))
    check(n_params == JAMBA_PARAMS, f"jamba serve: {n_params} parameters")
    check(res.logits_finite, "jamba serve: non-finite logits")
    check(tuple(res.tokens.shape) == (b, gen + 1)
          and int(res.tokens.max()) < cfg.vocab_size
          and int(res.tokens.min()) >= 0, "jamba serve: tokens out of range")
    check(res.launches_prefill == {**zero, "mamba_scan": JAMBA_SCANS,
                                   "flash_attention": JAMBA_ATTNS},
          f"jamba serve: prefill launches {res.launches_prefill}")
    check(res.launches_decode == zero,
          f"jamba serve: decode launches {res.launches_decode}")
    check(res.compactions == 1, f"jamba serve: {res.compactions} compactions")
    want = [DecodeCache if spec.mixer == "attn" else MambaState
            for spec in cfg.all_blocks]
    check([type(c) for c in res.caches] == want,
          "jamba serve: decode states are not one MambaState a mamba layer "
          "and one DecodeCache an attention layer")
    check(counts == res.launches_prefill, f"jamba serve: launches {counts}")
    step_s = (res.decode_s - res.compact_s) / gen
    say(f"jamba serve {cfg.describe()}, {n_params:,} parameters")
    say(f"jamba serve init {res.init_s:.3f} s (drawn on the CPU, cast to "
        f"bf16 as each layer is placed)")
    say(f"jamba serve prefill {b}x{s}: {1e3 * res.prefill_s:.3f} ms, "
        f"{b * s / res.prefill_s:.1f} tok/s; B15 launches "
        f"{res.launches_prefill['mamba_scan']}, B13 launches "
        f"{res.launches_prefill['flash_attention']}")
    say(f"jamba serve decode {gen} steps: loop {1e3 * res.decode_s:.3f} ms, "
        f"{1e3 * step_s:.3f} ms/step without compaction, "
        f"{b * gen / res.decode_s:.1f} tok/s; B15 launches "
        f"{res.launches_decode['mamba_scan']}, B13 launches "
        f"{res.launches_decode['flash_attention']}")
    say(f"jamba serve compaction: {res.compactions} in "
        f"{1e3 * res.compact_s:.3f} ms")
    say(f"jamba serve peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; serve wall "
        f"{wall:.3f} s (weight init included)")
    profile_prefill(torch, res, b, s)
    profile_decode(torch, res)
    del res
    torch.cuda.empty_cache()
    return counts


def _leaves(node):
    """The tensors of a parameter tree of dicts and lists."""
    if isinstance(node, (dict, list)):
        for v in (node.values() if isinstance(node, dict) else node):
            yield from _leaves(v)
    else:
        yield node


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
    from repro_torch.kernels import flash_attention as FK
    from repro_torch.kernels import mamba_scan as MK
    from repro_torch.kernels import quantize as QK
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import rwkv6_scan as WK
    from repro_torch.kernels import sparse_pack as SK
    from repro_torch.kernels import vc_asgd_update as VK
    from repro_torch.kernels.launches import REPLACES, SOURCE

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
    numbers.update(parity_scheme_kernels(torch, np, (VK, QK, SK), R, MAIN_N,
                                         MAIN_K, timed=True))
    parity(torch, np, VK, R, BIG_N, timed=True)
    torch.cuda.empty_cache()
    parity_scheme_kernels(torch, np, (VK, QK, SK), R, BIG_N, (BIG_K,),
                          timed=True)
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

    # ---- 4d. the pinned replay: every scheme, card vs CPU vs the pin ------
    pinned_counts = pinned_replay(torch, VK)
    say(f"pinned replay: launches summed over the 12 cases {pinned_counts}")

    # ---- 4e. the §IV-C comparison at the example's full configuration -----
    comparison(torch, VK)

    # ---- 6. serve: B13, internlm2-1.8b at full width, card vs CPU -------
    numbers["flash_attention"] = attention_parity(torch, np, FK, R)   # 6a
    torch.cuda.empty_cache()
    serve_counts = serve_full_width(torch, VK)                        # 6b
    serve_card_vs_cpu(torch, VK, depth_cut("internlm2-1.8b"),       # 6c
                      {"flash_attention": CMP_LAYERS})

    # ---- 7. serve rwkv6: B14, rwkv6-1.6b at full width, card vs CPU -----
    numbers["wkv6"] = wkv6_parity(torch, WK, R)                       # 7a
    rwkv_counts = serve_rwkv_full_width(torch, VK)                    # 7b
    serve_card_vs_cpu(torch, VK, depth_cut("rwkv6-1.6b"),           # 7c
                      {"wkv6": CMP_LAYERS})

    # ---- 8. serve jamba: B15, jamba-v0.1 one group at full width --------
    numbers["mamba_scan"] = mamba_scan_parity(torch, MK, R)           # 8a
    jamba_counts = serve_jamba_full_width(torch, VK)                  # 8b
    serve_card_vs_cpu(torch, VK, jamba_config(JAMBA_CMP_BLOCKS),      # 8c
                      {"mamba_scan": 1, "flash_attention": 1})

    # ---- 9. result lines --------------------------------------------------
    path_counts = {"assimilate_flat": eq2_counts,        # 4b
                   "vc_asgd_lerp_flat": main_counts,     # 4c
                   "adam_update_flat": main_counts,      # 4c
                   "flash_attention": serve_counts,      # 6b
                   "wkv6": rwkv_counts,                  # 7b
                   "mamba_scan": jamba_counts}           # 8b
    kernels = []
    for name in VK.KERNELS:
        r = numbers[name]
        launches = path_counts.get(name, pinned_counts)[name]   # else 4d
        check(launches > 0, f"{name} was never launched on its path")
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
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
