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
              f32 and bf16 storage (Eq. 2 with 1-9, 33 and 511 clients;
              1, 4, 8 and 9 at 2^27), Adam
              bit-exact with f32 and bf16 params, with and without weight
              decay, the elastic EASGD round bit-exact in f32 and bf16
              with 1-9 replicas (its own instances for 1-8, the generic
              one for 9; 1, 3, 8 and 9 at 2^27), int8 quantize /
              dequantize and the
              sparse-body pack bit-exact (the pack also at a k for each
              k mod 4, with q at byte offsets 0-3; the dequantize with q
              at byte offsets 0-15; the quantize at every k mod 16, k =
              4,096-4,111, with x at element offsets 0-3 from a 16-byte
              boundary, block 256 and 100).
              Each kernel's time, its plain version's, one PyTorch
              library call's where one computes the same function
              (torch.lerp / torch.addmv / torch._fused_adam_ / a scale
              multiply / torch.cat of byte views: yardsticks the port
              never calls) and the bound (B1, B2, B3, B10 and B12 timed
              in turns with their library calls; the share of the bound
              at each size); the host microseconds of one B1, B3, B2,
              B12 and B10 wrapper call at the main sizes beside
              torch.lerp's, torch._fused_adam_'s, torch.addmv's,
              torch.cat's and torch.mul's, and of one B9 call at k = 656
              and one B5 call at 16,384 with 3 replicas (no library
              call), timed in turns; B9's and B5's graph-timed device
              us there; B9's and B5's ptxas lines; the launch helper's
              raw stream handle held to the current stream's.
4. the main path, through the entry points a user calls:
   a. the quickstart --smoke configuration (examples/quickstart.py:30-45,
      VC-ASGD with var_alpha) on the card and on the CPU from one seed:
      the Eq. 1 launch count equals the results assimilated, the Adam
      count equals the client steps, the event traces are identical and
      each epoch's accuracy agrees within ACC_BAND;
   b. Eq. 2: four clients train from the server copy and return in one
      batch, folded by assimilate_many_flat (one Eq. 2 launch), held
      against folding Eq. 1 four times;
   c. the full quickstart configuration on the card, its 10 epochs cut
      to QUICKSTART_EPOCHS = 4: counts, accuracy table, wall time and
      where the host time goes (B3's share: the span of Adam.update_flat,
      inside client_train);
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
      softcap in f32, h == kvh at hd 16 and jamba's prefill
      ([4,32/8,2048,128] bf16, causal), and both prefill shapes again
      with peaked scores (q, k at 2 N(0,1)); each shape names the route
      that took it (bf16 at hd 128: the wgmma kernel,
      csrc/flash_attention_sm90.cu, held within 5e-3 + 2^-7 |plain|; the
      rest: the SIMT kernel, csrc/flash_attention.cu, 2e-5 in f32 and
      2e-2 in bf16); the wgmma kernel's ptxas lines (registers, spills,
      static shared memory) and the host cost of a call on each route;
   b. serve.run at internlm2-1.8b's full width (24 layers, 1.89B
      parameters from the port's init, --seed 0): batch 4 x 2,048 prompt
      tokens, 96 greedy decode steps; finite logits, 24 B13 launches in
      prefill, all on the wgmma route, none in decode, one compaction
      (after step 64); prefill and decode times and tokens/s, the
      compaction's time, and the profiler's device-busy share of 8
      further decode steps;
   c. the same architecture at full width cut to 2 layers, batch 2 x 256
      prompt tokens and 72 decode steps (one compaction) on the card and
      on the CPU from one draw of the weights, in f32 and in the shipped
      bf16 compute; the f32 card run decodes greedily and the other runs
      are fed its tokens: prefill and every step's logits card vs CPU
      within CMP_TOL; the CPU run launches nothing; B13 runs on the SIMT
      route in f32 and on the wgmma route in bf16.
7. serve rwkv6 — launch/serve.py for the SSM family:
   a. the WKV6 recurrence (B14, the chunked form) against its plain
      version at rwkv6's prefill shape ([4,32,2048,64] f32), the reduced
      head dim (hd 16, a ragged 37 steps), T = 1, [b, T, h, hd] strided
      views as the model passes them, and decays with exact zeros and
      denormals (2e-5 on out and the final state, both finite); kernel,
      plain and bound ms and the share of the bound at each (no PyTorch
      call computes WKV6);
   b. serve.run at rwkv6-1.6b's full width and depth (24 layers,
      1,599,819,776 parameters from the port's init, --seed 0): batch 4
      x 2,048 prompt tokens, 96 greedy decode steps against the O(1)
      recurrent state; finite logits, 24 B14 launches in prefill, none in
      decode, no compaction; prefill (cold and warm) and decode times,
      tokens/s, peak device memory and the profiler's device-busy share
      of the warm prefill and of 8 further decode steps;
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
      the kernel's ptxas lines (registers, spills, shared memory);
   b. serve.serve at jamba-v0.1's full width cut to one layer group (the
      published 8-layer period: 7 mamba layers, attention at index 4, MoE
      on the odd layers; 13,295,235,072 parameters from the port's init,
      seed 0, cast to bf16 as each layer is placed): batch 4 x 2,048
      prompt tokens, 96 greedy decode steps; finite logits, 7 B15 and 1
      B13 launches in prefill (the wgmma route), none in decode, one
      compaction; init
      seconds, prefill (cold and warm), decode and compaction times,
      tokens/s, peak device memory and the profiler's device-busy share
      of the warm prefill and of 8 further decode steps;
   c. blocks 3 and 4 of the period (mamba + MoE, then attention + dense)
      at full width on the card and on the CPU, as 6c (B13 on the SIMT
      route in f32, the wgmma route in bf16), with the MoE routes that
      differ between card and CPU counted.
9. the pod runtime's compressed cross-pod round
   (runtime/vc_runtime.py::compressed_assimilate) on the bench model of
   benchmarks/kernel_bench.py:370-383 (24 leaves, 2,101,504 parameters on
   a 2,105,344-element bus):
   a. the blocked top-k's passes, B6 (packed candidate words) and B7
      (exact-k emit), against their plain versions bit for bit at the
      bench bus, 2^20, a ragged 2^20 + 4,128, a tie-heavy round(4x)/4 bus
      (ties cut by the budget across tiles) and 2^27, each with the
      bracket and refinement of its own bus, B6 with ``lo`` as the
      bracket's device int32 [1] and as a number, B7 with tau and the
      budget as the refinement's device tensors and as numbers; kernel
      (B6 in both forms), plain and bound ms at the bench bus and at 2^27
      (no PyTorch call computes packed ballot words or the exact-k emit),
      B6's and B7's host microseconds a call at the bench bus in both
      forms and their graph-timed device microseconds there, and both
      kernels' ptxas lines;
   b. select_topk and compress_flat, card against CPU, at 2^20,
      2,105,344, 5,242,880 and 2^24 at densities 0.05 and 0.01: indices,
      q, scales and the new residual identical; B6 once per selection, B7
      once per compress_flat where the bracket holds and never where it
      misses (2^24); the whole selection's time at the bench bus beside
      the port's own stable sort (the branch a missed bracket takes, the
      same indices) and torch.topk (a yardstick the port never calls);
   c. compressed_assimilate (4 islands, alpha 0.9, density 0.05, a
      loopback transport) for 3 rounds with the residuals carried, island
      2 dead in round 2, card against CPU: server and residuals bit for
      bit, every frame byte for byte outside the residual-norm field and
      the crc (norms within 2 f32 ulps); per round B6 4, B7 4, B9 4, B10
      8, B12 4 launches; the wall of each round, the host spans of
      selection, compression, encode and decode, and the profiler's
      device-busy share of one more round;
   d. CompressedVCASGD(0.9, density=0.05) through Coordinator.issue /
      submit / deliver / assimilate on the same bus, 3 clients for 2
      rounds, card against CPU under the same frame rule.
10. the port's kernel bench (src/repro_torch/benchmarks/), the path of
   the last three kernels:
   a. B4 (DC-ASGD's corrected lerp, flat) and B1's and B4's per-tensor
      entries against their plain versions bit for bit in f32 and bf16 at
      N = 16,384, 2^24 and 2^27 and at the ragged shapes (17,), (255, 9),
      (3, 5, 7, 11); B8 (the threshold pass, tau 0.01) bit for bit on the
      bench bus in f32 and bf16, a ragged 9,000 and 2^27, kept + residual
      == x; B11 (quantize + pack) byte for byte at every k mod 16 (k =
      4,096-4,111; sel and idx also at element offsets from their
      allocations, off 16-byte boundaries; block 256 and 100) and at k =
      656, 1,313, 1,000, 105,075 and 6,710,886, its body equal to B12 of
      B9's payload.  Each timed beside its plain version and its bound,
      with its share of the bound, at the bench's shape (2^24, the bench
      bus, k = 105,075) and at 2^27 (no single PyTorch call computes any
      of the three: no library time);
   b. repro_torch.benchmarks.run with every kernel-bench suite (kernels,
      flat, flat_adam, compression, roofline) in this process on the card
      with --check: the launch gate equals results/BASELINE_launches.json
      (flat 1 / per_leaf 96, flat_adam 1, compression 2 / 1 / 1), every
      suite's rows and the roofline table print, and flat_adam's
      train_ckpt_one_pass row (the one-pass train record of the bench
      bus, host clock) is timed and launches nothing.  B4, B8 and B11
      launch there.
11. the paper's preemptible-instance story:
   a. run_preemptible_training (core/simulator.py) on the card at the
      MLP's full published width (13,130 parameters, 16,384-element bus):
      40 steps, batch 64, a one-pass train record every 10 steps; killed
      before steps 13 and 27, every step's loss and the final bus equal
      the uninterrupted run's bit for bit, with 2 restores, 10 recomputed
      steps and B3 launched once a step (50); the same killed run on the
      CPU within PRE_LOSS_TOL a step; the card's last record restores on
      the CPU and the CPU's on the card bit for bit (params, m, v, step)
      and re-saves byte for byte;
   b. Coordinator.save_checkpoint / restore_checkpoint with VCASGD (B1)
      and EASGDFlatPod (B5): restored into coordinators built from other
      params on the card and on the CPU, the next handout is the saved
      center (the pod's replicas tiled from it) and three more results
      folded on each agree bit for bit;
   c. the paper suites cost and fig6 (benchmarks/paper_figs.py, quick) on
      the card and on the CPU: every claim holds, fig6's hours equal and
      its accuracy curves agree within ACC_BAND; walls and claims print.
12. a ``kernels`` JSON line (all 15 kernels; B13's names its main-path
   route's source and, under ``sources``, both routes'), the nvidia-smi
   line, and the last line ``{"ok": true, "device": {...}}``.

Each phase's wall time is printed on its own line as the next begins.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
# repro_torch.benchmarks.kernel_bench, imported by main() once SRC is on
# the path: the card's memory rate and the one CUDA-event timer
KB = None
# repro_torch.kernels.launches, likewise: B13's launches by route
LA = None
F32_OPS_PER_S = 67e12            # H100 SXM f32, outside the tensor cores
MAIN_N = 16384                   # the MLP's 13,130 params on the BLOCK bus
BIG_N = 2 ** 27                  # order of the ~100M-parameter demo LM
ACC_BAND = 0.03                  # card vs CPU epoch accuracy (6 of 200)
MAIN_K = (656, 1313)             # sparse payload at densities 0.05 / 0.1
# 4c: examples/quickstart.py's full configuration, its depth (10 epochs)
# cut to 4 to hold the script's time; every epoch does the same work
QUICKSTART_EPOCHS = 4
BIG_K = int(BIG_N * 0.05)        # 6,710,886
QBLOCK = 256
# B2's client counts in phase 3: its instances for 1-8 clients and its
# generic one (9 and up); at 2^27 the counts whose [n, 2^27] matrix fits
EQ2_COUNTS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 33, 511)
EQ2_COUNTS_BIG = (1, 4, 8, 9)
# B12's payloads in phase 3 beyond MAIN_K: a k for each k mod 4 (the
# seams' shifts), 105,075 the bench bus's
PACK_KS = (655, 656, 657, 658, 105_075)
# B10's payloads in phase 3 with q at byte offsets 0-15 from a 16-byte
# boundary: heads and tails of every length, packs across a group seam
DEQUANT_KS = (1, 15, 17, 255, 271, 656, 1313, 105_075)
# B5's replica counts in phase 3: its instances for 1-8 and its generic
# one; at 2^27 the smallest, the path's, the largest instance and generic
EASGD_COUNTS = (1, 2, 3, 4, 5, 6, 7, 8, 9)
EASGD_COUNTS_BIG = (1, 3, 8, 9)
# B9's payloads in phase 3 with x at element offsets 0-3 from a 16-byte
# boundary (tests/test_torch_quantize_walk.py's shapes): every k mod 16,
# the wire's block and a generic one
QUANT_KS = tuple(4096 + r for r in range(16))
QUANT_BLOCKS = (QBLOCK, 100)

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
        "blocked_topk_stats": 0,         # the MLP bus takes the global sort
        "threshold_sparsify_exact": 0,
        "vc_asgd_dc_lerp_flat": 0,       # the bench's kernels (phase 10)
        "threshold_sparsify": 0,
        "quantize_pack": 0,
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


class Phases:
    """Prints each phase's wall time on its own line when the next one
    starts (and the total at ``end``)."""

    def __init__(self):
        self.t0 = self.t = time.perf_counter()
        self.name = None

    def start(self, name) -> None:
        now = time.perf_counter()
        if self.name is not None:
            say(f"phase {self.name} wall: {now - self.t:.3f} s")
        self.name, self.t = name, now

    def end(self) -> None:
        self.start(None)
        say(f"total wall: {time.perf_counter() - self.t0:.3f} s")


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def bound_ms(nbytes: float, ops: float):
    t_mem, t_ops = nbytes / KB.HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else "operations")


def say_ptxas(build, source: str, label: str, kernel: str = "") -> None:
    """The ptxas lines (registers, spills, shared memory) of one source's
    kernels, or of those whose mangled names hold ``kernel`` as a whole
    name (``quantize_kernel``, not ``dequantize_kernel``), each after its
    kernel's name, from this run's build."""
    log = build.build_log.get(source)
    if log is None:
        say(f"{label} ptxas: not built in this run (its library was "
            f"already in build/kernels)")
    entry = ""
    for line in (log or "").splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif (re.search(rf"(?<![A-Za-z_]){kernel}", entry)
              and ("registers" in line or "spill" in line
                   or "smem" in line)):
            say(f"{label} ptxas {entry}: {line.strip()}")


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
        rec["ms"], rec["library_ms"] = in_turns(
            torch, lambda: VK.vc_asgd_lerp_flat(s, c, alpha),
            lambda: torch.lerp(c, s, a32), iters)
        rec["plain_ms"] = KB.cuda_ms(lambda: R.vc_asgd_lerp(s, c, alpha), iters)
        rec["bound_ms"], rec["bound_by"] = bound_ms(12 * n_elems, 3 * n_elems)
    out["vc_asgd_lerp_flat"] = rec

    # B2: Eq. 2, at every client count of its own instance (1-8) and on
    # its generic instance (9, 33, 511; at 2^27 the counts that fit)
    for dtype in (torch.float32, torch.bfloat16):
        for n in (EQ2_COUNTS if n_elems <= MAIN_N else EQ2_COUNTS_BIG):
            s, cl = rnd(n_elems).to(dtype), rnd(n, n_elems).to(dtype)
            w = [alpha ** n] + [(1 - alpha) * alpha ** (n - 1 - j) for j in range(n)]
            k, p = VK.assimilate_flat(s, cl, w), R.assimilate(s, cl, w)
            torch.cuda.synchronize()
            check(bits_equal(torch, k, p),
                  f"Eq. 2 {dtype} n={n} N={n_elems}: kernel != plain version")
            say(f"parity B2 assimilate_flat {str(dtype)[6:]} n={n} N={n_elems}: bit-exact")
            del s, cl, k, p
    n = 4
    s, cl = rnd(n_elems), rnd(n, n_elems)
    w = [alpha ** n] + [(1 - alpha) * alpha ** (n - 1 - j) for j in range(n)]
    err = float((VK.assimilate_flat(s, cl, w) - R.assimilate(s, cl, w)).abs().max())
    rec = {"max_abs_err": err}
    if timed:
        w32 = torch.tensor(np.asarray(w[1:], np.float32), device=dev)
        clt = cl.t()
        w0 = float(np.float32(w[0]))
        rec["ms"], rec["library_ms"] = in_turns(
            torch, lambda: VK.assimilate_flat(s, cl, w),
            lambda: torch.addmv(s, clt, w32, beta=w0), iters)
        rec["plain_ms"] = KB.cuda_ms(lambda: R.assimilate(s, cl, w), iters)
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            4 * (n + 2) * n_elems, (2 * n + 1) * n_elems)
    out["assimilate_flat"] = rec
    del s, cl

    # B3: fused Adam (t = 3: every bias correction term is live), params
    # in f32 and bf16 storage, with and without weight decay
    t = 3
    c1 = np.float32(1) - np.float32(0.9) ** np.float32(t)
    c2 = np.float32(1) - np.float32(0.999) ** np.float32(t)
    hyper = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)
    for dtype in (torch.float32, torch.bfloat16):
        for wd in (0.0, 0.01):
            p, gr, m = rnd(n_elems).to(dtype), rnd(n_elems), rnd(n_elems)
            v = rnd(n_elems).abs()
            kern = VK.adam_update_flat(p, gr, m, v, hyper["lr"], hyper["b1"],
                                       hyper["b2"], hyper["eps"], wd, c1, c2)
            plain = R.adam_update(p, gr, m, v, c1=c1, c2=c2,
                                  weight_decay=wd, **hyper)
            torch.cuda.synchronize()
            for name, a, b in zip(("p", "m", "v"), kern, plain):
                check(bits_equal(torch, a, b),
                      f"Adam {dtype} wd={wd} N={n_elems}: lane {name}: "
                      f"kernel != plain version")
            say(f"parity B3 adam_update_flat {str(dtype)[6:]} wd={wd} "
                f"N={n_elems}: bit-exact")
    p, gr, m = rnd(n_elems), rnd(n_elems), rnd(n_elems)
    v = rnd(n_elems).abs()
    kern = VK.adam_update_flat(p, gr, m, v, hyper["lr"], hyper["b1"],
                               hyper["b2"], hyper["eps"], 0.0, c1, c2)
    plain = R.adam_update(p, gr, m, v, c1=c1, c2=c2, weight_decay=0.0,
                          **hyper)
    err = max(float((a - b).abs().max()) for a, b in zip(kern, plain))
    rec = {"max_abs_err": err}
    if timed:
        lp, lm, lv = p.clone(), m.clone(), v.clone()
        step = [torch.tensor(float(t), device=dev)]
        rec["ms"], rec["library_ms"] = in_turns(
            torch, lambda: VK.adam_update_flat(
                p, gr, m, v, hyper["lr"], hyper["b1"], hyper["b2"],
                hyper["eps"], 0.0, c1, c2),
            lambda: torch._fused_adam_(
                [lp], [gr], [lm], [lv], [], step, lr=hyper["lr"],
                beta1=hyper["b1"], beta2=hyper["b2"], weight_decay=0.0,
                eps=hyper["eps"], amsgrad=False, maximize=False), iters)
        rec["plain_ms"] = KB.cuda_ms(lambda: R.adam_update(
            p, gr, m, v, c1=c1, c2=c2, weight_decay=0.0, **hyper), iters)
        rec["bound_ms"], rec["bound_by"] = bound_ms(28 * n_elems, 14 * n_elems)
    out["adam_update_flat"] = rec
    if timed:
        for name, r in out.items():
            say(f"timing {name} N={n_elems}: kernel {r['ms']:.6f} ms")
            say(f"timing {name} N={n_elems}: plain {r['plain_ms']:.6f} ms")
            say(f"timing {name} N={n_elems}: library {r['library_ms']:.6f} ms")
            say(f"timing {name} N={n_elems}: bound {r['bound_ms']:.6f} ms "
                f"({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f}% "
                f"of it")
    return out


def pack_seams(torch, SK, R, rnd) -> None:
    """B12 byte-equal at a k for each k mod 4 (both seams of the body
    unaligned by each shift), with q read at byte offsets 0-3 (q a slice
    of a larger buffer)."""
    dev = torch.device("cuda")
    for k in PACK_KS:
        ng = -(-k // QBLOCK)
        q0 = (rnd(k + 3) * 60).round().clamp(-127, 127).to(torch.int8)
        sc = rnd(ng).abs() * 0.01
        idx = torch.arange(k, dtype=torch.int32, device=dev) * 7 + 3
        for off in range(4):
            q = q0[off:off + k]
            kb, pb = SK.pack_body(q, sc, idx), R.pack_body(q, sc, idx)
            torch.cuda.synchronize()
            check(kb.numel() == 5 * k + 4 * ng and torch.equal(kb, pb),
                  f"pack_body k={k} q at byte {off}: kernel != plain version")
        say(f"parity B12 pack_body k={k} (k mod 4 = {k % 4}), q at byte "
            f"offsets 0-3: bytes equal")


def dequant_offsets(torch, QK, R, rnd) -> None:
    """B10 bit-exact at DEQUANT_KS with q at every byte offset 0-15 from a
    16-byte boundary (q a view of a larger buffer): the head, the packs
    that straddle two groups, the tail."""
    dev = torch.device("cuda")
    for k in DEQUANT_KS:
        ng = -(-k // QBLOCK)
        base = (rnd(k + 32) * 60).round().clamp(-127, 127).to(torch.int8)
        sc = rnd(ng).abs() * 0.01
        for off in range(16):
            lead = (off - base.data_ptr()) % 16
            q = base[lead:lead + k]
            kd, pd = QK.dequantize_int8(q, sc, k), R.dequantize_int8(q, sc, k)
            torch.cuda.synchronize()
            check(q.data_ptr() % 16 == off and bits_equal(torch, kd, pd),
                  f"dequantize k={k} q at byte {off}: kernel != plain")
        say(f"parity B10 dequantize_int8 k={k}, q at byte offsets 0-15: "
            f"bit-exact")


def quantize_offsets(torch, QK, R, rnd) -> None:
    """B9 bit-exact at QUANT_KS with x at element offsets 0-3 from a
    16-byte boundary (x a view of a larger buffer: 1-3 take the value
    loads), at the wire's block and a generic one."""
    for k in QUANT_KS:
        base = rnd(k + 8) * 0.01
        for off in range(4):
            lead = (off - base.data_ptr() // 4) % 4
            x = base[lead:lead + k]
            for block in QUANT_BLOCKS:
                (kq, ks_), (pq, ps) = (QK.quantize_int8(x, block),
                                       R.quantize_int8(x, block))
                torch.cuda.synchronize()
                check(x.data_ptr() % 16 == 4 * off and torch.equal(kq, pq)
                      and bits_equal(torch, ks_, ps),
                      f"quantize k={k} x at element {off} block {block}: "
                      f"kernel != plain")
    say(f"parity B9 quantize_int8 k = {QUANT_KS[0]}..{QUANT_KS[-1]} (every "
        f"k mod 16), x at element offsets 0-3, block {QUANT_BLOCKS}: "
        f"bit-exact")


def in_turns(torch, kernel, library, iters: int) -> tuple:
    """(kernel ms, library ms) a call by CUDA events, timed in turns (K L
    L K, twice) after a warm-up (wrapper_cost.event_ms)."""
    from repro_torch.benchmarks import wrapper_cost as WC
    ms = WC.event_ms(torch, {"kernel": kernel, "library": library}, iters)
    return ms["kernel"], ms["library"]


def wrapper_host_cost(torch, np, VK, SK, QK, TK, LA) -> dict:
    """Phase 3: host microseconds of one B1, B3, B2, B12 and B10 wrapper
    call and of the one PyTorch call computing the same function
    (torch.lerp, torch._fused_adam_, torch.addmv, torch.cat, torch.mul),
    and of one B9 and one B5 call (no such PyTorch call), at the main
    sizes (the MLP bus, N = MAIN_N f32, Eq. 2 over 4 clients, EASGD over 3
    replicas; k = 656 for the pack and the codec; each kernel shorter than
    its call): the host clock around
    200 back-to-back calls, every call of wrapper_cost.calls in turns
    over 9 rounds, the median kept (wrapper_cost.host_us).  The launch
    helper's raw stream handle is held to the current stream's."""
    from repro_torch.benchmarks import wrapper_cost as WC
    idx = torch.cuda.current_device()
    check(LA._raw_stream(idx) == torch.cuda.current_stream().cuda_stream,
          "launches: the raw stream handle is not the current stream's")
    us = WC.host_us(torch, WC.calls(torch, np, VK, SK, QK, TK, MAIN_N))
    out = {}
    for kern, lib in (("B1 vc_asgd_lerp_flat", "torch.lerp"),
                      ("B3 adam_update_flat", "torch._fused_adam_"),
                      ("B2 assimilate_flat", "torch.addmv"),
                      ("B12 pack_body", "torch.cat"),
                      ("B10 dequantize_int8", "torch.mul"),
                      ("B9 quantize_int8", None),
                      ("B5 easgd_elastic_flat", None)):
        size = WC.size_of(kern, MAIN_N)
        lib_us = None if lib is None else us[lib]
        say(f"host cost {kern} {size}: {us[kern]:.2f} us a call, "
            + ("no library call" if lib is None else
               f"{lib} {lib_us:.2f} us") + " (in turns, median of 9 rounds)")
        out[kern.split()[1]] = {"host_us": us[kern],
                                "library_host_us": lib_us}
    return out


def parity_scheme_kernels(torch, np, KK, R, n_elems: int, ks, timed: bool
                          ) -> dict:
    """The scheme-comparison path's kernels against their plain versions:
    the elastic EASGD round (B5) at ``n_elems`` with 1 and 3 replicas in
    f32 and bf16, int8 quantize / dequantize (B9, B10) and the sparse-body
    pack (B12) at each payload size in ``ks``.  Timed (B5 f32 with 3
    replicas, the codec and pack at ``ks[0]``) when ``timed``."""
    from repro_torch.benchmarks import wrapper_cost as WC
    VK, QK, SK = KK
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(n_elems + 7)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)
    iters = 50 if n_elems <= MAIN_N else 10
    out = {}

    # B5: elastic EASGD round, replicas in slot order
    beta = 0.05
    for dtype in (torch.float32, torch.bfloat16):
        for n in (EASGD_COUNTS if n_elems <= MAIN_N else EASGD_COUNTS_BIG):
            c, x = rnd(n_elems).to(dtype), rnd(n, n_elems).to(dtype)
            (kc, kx), (pc, px) = (VK.easgd_elastic_flat(c, x, beta),
                                  R.easgd_elastic(c, x, beta))
            torch.cuda.synchronize()
            check(bits_equal(torch, kc, pc) and bits_equal(torch, kx, px),
                  f"EASGD {dtype} n={n} N={n_elems}: kernel != plain version")
            say(f"parity B5 easgd_elastic_flat {str(dtype)[6:]} n={n} "
                f"N={n_elems}: bit-exact")
            del c, x, kc, kx, pc, px
    n = 3
    c, x = rnd(n_elems), rnd(n, n_elems)
    (kc, kx), (pc, px) = (VK.easgd_elastic_flat(c, x, beta),
                          R.easgd_elastic(c, x, beta))
    rec = {"max_abs_err": max(float((kc - pc).abs().max()),
                              float((kx - px).abs().max())),
           "library_ms": None}
    if timed:
        rec["ms"] = KB.cuda_ms(lambda: VK.easgd_elastic_flat(c, x, beta),
                               iters)
        rec["plain_ms"] = KB.cuda_ms(lambda: R.easgd_elastic(c, x, beta),
                                     iters)
        rec["bound_ms"], rec["bound_by"] = bound_ms(
            2 * 4 * (n + 1) * n_elems, (4 * n + 2) * n_elems)
        if n_elems <= MAIN_N:
            rec["device_us"] = WC.graph_us(
                torch, lambda: VK.easgd_elastic_flat(c, x, beta))
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
            r["ms"] = KB.cuda_ms(lambda: QK.quantize_int8(sel), iters)
            r["device_us"] = WC.graph_us(torch, lambda: QK.quantize_int8(sel))
            r["plain_ms"] = KB.cuda_ms(lambda: R.quantize_int8(sel), iters)
            r["bound_ms"], r["bound_by"] = bound_ms(4 * k + k + 4 * ng, 5 * k)
            r = recs["dequantize_int8"]
            q_rows, sc_col = q_pad.view(ng, QBLOCK), ks_[:, None]
            r["ms"], r["library_ms"] = in_turns(
                torch, lambda: QK.dequantize_int8(kq, ks_, k),
                lambda: torch.mul(q_rows, sc_col), iters)
            r["plain_ms"] = KB.cuda_ms(
                lambda: R.dequantize_int8(kq, ks_, k), iters)
            r["bound_ms"], r["bound_by"] = bound_ms(k + 4 * ng + 4 * k, k)
            r = recs["pack_body"]
            r["ms"], r["library_ms"] = in_turns(
                torch, lambda: SK.pack_body(kq, ks_, idx),
                lambda: torch.cat([kq.view(torch.uint8), ks_.view(torch.uint8),
                                   idx.view(torch.uint8)]), iters)
            r["plain_ms"] = KB.cuda_ms(
                lambda: R.pack_body(kq, ks_, idx), iters)
            r["bound_ms"], r["bound_by"] = bound_ms(2 * (5 * k + 4 * ng), 0)
        out.update(recs)
    if n_elems <= MAIN_N:
        pack_seams(torch, SK, R, rnd)
        dequant_offsets(torch, QK, R, rnd)
        quantize_offsets(torch, QK, R, rnd)
    if timed:
        for name, r in out.items():
            size = f"N={n_elems} n=3" if name == "easgd_elastic_flat" \
                else f"k={ks[0]}"
            say(f"timing {name} {size}: kernel {r['ms']:.6f} ms")
            say(f"timing {name} {size}: plain {r['plain_ms']:.6f} ms")
            lib = r["library_ms"]
            say(f"timing {name} {size}: library "
                + ("none" if lib is None else f"{lib:.6f} ms"))
            say(f"timing {name} {size}: bound {r['bound_ms']:.6f} ms "
                f"({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f}% "
                f"of it")
            if "device_us" in r:
                say(f"timing {name} {size}: device {r['device_us']:.3f} us "
                    f"a call (100 calls in a CUDA graph), "
                    f"{100e3 * r['bound_ms'] / r['device_us']:.1f}% of the "
                    f"bound")
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

TRACE = ("wall_time_s", "epochs_done", "reassignments", "preemptions",
         "results_assimilated", "handout_frames", "handout_bytes",
         "leases_expired", "leases_dropped", "events_processed",
         "wire_dense_frames", "client_steps")


def quickstart(smoke: bool, epochs=None):
    """(data, SimConfig) of examples/quickstart.py; ``epochs`` cuts its
    depth."""
    from repro_torch.core.simulator import SimConfig
    from repro_torch.core.tasks import make_classification_data
    data = make_classification_data(n_train=800 if smoke else 4000,
                                    n_val=200 if smoke else 800)
    if epochs is None:
        epochs = 2 if smoke else QUICKSTART_EPOCHS
    cfg = SimConfig(n_param_servers=3, n_clients=5, tasks_per_client=2,
                    n_shards=8 if smoke else 25, max_epochs=epochs,
                    preemptible=True, mean_lifetime_s=2400.0,
                    consistency="eventual", seed=0)
    return data, cfg


def run(device, smoke: bool, task=None, epochs=None):
    from repro_torch.core.baselines import VCASGD
    from repro_torch.core.simulator import run_simulation
    from repro_torch.core.tasks import MLPTask
    from repro_torch.core.vc_asgd import var_alpha
    data, cfg = quickstart(smoke, epochs)
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
    """The first epoch of the smoke run on the card under torch.profiler
    (its second epoch cut to hold the script's time): device busy share
    and the top kernels/ops."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = run("cuda", smoke=True, epochs=1)
    report_profile(prof, f"smoke, 1 epoch (profiled wall {wall:.3f} s)",
                   wall)


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
# kernel vs plain, as (atol, rtol) by route.  SIMT: 2e-5 in f32 (the
# reference's blocked-vs-plain tolerance), tests/test_kernels.py TOL in
# bf16 (outputs rounded to bf16).  wgmma (bf16 at hd 128, P rounded to
# bf16 for P.V): the bound its source states, 5e-3 before the output's
# rounding plus one bf16 ulp of |plain| (at most 2^-7 |plain|)
ATTN_TOL = {("simt", "float32"): (2e-5, 2e-5),
            ("simt", "bfloat16"): (2e-2, 2e-2),
            ("wgmma", "bfloat16"): (5e-3, 2 ** -7)}
# B13 at the serving path's shapes and the family's others: (b, h, kvh,
# sq, skv, hd, dtype, causal, window, softcap, qk) with q and k drawn at
# qk N(0,1), v at N(0,1): 0.5 gives a flat softmax, 2 a peaked one whose
# row max moves between kv tiles (what the online rescale must follow)
ATTN_SHAPES = {
    "a internlm2 prefill": (4, 16, 8, 2048, 2048, 128, "bfloat16", True,
                            None, None, 0.5),
    "a2 internlm2 prefill, peaked": (4, 16, 8, 2048, 2048, 128, "bfloat16",
                                     True, None, None, 2.0),
    "b gemma3 local": (2, 8, 4, 2300, 2300, 256, "bfloat16", True, 1024,
                       None, 0.5),
    "c cross softcap": (1, 4, 4, 333, 517, 64, "float32", False, None, 50.0,
                        0.5),
    "d h=kvh hd16": (2, 4, 4, 512, 512, 16, "bfloat16", True, None, None,
                     0.5),
    "e jamba prefill": (4, 32, 8, 2048, 2048, 128, "bfloat16", True, None,
                        None, 0.5),
    "e2 jamba prefill, peaked": (4, 32, 8, 2048, 2048, 128, "bfloat16",
                                 True, None, None, 2.0),
}
# host cost of one wrapper call, at a shape whose kernel is shorter than
# the call: (b, h, kvh, s)
HOST_SHAPE, HOST_CALLS = (1, 4, 2, 128), 200
SERVE_ARGS = ["--arch", "internlm2-1.8b", "--batch", "4", "--prompt-len",
              "2048", "--gen", "96"]
SERVE_LAYERS = 24                # internlm2-1.8b: one B13 launch a layer
# decode steps under the profiler (cut from 32: the profiler's
# post-processing costs ~12 s per second of profiled decode)
PROFILE_STEPS = 8
# card vs CPU: internlm2-1.8b's full width, depth cut to 2 layers
CMP_LAYERS, CMP_BATCH, CMP_PROMPT, CMP_STEPS = 2, 2, 256, 72
# logits, card vs CPU: 2e-3 in f32 compute (the reference's own
# prefill/decode tolerance); bf16 as tests/test_torch_models.py states it
CMP_TOL = {"float32": 2e-3, "bfloat16": 0.15}
# B13's route in 6c / 8c (both models' head dim is 128)
ATTN_ROUTES = {"float32": "simt", "bfloat16": "wgmma"}


def attn_pairs(np, sq: int, skv: int, causal: bool, window) -> int:
    """Visible (query, key) pairs: the work this call's masks leave."""
    q = np.arange(sq, dtype=np.int64)
    hi = np.minimum(skv, q + 1) if causal else np.full(sq, skv)
    lo = np.maximum(0, q - window + 1) if window else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def attention_host_cost(torch, FK) -> None:
    """Host microseconds of one B13 wrapper call on each route (enqueue
    only: the kernel is shorter than the call; the wgmma route's includes
    encoding its three tensor maps), at HOST_SHAPE."""
    b, h, kvh, s = HOST_SHAPE
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn(b, h, s, 128, device="cuda").to(dt)
        k = torch.randn(b, kvh, s, 128, device="cuda").to(dt)
        FK.flash_attention(q, k, k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            FK.flash_attention(q, k, k)
        us = 1e6 * (time.perf_counter() - t0) / HOST_CALLS
        torch.cuda.synchronize()
        say(f"B13 host cost, route {FK.route(q)} ({dt}, [{b},{h}/{kvh},{s},"
            f"128]): {us:.1f} us a wrapper call")


def attention_parity(torch, np, FK, R) -> dict:
    """B13 against its plain version at ATTN_SHAPES; kernel, plain and
    (where one PyTorch call computes the same function) SDPA times and
    the bound at each, with the route that took each shape.  Returns the
    record of shape (a)."""
    import math
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dev = torch.device("cuda")
    out = None
    for name, (b, h, kvh, sq, skv, hd, dt, causal, window, softcap,
               qk) in ATTN_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(sq + hd)
        dtype = getattr(torch, dt)
        q = (torch.randn(b, h, sq, hd, generator=g, device=dev) * qk
             ).to(dtype)
        k = (torch.randn(b, kvh, skv, hd, generator=g, device=dev) * qk
             ).to(dtype)
        v = torch.randn(b, kvh, skv, hd, generator=g, device=dev).to(dtype)
        kw = dict(causal=causal, window=window, softcap=softcap)
        kern, plain = FK.flash_attention(q, k, v, **kw), R.attention(q, k, v,
                                                                     **kw)
        torch.cuda.synchronize()
        diff = (kern.float() - plain.float()).abs()
        atol, rtol = ATTN_TOL[FK.route(q), dt]
        err = float(diff.max())
        # the largest share of its limit that any output takes (<= 1: pass)
        share = float((diff / (atol + rtol * plain.float().abs())).max())
        tol = f"atol {atol:g} + rtol {rtol:g} |plain|"
        check(share <= 1.0, f"B13 {name}: kernel vs plain max abs err {err},"
                            f" {share:.3f} of its limit ({tol})")
        del kern, plain, diff
        esize = 2 if dt == "bfloat16" else 4
        ops = 4 * hd * b * h * attn_pairs(np, sq, skv, causal, window)
        nbytes = esize * (2 * b * h * sq * hd + 2 * b * kvh * skv * hd)
        peak = BF16_OPS_PER_S if dt == "bfloat16" else F32_OPS_PER_S
        t_mem, t_ops = nbytes / KB.HBM_BYTES_PER_S, ops / peak
        rec = {"max_abs_err": err, "bound_ms": 1e3 * max(t_mem, t_ops),
               "bound_by": "bytes" if t_mem >= t_ops else "operations",
               "ms": KB.cuda_ms(lambda: FK.flash_attention(q, k, v, **kw),
                                10),
               "plain_ms": KB.cuda_ms(lambda: R.attention(q, k, v, **kw),
                                      3),
               "library_ms": None}
        if window is None and softcap is None:      # SDPA has neither
            rec["library_ms"] = KB.cuda_ms(lambda: sdpa(
                q, k, v, is_causal=causal, scale=1.0 / math.sqrt(hd),
                enable_gqa=h != kvh), 10)
        torch.cuda.empty_cache()
        lib = rec["library_ms"]
        say(f"B13 {name} [{b},{h}/{kvh},{sq}x{skv},{hd}] {dt} causal={causal} "
            f"window={window} softcap={softcap}, route {FK.route(q)}: "
            f"q, k at {qk} N(0,1): max abs err {err:.3g}, {share:.3f} of "
            f"its limit ({tol}); kernel {rec['ms']:.4f} ms, plain "
            f"{rec['plain_ms']:.4f} ms, SDPA "
            + ("none" if lib is None else f"{lib:.4f} ms")
            + f", bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
            f"{ops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB); "
            f"{100 * rec['bound_ms'] / rec['ms']:.1f}% of the bound, "
            f"{ops / rec['ms'] / 1e9:.1f} TFLOP/s")
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


def check_attn_route(n: int, route: str, label: str) -> None:
    """Every one of the ``n`` B13 launches since the last reset ran on
    ``route``."""
    routes = LA.route_counts("flash_attention")
    want = {r: (n if r == route else 0) for r in routes}
    check(routes == want, f"{label}: B13 routes {routes}, want {want}")


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
    check_attn_route(SERVE_LAYERS, "wgmma", "serve")
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
        f"{res.launches_prefill['flash_attention']} (routes "
        f"{LA.route_counts('flash_attention')})")
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
    t0 = time.perf_counter()
    avgs = prof.key_averages()
    say(f"profile {label}: key_averages {time.perf_counter() - t0:.3f} s")
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


def serve_card_vs_cpu(torch, VK, cut, launches: dict,
                      attn_routes=None) -> None:
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
    the CPU's f32 logits.  ``attn_routes``: dtype -> the B13 route every
    card launch of that dtype takes."""
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
            if run == "card" and attn_routes:
                check_attn_route(launches["flash_attention"], attn_routes[dt],
                                 f"card vs cpu {dt}")
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
# (b, h, T, hd, [b, T, h, hd] strided views, w as drawn): w as test_wkv6
# draws it, in (0.35, 0.95); or 30% of it exact zeros (a decay that
# underflows, as exp(-exp(ww)) does past ww ~4.5) or denormals (1e-40)
WKV_SHAPES = {
    "a rwkv6 prefill": (4, 32, 2048, 64, False, "test"),
    "b reduced hd16 ragged": (2, 4, 37, 16, False, "test"),
    "c T=1": (4, 32, 1, 64, False, "test"),
    "d strided views": (4, 32, 2048, 64, True, "test"),
    "e w zeros": (2, 8, 300, 64, False, "zero"),
    "f w denormal": (2, 8, 300, 64, False, "denormal"),
    "g w zeros hd16": (2, 4, 37, 16, False, "zero"),
}
RWKV_ARGS = ["--arch", "rwkv6-1.6b", "--batch", "4", "--prompt-len",
             "2048", "--gen", "96"]
RWKV_LAYERS = 24                 # rwkv6-1.6b: one B14 launch a layer
RWKV_PARAMS = 1_599_819_776      # the published config's parameter count


def wkv6_parity(torch, WK, R) -> dict:
    """B14 against its plain version at WKV_SHAPES (out and the final
    state, both finite); kernel, plain and bound ms and the share of the
    bound at each.  Returns the record of shape (a)."""
    dev = torch.device("cuda")
    out = None
    for name, (b, h, T, hd, strided, decay) in WKV_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(T + hd)
        shape = (b, T, h, hd) if strided else (b, h, T, hd)
        rnd = lambda: torch.randn(*shape, generator=g, device=dev)
        args = [rnd() * 0.4, rnd() * 0.4, rnd(),
                torch.sigmoid(rnd()) * 0.6 + 0.35]      # w in (0.35, 0.95)
        if decay != "test":
            hit = torch.rand(*shape, generator=g, device=dev) < 0.3
            args[3] = torch.where(hit, torch.tensor(
                0.0 if decay == "zero" else 1e-40, device=dev), args[3])
        if strided:
            args = [t.transpose(1, 2) for t in args]
        args.append(torch.randn(h, hd, generator=g, device=dev) * 0.2)
        (o, S), (o_p, S_p) = WK.wkv6(*args), R.wkv6(*args)
        torch.cuda.synchronize()
        err = max(float((o - o_p).abs().max()), float((S - S_p).abs().max()))
        check(bool(torch.isfinite(o).all()) and bool(torch.isfinite(S).all()),
              f"B14 {name}: non-finite out or state")
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
               "ms": KB.cuda_ms(lambda: WK.wkv6(*args), 10),
               "plain_ms": KB.cuda_ms(lambda: R.wkv6(*args), 1),
               "library_ms": None}      # no PyTorch call computes WKV6
        say(f"B14 {name} [{b},{h},{T},{hd}]{' strided' if strided else ''}"
            f" f32: max abs err {err:.3g} (tol {WKV_TOL}); kernel "
            f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, library "
            f"none, bound {bound:.4f} ms ({by}: {ops / 1e9:.3f} GFLOP, "
            f"{nbytes / 1e6:.1f} MB), {100 * bound / rec['ms']:.1f}% of it")
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
        t_mem = nbytes / KB.HBM_BYTES_PER_S
        t_exp = n * ds / exp_rate       # one exp per state per step
        t_fma = 5 * n * ds / F32_OPS_PER_S
        bound = 1e3 * max(t_mem, t_exp, t_fma)
        rec = {"max_abs_err": err, "bound_ms": bound,
               "bound_by": "bytes" if t_mem >= max(t_exp, t_fma)
               else "operations",
               "ms": KB.cuda_ms(lambda: MK.mamba_scan(*args), 10),
               "plain_ms": KB.cuda_ms(lambda: R.mamba_scan(*args), 1),
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
    check_attn_route(JAMBA_ATTNS, "wgmma", "jamba serve")
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
        f"{res.launches_prefill['flash_attention']} (routes "
        f"{LA.route_counts('flash_attention')})")
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


# ---------------------------------------------------------------------------
# phase 9: the pod runtime's compressed cross-pod round
# ---------------------------------------------------------------------------

# benchmarks/kernel_bench.py:309-310, :370-376: the bench model's bus
BENCH_N, BENCH_LOGICAL = 2_105_344, 2_101_504
BENCH_SIZES = [(256, 256), (1024, 64), (64,), (512, 512), (128, 1024),
               (1024,)]
POD_ISLANDS, POD_ALPHA, POD_DENSITY, POD_ROUNDS = 4, 0.9, 0.05, 3
POD_DEAD = {1: 2}                        # round -> dead island
# launches of one compressed round of 4 islands on a bus that holds the
# bracket: per island B6 + B7 (selection), B9 + B10 (quantize and the
# error feedback's dequantize), B12 (the frame), B10 (decompress)
POD_LAUNCHES = {"blocked_topk_stats": 4, "threshold_sparsify_exact": 4,
                "quantize_int8": 4, "dequantize_int8": 8, "pack_body": 4}
# B6 / B7 parity: name -> (n, tie-heavy); timed at the bench bus and 2^27
TOPK_SHAPES = {"bench": (BENCH_N, False), "2^20": (1 << 20, False),
               "ragged": ((1 << 20) + 4128, False),
               "ties": (1 << 20, True), "2^27": (BIG_N, False)}
SELECT_SIZES = (1 << 20, BENCH_N, 5 << 20, 1 << 24)
_NORM, _CRC = slice(36, 40), slice(64, 68)     # res_norm and crc (v2 header)


def np_bus(np, n: int, seed: int, ties: bool = False):
    """N(0, 0.02^2) f32 from a numpy seed; ``ties``: N(0, 1) rounded to
    quarters (thousands of elements share each magnitude)."""
    x = np.random.default_rng(seed).standard_normal(n)
    return (np.round(4 * x) / 4 if ties else 0.02 * x).astype(np.float32)


def bench_model(np, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {f"layer{rep}/p{i}": rng.standard_normal(shp).astype(np.float32)
            for rep in range(4) for i, shp in enumerate(BENCH_SIZES)}


def topk_parity(torch, np, TK, C, R) -> dict:
    """Phase 9a: B6 and B7 against their plain versions on the card, bit
    for bit, at each TOPK_SHAPES bus: B6 with the bus's own bracket at
    density 0.05, as the path's device int32 [1] and as a number, B7
    with the refinement of B6's words.  Returns the numbers of both at
    the bench bus, the path's shape, with B6's host us a call there."""
    from repro_torch.benchmarks import wrapper_cost as WC
    out = {}
    for seed, (name, (n, ties)) in enumerate(TOPK_SHAPES.items()):
        x = torch.from_numpy(np_bus(np, n, 90 + seed, ties)).cuda()
        k = int(n * POD_DENSITY)
        nb = -(-n // TK.BLOCK)
        lo = C.bracket(x, k)
        lo_int = int(lo)
        words, counts = TK.blocked_topk_stats(x, lo)
        iw, ic = TK.blocked_topk_stats(x, lo_int)
        pw, pc = R.blocked_topk_stats(x, lo)
        torch.cuda.synchronize()
        check(torch.equal(words, pw) and torch.equal(counts, pc),
              f"B6 {name} n={n}: kernel != plain version")
        check(torch.equal(iw, pw) and torch.equal(ic, pc),
              f"B6 {name} n={n}, lo a number: kernel != plain version")
        c_lo = int(counts.sum())
        idx, tau, tie_start, budget = C.refine(x, words, c_lo, k)
        tau_f, budget_i = float(tau), int(budget)
        kept, res = TK.threshold_sparsify_exact(x, tau, tie_start, budget)
        nk, nr = TK.threshold_sparsify_exact(x, tau_f, tie_start, budget_i)
        pk, pr = R.threshold_sparsify_exact(x, tau, tie_start, budget)
        torch.cuda.synchronize()
        check(bits_equal(torch, kept, pk) and bits_equal(torch, res, pr),
              f"B7 {name} n={n}: kernel != plain version")
        check(bits_equal(torch, nk, pk) and bits_equal(torch, nr, pr),
              f"B7 {name} n={n}, tau and budget numbers: kernel != plain "
              f"version")
        check(int((kept != 0).sum()) == k
              and torch.equal(torch.nonzero(kept).flatten().int(), idx),
              f"B7 {name}: the kept set is not the refinement's {k}")
        ties_at = int((x.abs() == tau).sum())
        say(f"parity B6/B7 {name} n={n}: bit-exact (B6's lo, B7's tau and "
            f"budget tensors and numbers); c_lo {c_lo}, k {k}, ties at tau "
            f"{ties_at} of which kept {budget_i}")
        if name not in ("bench", "2^27"):
            continue
        iters = 50 if name == "bench" else 10
        recs = {
            "blocked_topk_stats": {
                "max_abs_err": float((words.long() - pw.long()).abs().max()),
                "library_ms": None,
                "ms": KB.cuda_ms(lambda: TK.blocked_topk_stats(x, lo),
                                 iters),
                "int_lo_ms": KB.cuda_ms(
                    lambda: TK.blocked_topk_stats(x, lo_int), iters),
                "plain_ms": KB.cuda_ms(lambda: R.blocked_topk_stats(x, lo),
                                       iters)},
            "threshold_sparsify_exact": {
                "max_abs_err": max(float((kept - pk).abs().max()),
                                   float((res - pr).abs().max())),
                "library_ms": None,
                "ms": KB.cuda_ms(lambda: TK.threshold_sparsify_exact(
                    x, tau, tie_start, budget), iters),
                "plain_ms": KB.cuda_ms(lambda: R.threshold_sparsify_exact(
                    x, tau, tie_start, budget), iters)}}
        # bytes: each input read once, each output written once; ops: a
        # magnitude compare (B6), |x|, two compares and a subtract (B7)
        recs["blocked_topk_stats"]["bound_ms"], \
            recs["blocked_topk_stats"]["bound_by"] = bound_ms(
                4 * n + n / 8 + 4 * nb, n)
        recs["threshold_sparsify_exact"]["bound_ms"], \
            recs["threshold_sparsify_exact"]["bound_by"] = bound_ms(
                12 * n + 4 * nb, 4 * n)
        b6, b7 = recs["blocked_topk_stats"], recs["threshold_sparsify_exact"]
        b6["device_us"] = WC.graph_us(
            torch, lambda: TK.blocked_topk_stats(x, lo))
        b7["device_us"] = WC.graph_us(
            torch, lambda: TK.threshold_sparsify_exact(x, tau, tie_start,
                                                       budget))
        say(f"timing blocked_topk_stats N={n}: kernel, lo a number "
            f"{b6['int_lo_ms']:.6f} ms")
        for kname, r in recs.items():
            say(f"timing {kname} N={n}: device {r['device_us']:.3f} us a "
                f"call (100 calls in a CUDA graph, the path's device "
                f"tensors), {100e3 * r['bound_ms'] / r['device_us']:.1f}% "
                f"of the bound")
        if name == "bench":
            us = WC.host_us(torch, {
                "B6 tensor": lambda: TK.blocked_topk_stats(x, lo),
                "B6 number": lambda: TK.blocked_topk_stats(x, lo_int),
                "B7 tensors": lambda: TK.threshold_sparsify_exact(
                    x, tau, tie_start, budget),
                "B7 numbers": lambda: TK.threshold_sparsify_exact(
                    x, tau_f, tie_start, budget_i)})
            b6["host_us"], b7["host_us"] = us["B6 tensor"], us["B7 tensors"]
            b6["library_host_us"] = b7["library_host_us"] = None
            say(f"host cost B6 blocked_topk_stats N={n}: "
                f"{us['B6 tensor']:.2f} us a call with lo the bracket's "
                f"tensor, {us['B6 number']:.2f} with lo a number (in turns, "
                f"median of 9 rounds)")
            say(f"host cost B7 threshold_sparsify_exact N={n}: "
                f"{us['B7 tensors']:.2f} us a call with tau and the budget "
                f"the refinement's tensors, {us['B7 numbers']:.2f} with "
                f"numbers (in turns, median of 9 rounds)")
        for kname, r in recs.items():
            say(f"timing {kname} N={n}: kernel {r['ms']:.6f} ms")
            say(f"timing {kname} N={n}: plain {r['plain_ms']:.6f} ms")
            say(f"timing {kname} N={n}: library none (no PyTorch call "
                f"computes it)")
            say(f"timing {kname} N={n}: bound {r['bound_ms']:.6f} ms "
                f"({r['bound_by']}), {100 * r['bound_ms'] / r['ms']:.1f}% "
                f"of it")
        if name == "bench":
            out = recs
        del x, words, counts, iw, ic, pw, pc, kept, res, nk, nr, pk, pr, idx
        torch.cuda.empty_cache()
    return out


def host_ms(torch, fn, iters: int) -> float:
    """Mean host-clock time of ``fn()`` ending in a synchronize, after a
    warm-up: for work that waits on the host itself."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def select_card_vs_cpu(torch, np, C, VK) -> None:
    """Phase 9b: select_topk and compress_flat on the card against the
    CPU at each SELECT_SIZES bus and density 0.05 / 0.01."""
    zero = dict.fromkeys(VK.KERNELS, 0)
    for seed, n in enumerate(SELECT_SIZES):
        for density in (0.05, 0.01):
            xc = torch.from_numpy(np_bus(np, n, 70 + seed))
            xg = xc.cuda()
            k = int(n * density)
            lo = C.bracket(xc, k)
            c_lo = int((C.magnitude_bits(xc) >= lo).sum())
            holds = k <= c_lo <= k + C.MARGIN and int(lo) > 0
            VK.reset_launch_count()
            ig = C.select_topk(xg, k)
            torch.cuda.synchronize()
            sel = VK.launch_counts()
            check(torch.equal(ig.cpu(), C.select_topk(xc, k)),
                  f"select_topk n={n} d={density}: card != cpu")
            check(sel == {**zero, "blocked_topk_stats": 1},
                  f"select_topk n={n} d={density}: launches {sel}")
            VK.reset_launch_count()
            pg, rg = C.compress_flat(xg, density=density)
            torch.cuda.synchronize()
            cmp = VK.launch_counts()
            pc, rc = C.compress_flat(xc, density=density)
            for f in ("indices", "values", "scales"):
                check(torch.equal(getattr(pg, f).cpu(), getattr(pc, f)),
                      f"compress_flat n={n} d={density}: {f} card != cpu")
            check(bits_equal(torch, rg.cpu(), rc),
                  f"compress_flat n={n} d={density}: residual card != cpu")
            want = {**zero, "blocked_topk_stats": 1, "quantize_int8": 1,
                    "dequantize_int8": 1,
                    "threshold_sparsify_exact": 1 if holds else 0}
            check(cmp == want, f"compress_flat n={n} d={density}: launches "
                  f"{cmp} != {want}")
            say(f"select/compress n={n} d={density} k={k}: bracket "
                f"{'holds' if holds else 'misses (sort)'}; card == cpu "
                f"(indices, q, scales, residual); launches select "
                f"B6={sel['blocked_topk_stats']}, compress B6="
                f"{cmp['blocked_topk_stats']} B7="
                f"{cmp['threshold_sparsify_exact']}")
            if n == BENCH_N and density == POD_DENSITY:
                a = xg.abs()
                say(f"timing select_topk N={n} k={k} (host clock, one sync "
                    f"a call): {host_ms(torch, lambda: C.select_topk(xg, k), 20):.6f} ms")
                say(f"timing compress_flat N={n} k={k} (host clock): "
                    f"{host_ms(torch, lambda: C.compress_flat(xg, density=density), 20):.6f} ms")
                check(torch.equal(C.sort_topk(xg, k), ig),
                      f"sort_topk n={n}: != the blocked selection")
                say(f"timing sort_topk N={n} k={k} (the stable sort, same "
                    f"indices, host clock): "
                    f"{host_ms(torch, lambda: C.sort_topk(xg, k), 20):.6f} ms")
                say(f"timing torch.topk(|flat|, k) N={n} k={k} (yardstick, "
                    f"host clock): {host_ms(torch, lambda: torch.topk(a, k), 20):.6f} ms")
            del xc, xg, ig, pg, rg, pc, rc
        torch.cuda.empty_cache()


def recording_transport():
    """A LoopbackTransport that keeps every frame it carries in ``sent``."""
    from repro_torch.transfer.transport import LoopbackTransport

    class Recording(LoopbackTransport):
        def send(self, frame):
            self.sent.append(bytes(frame))
            return super().send(frame)

    t = Recording()
    t.sent = []
    return t


def frames_match(np, card: list, cpu: list, label: str) -> None:
    """Frames byte for byte outside the residual-norm field and the crc;
    the norms within 2 f32 ulps (XLA-free f64 sums on both sides, in
    different orders)."""
    check(len(card) == len(cpu) > 0, f"{label}: {len(card)} vs {len(cpu)} "
          f"frames")
    worst = 0
    for a, b in zip(card, cpu):
        ma, mb = bytearray(a), bytearray(b)
        for m in (ma, mb):
            if m[6] == 1:                     # sparse frame
                m[_NORM] = bytes(4)
                m[_CRC] = bytes(4)
        check(ma == mb, f"{label}: frames differ outside the norm and crc")
        if a[6] == 1:
            na, nb_ = (np.frombuffer(f[_NORM], np.int32)[0] for f in (a, b))
            worst = max(worst, abs(int(na) - int(nb_)))
    check(worst <= 2, f"{label}: residual norms {worst} ulps apart")
    say(f"{label}: {len(card)} frames byte-identical outside the norm and "
        f"crc; norms at most {worst} ulp apart")


def pod_round_card_vs_cpu(torch, np, VK) -> dict:
    """Phase 9c: compressed_assimilate on the bench model, card against
    CPU, POD_ROUNDS rounds with the residuals carried.  Returns the card
    rounds' launches."""
    from repro_torch.core import compression as C
    from repro_torch.runtime import vc_runtime as VR
    from repro_torch.transfer import wire
    zero = dict.fromkeys(VK.KERNELS, 0)
    server = bench_model(np, 0)
    rounds, walls, totals = [], [], dict(zero)
    t_card = recording_transport()

    def islands(cur: dict, rnd: int) -> dict:
        """POD_ISLANDS islands = server + 0.01 N(0, 1), island-major."""
        rng = np.random.default_rng(100 + rnd)
        return {k: np.stack([v + np.float32(0.01) * rng.standard_normal(
            v.shape).astype(np.float32) for _ in range(POD_ISLANDS)])
            for k, v in cur.items()}

    def card_rounds():
        srv, res = {k: torch.from_numpy(v).cuda() for k, v in server.items()}, None
        cur = server
        for rnd in range(POD_ROUNDS):
            isl = islands(cur, rnd)
            alive = np.ones(POD_ISLANDS, bool)
            if rnd in POD_DEAD:
                alive[POD_DEAD[rnd]] = False
            isl_g = {k: torch.from_numpy(v).cuda() for k, v in isl.items()}
            torch.cuda.synchronize()
            VK.reset_launch_count()
            t0 = time.perf_counter()
            srv, res = VR.compressed_assimilate(
                srv, isl_g, POD_ALPHA, torch.from_numpy(alive),
                density=POD_DENSITY, residuals=res, transport=t_card)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts = VK.launch_counts()
            check(counts == {**zero, **POD_LAUNCHES},
                  f"pod round {rnd}: launches {counts}")
            for kk, v in counts.items():
                totals[kk] += v
            cur = {k: v.cpu().numpy() for k, v in srv.items()}
            rounds.append((isl, alive, cur,
                           {k: v.cpu().numpy() for k, v in res.items()}))
        return srv, res

    # a warm-up round (first use of every kernel and library), discarded
    VR.compressed_assimilate(
        {k: torch.from_numpy(v).cuda() for k, v in server.items()},
        {k: torch.from_numpy(v).cuda() for k, v in islands(server, 0).items()},
        POD_ALPHA, torch.ones(POD_ISLANDS, dtype=torch.bool),
        density=POD_DENSITY, transport=recording_transport())
    torch.cuda.synchronize()
    (srv, res), spans = host_breakdown(card_rounds, [
        (C, "exact_topk"), (C, "compress_flat"), (wire, "encode_sparse"),
        (wire, "decode"), (C, "decompress_flat")])
    wall = sum(walls)
    for rnd, w in enumerate(walls):
        say(f"pod round {rnd} on cuda: {1e3 * w:.3f} ms (host clock, ending "
            f"in a synchronize), launches {POD_LAUNCHES}")
    for key, sec in sorted(spans.items(), key=lambda kv: -kv[1]):
        say(f"pod host span {key}: {1e3 * sec / POD_ROUNDS:.3f} ms a round "
            f"({100 * sec / wall:.1f}% of the rounds' wall)")

    # one more round under the profiler (its first-use costs are paid)
    from torch.profiler import ProfilerActivity, profile
    last_isl = {k: torch.from_numpy(v).cuda() for k, v in rounds[-1][0].items()}
    alive = torch.ones(POD_ISLANDS, dtype=torch.bool)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        VR.compressed_assimilate(srv, last_isl, POD_ALPHA, alive,
                                 density=POD_DENSITY, residuals=res,
                                 transport=recording_transport())
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    report_profile(prof, f"pod round (profiled wall {pwall:.3f} s)", pwall)
    del srv, res, last_isl
    torch.cuda.empty_cache()

    # the same rounds on the CPU, from the same islands
    t_cpu = recording_transport()
    srv, res = {k: torch.from_numpy(v) for k, v in server.items()}, None
    VK.reset_launch_count()
    for rnd, (isl, alive, want_srv, want_res) in enumerate(rounds):
        srv, res = VR.compressed_assimilate(
            srv, {k: torch.from_numpy(v) for k, v in isl.items()}, POD_ALPHA,
            torch.from_numpy(alive), density=POD_DENSITY, residuals=res,
            transport=t_cpu, device="cpu")
        for k in server:
            check(srv[k].numpy().tobytes() == want_srv[k].tobytes(),
                  f"pod round {rnd}: server leaf {k} card != cpu")
            check(res[k].numpy().tobytes() == want_res[k].tobytes(),
                  f"pod round {rnd}: residual leaf {k} card != cpu")
        say(f"pod round {rnd}: server and residuals card == cpu (bit for "
            f"bit), island {POD_DEAD.get(rnd, 'none')} dead")
    check(VK.launch_count() == 0, "the CPU pod rounds launched a kernel")
    frames_match(np, t_card.sent, t_cpu.sent, "pod rounds")
    check(all(np.isfinite(v).all() for v in rounds[-1][2].values()),
          "pod rounds: server not finite")
    return totals


def coordinator_card_vs_cpu(torch, np, VK) -> None:
    """Phase 9d: CompressedVCASGD(0.9, density=0.05) through the
    Coordinator's issue / submit / deliver / assimilate on the bench
    model's bus, 3 clients for 2 rounds, card against CPU."""
    from repro_torch.core import flat as F
    from repro_torch.core.baselines import CompressedVCASGD
    from repro_torch.protocol import Coordinator
    model = bench_model(np, 1)
    mask = np.arange(BENCH_N) < BENCH_LOGICAL
    runs = {}
    for device in ("cuda", "cpu"):
        coord = Coordinator(
            CompressedVCASGD(0.9, density=POD_DENSITY),
            F.flatten({k: torch.from_numpy(v).to(device)
                       for k, v in model.items()}),
            transport=recording_transport())
        VK.reset_launch_count()
        uid = 0
        for rnd in (1, 2):
            leases = []
            for cid in range(3):
                leases.append(coord.issue(cid=cid, uid=uid, round=rnd,
                                          base=coord.state.params))
                uid += 1
            for lease in leases:
                step = (np.random.default_rng(10 * rnd + lease.cid)
                        .standard_normal(BENCH_N).astype(np.float32)
                        * np.float32(0.01) * mask)
                coord.submit(lease, lease.base.buf
                             + torch.from_numpy(step).to(device))
            for lease in leases:
                coord.assimilate(lease, coord.deliver(lease),
                                 server_version=rnd - 1)
        if device == "cuda":
            torch.cuda.synchronize()
        runs[device] = (coord, VK.launch_counts())
    (cg, counts), (cc, counts_cpu) = runs["cuda"], runs["cpu"]
    want = {**dict.fromkeys(VK.KERNELS, 0), "blocked_topk_stats": 6,
            "threshold_sparsify_exact": 6, "quantize_int8": 6,
            "dequantize_int8": 12, "pack_body": 6, "vc_asgd_lerp_flat": 6}
    check(counts == want, f"coordinator: launches {counts} != {want}")
    check(sum(counts_cpu.values()) == 0, "coordinator: the CPU launched")
    check(bits_equal(torch, cg.state.params.buf.cpu(), cc.state.params.buf),
          "coordinator: server bus card != cpu")
    for cid in range(3):
        check(bits_equal(torch, cg._residuals[cid].cpu(), cc._residuals[cid]),
              f"coordinator: client {cid}'s residual card != cpu")
    frames_match(np, cg.transport.sent, cc.transport.sent, "coordinator")
    say(f"coordinator: 2 rounds x 3 clients, server bus and residual ledger "
        f"card == cpu; launches {counts}")


# ---------------------------------------------------------------------------
# phase 10: the port's kernel bench, with B4, B8 and B11
# ---------------------------------------------------------------------------

# shapes of B1's and B4's per-tensor entries (tests/test_kernels.py:23-50)
RAGGED_SHAPES = ((17,), (255, 9), (3, 5, 7, 11))
DC_MAIN_N = 1 << 24              # the bench's dc_lerp_flat_16M row
B8_TAU = 0.01                    # the bench's threshold_sparsify rows
B11_KS = (656, 1313, 1000, 105_075, BIG_K)
B11_MAIN_K = 105_075             # the bench bus's k (density 0.05)
# every k mod 16 (the value section's last lane, the scale and index
# sections' shifts and seams), and sel / idx off 16-byte boundaries
B11_MOD16_KS = tuple(4096 + r for r in range(16))
B11_OFFSETS = ((0, 0), (1, 0), (0, 3), (2, 1))
BENCH_SUITES = ("kernels", "flat", "flat_adam", "compression", "roofline")


def _record(torch, kern, plain, iters: int, nbytes: float, ops: float,
            err: float) -> dict:
    rec = {"max_abs_err": err, "library_ms": None,
           "ms": KB.cuda_ms(kern, iters),
           "plain_ms": KB.cuda_ms(plain, iters)}
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, ops)
    return rec


def _say_timing(name: str, size: str, r: dict) -> None:
    say(f"timing {name} {size}: kernel {r['ms']:.6f} ms, plain "
        f"{r['plain_ms']:.6f} ms, library none (no single PyTorch call "
        f"computes it), bound {r['bound_ms']:.6f} ms ({r['bound_by']}), "
        f"{100 * r['bound_ms'] / r['ms']:.1f}% of it")


def new_kernels_parity(torch, np, VK, TK, QK, SK, R) -> dict:
    """Phase 10a: B4 (with B1's per-tensor entry), B8 and B11 against
    their plain versions on the card, bit for bit; each timed beside its
    plain version and its bound at the bench's shape and at 2^27 (k =
    6,710,886 for B11).  Returns the records at the bench's shapes."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(10)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)
    out = {}

    # B4 flat and B1 / B4 per tensor
    for n in (MAIN_N, DC_MAIN_N, BIG_N):
        for dtype in (torch.float32, torch.bfloat16):
            s, c, gr, b = (rnd(n).to(dtype) for _ in range(4))
            kern = VK.vc_asgd_dc_lerp_flat(s, c, gr, b, POD_ALPHA, 0.05)
            plain = R.vc_asgd_dc_lerp(s, c, gr, b, POD_ALPHA, 0.05)
            torch.cuda.synchronize()
            check(bits_equal(torch, kern, plain),
                  f"B4 {dtype} N={n}: kernel != plain version")
            for name, k_, p_ in (
                    ("B1 vc_asgd_lerp", VK.vc_asgd_lerp(s, c, 0.95),
                     R.vc_asgd_lerp(s, c, 0.95)),
                    ("B4 vc_asgd_dc_lerp", VK.vc_asgd_dc_lerp(
                        s, c, gr, b, 0.95, 0.04), R.vc_asgd_dc_lerp(
                        s, c, gr, b, 0.95, 0.04))):
                check(bits_equal(torch, k_, p_),
                      f"{name} {dtype} N={n}: kernel != plain version")
            say(f"parity B4 vc_asgd_dc_lerp_flat and the per-tensor B1 / B4 "
                f"{str(dtype)[6:]} N={n}: bit-exact")
            if dtype == torch.float32 and n != MAIN_N:
                rec = _record(
                    torch, lambda: VK.vc_asgd_dc_lerp_flat(
                        s, c, gr, b, POD_ALPHA, 0.05),
                    lambda: R.vc_asgd_dc_lerp(s, c, gr, b, POD_ALPHA, 0.05),
                    20 if n == DC_MAIN_N else 10, 20 * n, 8 * n,
                    float((kern - plain).abs().max()))
                _say_timing("vc_asgd_dc_lerp_flat", f"N={n}", rec)
                if n == DC_MAIN_N:
                    out["vc_asgd_dc_lerp_flat"] = rec
            del s, c, gr, b, kern, plain
        torch.cuda.empty_cache()
    for shape in RAGGED_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            s, c, gr, b = (rnd(*shape).to(dtype) for _ in range(4))
            k1, k4 = (VK.vc_asgd_lerp(s, c, 0.95),
                      VK.vc_asgd_dc_lerp(s, c, gr, b, 0.95, 0.04))
            check(k1.shape == k4.shape == s.shape
                  and bits_equal(torch, k1, R.vc_asgd_lerp(s, c, 0.95))
                  and bits_equal(torch, k4, R.vc_asgd_dc_lerp(
                      s, c, gr, b, 0.95, 0.04)),
                  f"B1 / B4 per tensor {shape} {dtype}: kernel != plain")
        say(f"parity B1 / B4 per tensor {shape} f32 and bf16: bit-exact")

    # B8
    for name, n, dtype in (("bench", BENCH_N, torch.float32),
                           ("ragged", 9000, torch.float32),
                           ("bench bf16", BENCH_N, torch.bfloat16),
                           ("2^27", BIG_N, torch.float32)):
        x = (rnd(n) * 0.02).to(dtype)
        x[::13] = -0.0
        (kk, kr), (pk, pr) = (TK.threshold_sparsify(x, B8_TAU),
                              R.threshold_sparsify(x, B8_TAU))
        torch.cuda.synchronize()
        check(bits_equal(torch, kk, pk) and bits_equal(torch, kr, pr),
              f"B8 {name} n={n}: kernel != plain version")
        check(torch.equal(kk.float() + kr.float(), x.float()),
              f"B8 {name}: kept + residual != x")
        say(f"parity B8 threshold_sparsify {name} n={n} tau {B8_TAU}: "
            f"bit-exact, {int((kk != 0).sum())} kept")
        if name in ("bench", "2^27"):
            rec = _record(torch, lambda: TK.threshold_sparsify(x, B8_TAU),
                          lambda: R.threshold_sparsify(x, B8_TAU),
                          50 if name == "bench" else 10, 12 * n, 3 * n,
                          max(float((kk - pk).abs().max()),
                              float((kr - pr).abs().max())))
            _say_timing("threshold_sparsify", f"N={n}", rec)
            if name == "bench":
                out["threshold_sparsify"] = rec
        del x, kk, kr, pk, pr
    torch.cuda.empty_cache()

    # B11 at every k mod 16, sel / idx at element offsets from their
    # allocation, the wire's block and a generic one
    for k in B11_MOD16_KS:
        for so, io in B11_OFFSETS:
            sel = (rnd(k + so) * 0.01)[so:]
            idx = torch.randint(0, 2 ** 31 - 1, (k + io,), generator=g,
                                device=dev, dtype=torch.int32)[io:]
            for block in ((QBLOCK, 100) if (so, io) == (0, 0) else
                          (QBLOCK,)):
                (kb, kq, ks_), (pb, pq, ps) = (
                    SK.quantize_pack(sel, idx, block),
                    R.quantize_pack(sel, idx, block))
                torch.cuda.synchronize()
                check(torch.equal(kb, pb) and torch.equal(kq, pq)
                      and bits_equal(torch, ks_, ps),
                      f"B11 k={k} sel/idx at +{so}/+{io} block {block}: "
                      f"kernel != plain version")
    say(f"parity B11 quantize_pack at k = {B11_MOD16_KS[0]}.."
        f"{B11_MOD16_KS[-1]} (every k mod 16), sel / idx at element "
        f"offsets {B11_OFFSETS}, block {QBLOCK} and 100: byte-exact")

    # B11, and B12 of B9's payload
    for k in B11_KS:
        ng = -(-k // QBLOCK)
        sel = rnd(k) * 0.01
        sel[k // 3] = 0.0
        idx = torch.sort(torch.randperm(BIG_N, generator=g, device=dev)[:k]
                         ).values.to(torch.int32)
        (kb, kq, ks_), (pb, pq, ps) = (SK.quantize_pack(sel, idx),
                                       R.quantize_pack(sel, idx))
        q9, s9 = QK.quantize_int8(sel)
        b12 = SK.pack_body(q9, s9, idx)
        torch.cuda.synchronize()
        check(kb.numel() == 5 * k + 4 * ng and torch.equal(kb, pb)
              and torch.equal(kq, pq) and bits_equal(torch, ks_, ps),
              f"B11 k={k}: kernel != plain version")
        check(torch.equal(kb, b12), f"B11 k={k}: body != B12(B9(sel))")
        say(f"parity B11 quantize_pack k={k}: body, q and scales "
            f"byte-exact; body == pack_body(quantize_int8(sel))")
        if k in (B11_MAIN_K, BIG_K):
            nbytes = 8 * k + (5 * k + 4 * ng) + ng * QBLOCK + 4 * ng
            rec = _record(torch, lambda: SK.quantize_pack(sel, idx),
                          lambda: R.quantize_pack(sel, idx),
                          50 if k == B11_MAIN_K else 10, nbytes, 5 * k,
                          float((kb.int() - pb.int()).abs().max()))
            _say_timing("quantize_pack", f"k={k}", rec)
            if k == B11_MAIN_K:
                out["quantize_pack"] = rec
        del sel, idx, kb, kq, ks_, pb, pq, ps, q9, s9, b12
    torch.cuda.empty_cache()
    return out


def bench_on_card(VK) -> dict:
    """Phase 10b: the port's bench (repro_torch.benchmarks.run, every
    suite) in this process on the card with --check: the launch gate
    must equal results/BASELINE_launches.json, every suite's rows and
    the roofline table must print.  Returns the run's launches."""
    import contextlib
    import io
    from repro_torch.benchmarks import run as bench
    buf = io.StringIO()
    VK.reset_launch_count()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(["--only", ",".join(BENCH_SUITES), "--check"])
    counts = VK.launch_counts()
    lines = buf.getvalue().splitlines()
    for line in lines:
        say(f"bench {line}")
    check(rc == 0, "bench --check: the launch gate failed (see stderr)")
    check(lines[0] == "name,us_per_call,derived", "bench: no CSV header")
    for suite in BENCH_SUITES:
        rows = [ln for ln in lines[1:] if ln.startswith(suite + ".")]
        check(len(rows) >= 4 and all(ln.count(",") == 2 for ln in rows),
              f"bench suite {suite}: rows missing or malformed")
    ckpt = [ln.split(",") for ln in lines
            if ln.startswith("flat_adam.train_ckpt_one_pass,")]
    check(len(ckpt) == 1 and float(ckpt[0][1]) > 0
          and "launches=" not in ckpt[0][2],
          "bench: flat_adam.train_ckpt_one_pass not timed (or it launched)")
    say(f"bench: {len(lines) - 1} rows, launch gate == "
        f"results/BASELINE_launches.json; launches {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 11: the paper's preemptible-instance story
# ---------------------------------------------------------------------------

# 11a: run_preemptible_training at the MLP's full published width, killed
# before steps 13 and 27 (records every 10 steps: 3 + 7 steps recomputed)
PRE_STEPS, PRE_BATCH, PRE_EVERY, PRE_KILLS = 40, 64, 10, (13, 27)
# the card's losses against the CPU's, step by step (the same f32 math in
# another order: cuBLAS against the CPU's GEMMs): 4.77e-7 measured on an
# H100, two f32 ulps of a loss near 2; the limit leaves 20x
PRE_LOSS_TOL = 1e-5
# 11b: results folded after a restore, card against CPU
AFTER_RESTORE = 3


def ckpt_dir():
    """A fresh directory under the checkout's ignored build/ for phase
    11's records."""
    import tempfile
    base = ROOT / "build" / "ckpt"
    base.mkdir(parents=True, exist_ok=True)
    return tempfile.TemporaryDirectory(dir=base)


def preemptible_on_card(torch, VK) -> None:
    """Phase 11a: kill-and-restore training on the card (B3 every step):
    killed at PRE_KILLS, the loss at every step and the final bus equal
    the uninterrupted run's bit for bit; 2 restores, 10 recomputed steps,
    B3 launches = steps + recomputed steps; the same run on the CPU within
    PRE_LOSS_TOL a step; a record written on the card restores on the CPU
    bit for bit and the other way round (params, m, v, step, and the
    re-saved file byte for byte)."""
    from repro_torch.checkpoint import (load_train_checkpoint,
                                        save_train_checkpoint)
    from repro_torch.core.preemption import KillSchedule
    from repro_torch.core.simulator import run_preemptible_training
    from repro_torch.core.tasks import MLPTask, make_classification_data
    data = make_classification_data()
    with ckpt_dir() as d:
        d = Path(d)

        def train(name, device, kills=()):
            VK.reset_launch_count()
            t0 = time.perf_counter()
            res = run_preemptible_training(
                MLPTask(), data, steps=PRE_STEPS, batch=PRE_BATCH,
                ckpt_every=PRE_EVERY, ckpt_dir=d / name, seed=0,
                device=device,
                kill_schedule=KillSchedule.at(*kills) if kills else None)
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = VK.launch_counts()
            say(f"preemptible {name} on {device}: {res.steps_done} steps, "
                f"{res.restores} restores, {res.recomputed_steps} "
                f"recomputed, wall {wall:.3f} s, B3 launches "
                f"{counts['adam_update_flat']}, final loss "
                f"{res.losses[PRE_STEPS - 1]:.6f}")
            return res, counts

        clean, counts = train("clean", "cuda")
        check(counts["adam_update_flat"] == PRE_STEPS,
              f"clean run: {counts['adam_update_flat']} B3 launches")
        killed, counts = train("killed", "cuda", PRE_KILLS)
        check(killed.restores == 2 and killed.recomputed_steps == 10,
              f"killed run: {killed.restores} restores, "
              f"{killed.recomputed_steps} recomputed steps")
        check(counts["adam_update_flat"] == PRE_STEPS + 10,
              f"killed run: {counts['adam_update_flat']} B3 launches != "
              f"{PRE_STEPS} steps + 10 recomputed")
        check(sum(counts.values()) == counts["adam_update_flat"],
              f"killed run launched other kernels: {counts}")
        check(killed.trajectory() == clean.trajectory(),
              "killed and clean loss trajectories differ on the card")
        check(bits_equal(torch, killed.final_params.buf,
                         clean.final_params.buf),
              "killed and clean final params differ on the card")
        say(f"preemptible: killed at {PRE_KILLS} == clean, every one of "
            f"{PRE_STEPS} losses and the final bus bit for bit")
        host, counts = train("host", "cpu", PRE_KILLS)
        check(sum(counts.values()) == 0, "the CPU run launched a kernel")
        gap = max(abs(host.losses[s] - clean.losses[s])
                  for s in range(PRE_STEPS))
        say(f"preemptible: card vs CPU max loss gap {gap:.3g} (tolerance "
            f"{PRE_LOSS_TOL})")
        check(gap <= PRE_LOSS_TOL, f"card vs CPU loss gap {gap}")
        for src, res, other in (("killed", killed, "cpu"),
                                ("host", host, "cuda")):
            path = d / src / f"ckpt_{PRE_STEPS:08d}.msgpack"
            fp, opt, extra = load_train_checkpoint(path, res.final_params)
            fo, oo, _ = load_train_checkpoint(path, res.final_params,
                                              device=other)
            check(fo.buf.device.type == other and oo.step == opt.step
                  == PRE_STEPS, f"{src} record on {other}")
            for a, b in ((res.final_params.buf, fo.buf), (fp.buf, fo.buf),
                         (opt.m, oo.m), (opt.v, oo.v)):
                check(bits_equal(torch, a.cpu(), b.cpu()),
                      f"{src} record restored on {other} differs")
            again = d / f"{src}-on-{other}.msgpack"
            save_train_checkpoint(again, fo, oo, extra)
            check(again.read_bytes() == path.read_bytes(),
                  f"{src} record re-saved from {other} differs")
            say(f"preemptible: the {src} run's record "
                f"({path.stat().st_size} bytes) restores on {other} bit "
                f"for bit and re-saves byte for byte")


def coordinator_checkpoints(torch, np, VK) -> None:
    """Phase 11b: Coordinator.save_checkpoint / restore_checkpoint on the
    card with VCASGD (B1) and EASGDFlatPod (B5): after a restore into a
    coordinator built from other params the next handout is the saved
    center (the pod's replicas tiled from it), and AFTER_RESTORE more
    results folded on the card equal the same folded on the CPU from the
    same record, bit for bit (B1 and B5 against their plain versions)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import flat as F
    from repro_torch.core.baselines import VCASGD, EASGDFlatPod
    from repro_torch.core.tasks import MLPTask
    from repro_torch.protocol import Coordinator
    task = MLPTask()
    rng = np.random.default_rng(11)

    def results(n):
        return [rng.standard_normal(MAIN_N).astype(np.float32) * 0.01
                for _ in range(n)]

    def fold(coord, bufs, cids, uid0):
        for j, (buf, cid) in enumerate(zip(bufs, cids)):
            lease = coord.issue(cid=cid, uid=uid0 + j, round=1,
                                base=coord.state.params)
            coord.submit(lease, lease.base.buf + torch.from_numpy(buf).to(
                lease.base.buf.device))
            coord.assimilate(lease, coord.deliver(lease),
                             server_version=coord.state.version)

    for name, make, cids in (
            ("VCASGD", lambda: VCASGD(0.9), (0, 1, 2)),
            ("EASGDFlatPod", lambda: EASGDFlatPod(n_replicas=2, beta=0.1),
             (0, 1, 0))):
        with ckpt_dir() as d:
            VK.reset_launch_count()
            coord = Coordinator(make(), F.flatten(task.init_params(
                1, device="cuda")))
            fold(coord, results(2), (0, 1), 0)
            saved = coord.state.params.buf.clone()
            mgr = CheckpointManager(d, async_save=False)
            coord.save_checkpoint(mgr, step=5, extra={"next_uid": 2})
            after = results(AFTER_RESTORE)
            resumed = {}
            for device in ("cuda", "cpu"):
                c = Coordinator(make(), F.flatten(task.init_params(
                    2, device=device)))
                check(c.restore_checkpoint(mgr) == 5
                      and c.restored_extra["next_uid"] == 2
                      and c.state.version == coord.state.version,
                      f"{name} restore on {device}")
                lease = c.issue(cid=0, uid=100, round=1,
                                base=c.state.params)
                check(bits_equal(torch, lease.base.buf.cpu(), saved.cpu()),
                      f"{name} on {device}: the next handout is not the "
                      f"saved center")
                c.drop(lease)
                if name == "EASGDFlatPod":
                    check(all(bits_equal(torch, r.cpu(), saved.cpu())
                              for r in c.state.replicas),
                          f"{name} on {device}: replicas not tiled from "
                          f"the saved center")
                fold(c, after, cids, 200)
                resumed[device] = c.state
            counts = {k: v for k, v in VK.launch_counts().items() if v}
            card, host = resumed["cuda"], resumed["cpu"]
            check(bits_equal(torch, card.params.buf.cpu(), host.params.buf),
                  f"{name}: card and CPU folds after the restore differ")
            if name == "EASGDFlatPod":
                check(bits_equal(torch, card.replicas.cpu(), host.replicas)
                      and set(card.pending) == set(host.pending) == {0}
                      and bits_equal(torch, card.pending[0].cpu(),
                                     host.pending[0]),
                      f"{name}: replicas or pending rows differ")
                check(counts == {"easgd_elastic_flat": 2},
                      f"{name}: launches {counts}, expected 2 B5 (one round "
                      f"before the save, one after)")
            else:
                check(counts == {"vc_asgd_lerp_flat": 2 + AFTER_RESTORE},
                      f"{name}: launches {counts}, expected "
                      f"{2 + AFTER_RESTORE} B1")
            say(f"coordinator checkpoint {name}: restored on card and CPU, "
                f"next handout == saved center, {AFTER_RESTORE} folds after "
                f"it card == CPU bit for bit; launches {counts}")


def paper_suites_on_card(torch, VK) -> None:
    """Phase 11c: the cost and fig6 suites (repro_torch.benchmarks.
    paper_figs, quick) on the card: their claims and walls; fig6's hours
    equal the same suite's on the CPU and its accuracy curves agree
    within ACC_BAND."""
    from repro_torch.benchmarks import paper_figs as PFIGS
    out = {}
    for suite in ("cost", "fig6"):
        for device in ("cuda", "cpu"):
            VK.reset_launch_count()
            t0 = time.perf_counter()
            res = PFIGS.SUITES[suite](True, device)
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {k: v for k, v in VK.launch_counts().items() if v}
            say(f"paper suite {suite} on {device}: wall {wall:.3f} s, claims "
                f"{res['_claims']}, launches {counts}")
            check(all(res["_claims"].values()),
                  f"paper suite {suite} on {device}: a claim failed")
            out[suite, device] = res
    cost = out["cost", "cuda"]
    say(f"paper suite cost: {json.dumps(cost)}")
    card, host = out["fig6", "cuda"], out["fig6", "cpu"]
    for curve in ("distributed", "serial"):
        check([p["hours"] for p in card[curve]]
              == [p["hours"] for p in host[curve]],
              f"fig6 {curve}: hours differ card vs CPU")
        worst = max(abs(a["acc"] - b["acc"])
                    for a, b in zip(card[curve], host[curve]))
        check(worst <= ACC_BAND, f"fig6 {curve}: accuracy gap {worst}")
        say(f"paper suite fig6 {curve}: hours card == CPU, max accuracy "
            f"gap {worst:.4f}; final acc {card[curve][-1]['acc']}")


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
    global KB, LA
    import numpy as np
    from repro_torch.benchmarks import kernel_bench as KB
    from repro_torch.kernels import launches as LA
    from repro_torch.core import vc_asgd as V
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FK
    from repro_torch.kernels import mamba_scan as MK
    from repro_torch.kernels import quantize as QK
    from repro_torch.kernels import ref as R
    from repro_torch.kernels import rwkv6_scan as WK
    from repro_torch.core import compression as C
    from repro_torch.kernels import sparse_pack as SK
    from repro_torch.kernels import topk_mask as TK
    from repro_torch.kernels import vc_asgd_update as VK
    from repro_torch.kernels.launches import REPLACES, ROUTES, SOURCE

    # ---- 1. device --------------------------------------------------------
    phases = Phases()
    phases.start("1")
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
    phases.start("2")
    t0 = time.perf_counter()
    libs = build.build_all()
    say(f"build: {len(libs)} source(s) in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.build_seconds:.2f} s)")
    for name, log in build.build_log.items():
        for line in log.splitlines():
            if ("registers" in line or "spill" in line or "error" in line
                    or "entry function" in line):
                say(f"ptxas {name}: {line.strip()}")

    # ---- 3. kernel parity -------------------------------------------------
    phases.start("3")
    numbers = parity(torch, np, VK, R, MAIN_N, timed=True)
    numbers.update(parity_scheme_kernels(torch, np, (VK, QK, SK), R, MAIN_N,
                                         MAIN_K, timed=True))
    for name, rec in wrapper_host_cost(torch, np, VK, SK, QK, TK,
                                       LA).items():
        numbers[name].update(rec)
    say_ptxas(build, "quantize", "B9", "quantize_kernel")
    say_ptxas(build, "vc_asgd_update", "B5", "easgd_kernel")
    parity(torch, np, VK, R, BIG_N, timed=True)
    torch.cuda.empty_cache()
    parity_scheme_kernels(torch, np, (VK, QK, SK), R, BIG_N, (BIG_K,),
                          timed=True)
    torch.cuda.empty_cache()

    # ---- 4a. quickstart --smoke: card vs CPU ------------------------------
    phases.start("4a")
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
    phases.start("4b")
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
    phases.start("4c")
    profile_smoke(torch, VK)
    from repro_torch.core.tasks import MLPTask
    from repro_torch.optim.optimizers import Adam
    from repro_torch.protocol.coordinator import Coordinator
    VK.reset_launch_count()
    (res, wall), spans = host_breakdown(
        lambda: run("cuda", smoke=False),
        [(MLPTask, "client_train"), (Adam, "update_flat"),
         (MLPTask, "evaluate"), (Coordinator, "issue"),
         (Coordinator, "submit"), (Coordinator, "deliver"),
         (Coordinator, "assimilate")])
    main_counts = check_counts(VK, res, "quickstart on cuda")
    check(res.epochs_done == QUICKSTART_EPOCHS
          and np.isfinite(res.final_accuracy),
          f"quickstart did not finish its {QUICKSTART_EPOCHS} epochs")
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
    adam_s = spans.get("Adam.update_flat", 0.0)
    say(f"host span Adam.update_flat: {1e6 * adam_s / res.client_steps:.2f} "
        f"us a client step, {100 * adam_s / spans['MLPTask.client_train']:.1f}"
        f"% of client_train (inside it)")

    # ---- 4d. the pinned replay: every scheme, card vs CPU vs the pin ------
    phases.start("4d")
    pinned_counts = pinned_replay(torch, VK)
    say(f"pinned replay: launches summed over the 12 cases {pinned_counts}")

    # ---- 4e. the §IV-C comparison at the example's full configuration -----
    phases.start("4e")
    comparison(torch, VK)

    # ---- 6. serve: B13, internlm2-1.8b at full width, card vs CPU -------
    phases.start("6")
    numbers["flash_attention"] = attention_parity(torch, np, FK, R)   # 6a
    say_ptxas(build, "flash_attention_sm90", "B13 wgmma kernel")
    attention_host_cost(torch, FK)
    torch.cuda.empty_cache()
    serve_counts = serve_full_width(torch, VK)                        # 6b
    serve_card_vs_cpu(torch, VK, depth_cut("internlm2-1.8b"),       # 6c
                      {"flash_attention": CMP_LAYERS}, ATTN_ROUTES)

    # ---- 7. serve rwkv6: B14, rwkv6-1.6b at full width, card vs CPU -----
    phases.start("7")
    numbers["wkv6"] = wkv6_parity(torch, WK, R)                       # 7a
    rwkv_counts = serve_rwkv_full_width(torch, VK)                    # 7b
    serve_card_vs_cpu(torch, VK, depth_cut("rwkv6-1.6b"),           # 7c
                      {"wkv6": CMP_LAYERS})

    # ---- 8. serve jamba: B15, jamba-v0.1 one group at full width --------
    phases.start("8")
    numbers["mamba_scan"] = mamba_scan_parity(torch, MK, R)           # 8a
    say_ptxas(build, "mamba_scan", "B15")
    jamba_counts = serve_jamba_full_width(torch, VK)                  # 8b
    serve_card_vs_cpu(torch, VK, jamba_config(JAMBA_CMP_BLOCKS),      # 8c
                      {"mamba_scan": 1, "flash_attention": 1}, ATTN_ROUTES)

    # ---- 9. the pod runtime's compressed cross-pod round ----------------
    phases.start("9")
    numbers.update(topk_parity(torch, np, TK, C, R))                  # 9a
    say_ptxas(build, "topk_mask", "B6", "stats_kernel")
    say_ptxas(build, "topk_mask", "B7", "exact_kernel")
    select_card_vs_cpu(torch, np, C, VK)                              # 9b
    pod_counts = pod_round_card_vs_cpu(torch, np, VK)                 # 9c
    coordinator_card_vs_cpu(torch, np, VK)                            # 9d

    # ---- 10. the port's kernel bench, with B4, B8 and B11 ----------------
    phases.start("10a")
    numbers.update(new_kernels_parity(torch, np, VK, TK, QK, SK, R))  # 10a
    phases.start("10b")
    bench_counts = bench_on_card(VK)                                  # 10b

    # ---- 11. the preemptible-instance story -----------------------------
    phases.start("11a")
    preemptible_on_card(torch, VK)                                    # 11a
    phases.start("11b")
    coordinator_checkpoints(torch, np, VK)                            # 11b
    phases.start("11c")
    paper_suites_on_card(torch, VK)                                   # 11c

    # ---- 12. result lines -------------------------------------------------
    phases.end()
    path_counts = {"assimilate_flat": eq2_counts,        # 4b
                   "vc_asgd_lerp_flat": main_counts,     # 4c
                   "adam_update_flat": main_counts,      # 4c
                   "flash_attention": serve_counts,      # 6b
                   "wkv6": rwkv_counts,                  # 7b
                   "mamba_scan": jamba_counts,           # 8b
                   "blocked_topk_stats": pod_counts,     # 9c
                   "threshold_sparsify_exact": pod_counts,
                   "vc_asgd_dc_lerp_flat": bench_counts,  # 10b
                   "threshold_sparsify": bench_counts,    # 10b
                   "quantize_pack": bench_counts}         # 10b
    kernels = []
    for name in VK.KERNELS:
        r = numbers[name]
        launches = path_counts.get(name, pinned_counts)[name]   # else 4d
        check(launches > 0, f"{name} was never launched on its path")
        entry = {
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        if "host_us" in r:          # host us a wrapper call, where taken
            entry["host_us"] = r["host_us"]
            entry["library_host_us"] = r["library_host_us"]
        if name in ROUTES:          # B13: the main path's route, and both
            entry["source"] = ROUTES[name]["wgmma"]
            entry["sources"] = ROUTES[name]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
