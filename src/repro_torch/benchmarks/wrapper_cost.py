"""Per-call cost of five kernel wrappers of the main path — B1
(``vc_asgd_lerp_flat``, Eq. 1) and B3 (``adam_update_flat``, fused Adam)
of the training loop, B2 (``assimilate_flat``, Eq. 2 over n = 4 clients)
of the batched fold, B12 (``pack_body``) of every sparse frame and B10
(``dequantize_int8``) of every compressed submit and sparse assimilation
— beside the one PyTorch call that computes the same function
(``torch.lerp``, ``torch._fused_adam_``, ``torch.addmv``, ``torch.cat``
of the three byte views, ``torch.mul`` of the zero-padded q by its
scales), of B9 (``quantize_int8``, every compressed submit), B11
(``quantize_pack``), B6 (``blocked_topk_stats``, the selection of every
compressed round, ``lo`` as the bracket's device int32 [1] and as a
number), B7 (``threshold_sparsify_exact``, the emit after it, ``tau``,
``tie_start`` and the budget as the refinement hands them, and ``tau``
and the budget as numbers) and B5 (``easgd_elastic_flat``, the pod
baseline's elastic round over 3 replicas), none of which one PyTorch call
computes, of B13's wrapper, and B14's and B15's times at rwkv6-1.6b's and
jamba's prefill shapes.

    python src/repro_torch/benchmarks/wrapper_cost.py [--src DIR] [--label L]

Needs one CUDA card.  ``--src`` imports ``repro_torch`` from DIR (default:
this checkout's ``src``), so that two checkouts can be timed in turns on
one card, each in its own process (A, B, B, A).  Prints one JSON line:

* ``host_us``: host microseconds a call, the host clock around
  ``HOST_CALLS`` back-to-back calls at the main sizes (the MLP bus, N =
  16,384 f32; its sparse payload, k = 656, for B12, B10 and B9; B11 at
  the bench bus's k = 105,075; B6 and B7 on the bench bus, 2,105,344
  elements; B5 at 16,384 with 3 replicas), where the kernel is about as
  long as the call or shorter;
  every call of the tree and every stage below timed in turns,
  ``ROUNDS`` rounds, the median kept;
* ``event_ms``: CUDA-event milliseconds a call over 50 calls at the main
  sizes and 10 at N = 2^27 / k = 6,710,886 (B11 and B9 there too; B6
  and B7 on 2^27 elements, B5 with 3 replicas), the calls of one size in
  turns (A B B A, twice, after a warm-up), the mean kept;
* ``graph_us``: device microseconds a call at the main sizes, the calls
  captured 100 at a time in one CUDA graph and replayed (no host work
  between launches: what is left is the kernel and the launch gap);
* ``bound_ms``: bytes moved at 3.35 TB/s at 2^27 / k = 6,710,886 (12 B
  an element for Eq. 1, 28 for Adam, 4 (n + 2) for Eq. 2; twice the
  body's 5k + 4 ng bytes for the pack; 5k + 4 ng for the dequantize and
  the quantize; sel and idx read, body, q and scales written for B11; x
  read, the words and counts written, 4n + n / 8 + 4 nb, for B6; x
  read, kept and residual written, tie_start read, 12n + 4 nb, for B7;
  8 (n + 1) N for B5 over n replicas), the same at the main sizes beside
  ``graph_us`` for B6, B7 and B5, B14's at [4,
  32, 2,048, 64] f32 (337.6 MB), and B15's at jamba's prefill shape (the
  SFU's exps at 16 a clock an SM at 1.98 GHz, 0.2568 ms; its 540 MB take
  0.161);
* ``stages_us``: where a wrapper call's host time goes (checks, scalars
  or weights, output allocation, stream lookup, the ctypes call with its
  launch), each stage alone, timed in the same turns as ``host_us`` (only
  the stages a tree's wrappers expose);
* ``b13_host_us``: one B13 wrapper call on each route at [1, 4/2, 128,
  128], as ``chip_smoke.py`` phase 6a times it;
* ``b14_ms``: CUDA-event ms of one B14 call at rwkv6-1.6b's prefill
  shape, [4, 32, 2,048, 64] f32 (chip_smoke.py phase 7a's shape a), 10
  calls a timing after a warm-up, the mean of four timings;
* ``b15_ms``: the same for B15 at jamba-v0.1's prefill shape, u [4,
  2,048, 8,192] bf16, ds 16, B and C column views of an x_proj output
  (chip_smoke.py phase 8a's shape d);
* ``bench``: the CSV rows of the port's ``flat`` and ``flat_adam``
  suites (``repro_torch.benchmarks.run``);
* ``client_step_us``: host microseconds of one client step of the
  quickstart MLP (``MLPTask.client_train``, TRAIN_STEPS steps on the
  16,384-element bus, ending in a synchronize) and of the
  ``Adam.update_flat`` inside it (B3's call and what surrounds it), the
  median of ROUNDS runs.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

MAIN_N, BIG_N = 16384, 2 ** 27
# B12's payload at each bus size: the MLP's upload at density 0.05, and
# 0.05 of 2^27
PACK_K = {MAIN_N: 656, BIG_N: int(BIG_N * 0.05)}
# B11's payload beside each: the bench bus's (0.05 of 2,101,504), and
# 0.05 of 2^27
QPACK_K = {MAIN_N: 105_075, BIG_N: int(BIG_N * 0.05)}
# B6's bus beside each: the bench bus (its path's, 257 tiles), and 2^27
TOPK_N = {MAIN_N: 2_105_344, BIG_N: BIG_N}
TOPK_DENSITY = 0.05
N_CLIENTS = 4                    # B2: 4b's batch of four results
N_REPLICAS, BETA = 3, 0.05       # B5: the pod baseline (easgd-flat-pod)
QBLOCK = 256
HOST_CALLS, ROUNDS = 200, 9
WARM_S = 2.0                     # device warm-up before a timing at 2^27
TRAIN_STEPS = 600
HBM_BYTES_PER_S = 3.35e12
ALPHA, T = 2.0 / 3.0, 3
HYPER = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8)


def host_us(torch, fns: dict) -> dict:
    """Median host microseconds of one call of each of ``fns``: ROUNDS
    rounds, each timing HOST_CALLS back-to-back calls of every function
    in turn (forward, then backward order); enqueue only, the card
    catches up between timings."""
    for fn in fns.values():
        for _ in range(3):
            fn()
    runs = {k: [] for k in fns}
    keys = list(fns)
    for r in range(ROUNDS):
        for k in (keys if r % 2 == 0 else keys[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fns[k]()
            runs[k].append(1e6 * (time.perf_counter() - t0) / HOST_CALLS)
    torch.cuda.synchronize()
    return {k: statistics.median(v) for k, v in runs.items()}


def event_ms(torch, fns: dict, iters: int) -> dict:
    """Mean CUDA-event milliseconds of one call of each of ``fns`` over
    ``iters`` back-to-back calls, timed in turns (A B B A, twice) after
    WARM_S seconds of the first function (clocks up)."""
    fn0 = next(iter(fns.values()))
    t_end = time.perf_counter() + WARM_S
    while time.perf_counter() < t_end:
        fn0()
        torch.cuda.synchronize()
    keys = list(fns)
    runs = {k: [] for k in fns}
    for k in (keys + keys[::-1]) * 2:
        fn = fns[k]
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
        runs[k].append(t0.elapsed_time(t1) / iters)
    return {k: sum(v) / len(v) for k, v in runs.items()}


def graph_us(torch, fn, reps: int = 100) -> float:
    """Device microseconds of one ``fn()``: ``reps`` calls captured in a
    CUDA graph, the graph replayed between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    t1.synchronize()
    return 1e3 * t0.elapsed_time(t1) / reps


def calls(torch, np, VK, SK, QK, TK, n: int) -> dict:
    """name -> a zero-argument call at bus size ``n`` (f32; B12, B10 and
    B9 at ``PACK_K[n]``, B11 at ``QPACK_K[n]``, B6 and B7 on
    ``TOPK_N[n]``, B5 over N_REPLICAS replicas)."""
    from repro_torch.core.vc_asgd import assimilation_weights
    g = torch.Generator(device="cuda").manual_seed(n)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")
    s, c = rnd(n), rnd(n)
    p, gr, m, v = rnd(n), rnd(n), rnd(n), rnd(n).abs()
    c1 = np.float32(1) - np.float32(HYPER["b1"]) ** np.float32(T)
    c2 = np.float32(1) - np.float32(HYPER["b2"]) ** np.float32(T)
    a32 = float(np.float32(ALPHA))
    lp, lm, lv = p.clone(), m.clone(), v.clone()
    step = [torch.tensor(float(T), device="cuda")]
    cl = rnd(N_CLIENTS, n)
    w = assimilation_weights(N_CLIENTS, ALPHA)
    w32 = torch.tensor(np.asarray(w[1:], np.float32), device="cuda")
    w0, clt = float(np.float32(w[0])), cl.t()
    k = PACK_K[n]
    q, sc, idx = pack_payload(torch, g, k)
    qb, sb, ib = (t.view(torch.uint8) for t in (q, sc, idx))
    ng = sc.numel()
    q_pad = torch.zeros(ng * QBLOCK, dtype=torch.int8, device="cuda")
    q_pad[:k] = q
    q_rows, sc_col = q_pad.view(ng, QBLOCK), sc[:, None]
    sel = rnd(QPACK_K[n]) * 0.01
    sidx = torch.randint(0, 2 ** 31 - 1, (QPACK_K[n],), generator=g,
                         device="cuda", dtype=torch.int32)
    x9 = rnd(k) * 0.01
    bus, lo = topk_bus(torch, g, TOPK_N[n])
    lo_int = int(lo)
    tau, tie_start, budget = exact_inputs(torch, TK, bus, lo)
    tau_f, budget_i = float(tau), int(budget)
    ec, ex = rnd(n), rnd(N_REPLICAS, n)
    return {
        "B1 vc_asgd_lerp_flat": lambda: VK.vc_asgd_lerp_flat(s, c, ALPHA),
        "torch.lerp": lambda: torch.lerp(c, s, a32),
        "B3 adam_update_flat": lambda: VK.adam_update_flat(
            p, gr, m, v, HYPER["lr"], HYPER["b1"], HYPER["b2"],
            HYPER["eps"], 0.0, c1, c2),
        "torch._fused_adam_": lambda: torch._fused_adam_(
            [lp], [gr], [lm], [lv], [], step, lr=HYPER["lr"],
            beta1=HYPER["b1"], beta2=HYPER["b2"], weight_decay=0.0,
            eps=HYPER["eps"], amsgrad=False, maximize=False),
        "B2 assimilate_flat": lambda: VK.assimilate_flat(s, cl, w),
        "torch.addmv": lambda: torch.addmv(s, clt, w32, beta=w0),
        "B12 pack_body": lambda: SK.pack_body(q, sc, idx),
        "torch.cat": lambda: torch.cat([qb, sb, ib]),
        "B10 dequantize_int8": lambda: QK.dequantize_int8(q, sc, k),
        "torch.mul": lambda: torch.mul(q_rows, sc_col),
        "B11 quantize_pack": lambda: SK.quantize_pack(sel, sidx),
        "B9 quantize_int8": lambda: QK.quantize_int8(x9),
        "B6 blocked_topk_stats": lambda: TK.blocked_topk_stats(bus, lo),
        "B6 blocked_topk_stats int lo":
            lambda: TK.blocked_topk_stats(bus, lo_int),
        "B7 threshold_sparsify_exact": lambda: TK.threshold_sparsify_exact(
            bus, tau, tie_start, budget),
        "B7 threshold_sparsify_exact numbers":
            lambda: TK.threshold_sparsify_exact(bus, tau_f, tie_start,
                                                budget_i),
        "B5 easgd_elastic_flat": lambda: VK.easgd_elastic_flat(ec, ex, BETA),
    }


def exact_inputs(torch, TK, bus, lo) -> tuple:
    """B7's ``(tau, tie_start, budget)`` on ``bus`` at TOPK_DENSITY, as
    the selection hands them: the refinement of B6's words
    (``compression.refine``), device tensors."""
    from repro_torch.core import compression as C
    words, counts = TK.blocked_topk_stats(bus, lo)
    _, tau, tie_start, budget = C.refine(
        bus, words, int(counts.sum()), int(bus.numel() * TOPK_DENSITY))
    return tau, tie_start, budget


def topk_bus(torch, g, n: int) -> tuple:
    """A bus of n elements N(0, 0.02^2) and its sampled bracket at density
    TOPK_DENSITY: the device int32 [1] view ``compression.bracket``
    returns, B6's ``lo`` on the selection path."""
    from repro_torch.core import compression as C
    bus = torch.randn(n, generator=g, device="cuda") * 0.02
    return bus, C.bracket(bus, int(n * TOPK_DENSITY))


def pack_payload(torch, g, k: int) -> tuple:
    """A sparse payload of k values as compress_flat makes it: q int8 [k],
    scales f32 [ceil(k / 256)], indices int32 [k]."""
    q = torch.randint(-127, 128, (k,), generator=g, device="cuda",
                      dtype=torch.int8)
    sc = torch.rand(-(-k // QBLOCK), generator=g, device="cuda") * 0.01
    idx = torch.randint(0, 2 ** 31 - 1, (k,), generator=g, device="cuda",
                        dtype=torch.int32)
    return q, sc, idx


def stages(torch, np, VK, SK, QK, TK, LA) -> dict:
    """name -> one stage of a B3, B1, B2, B12, B10, B9, B6, B7 or B5
    wrapper call at the main sizes, alone (the stages this tree's
    wrappers expose; B7's under the same names for a tree with the lean
    launch path and one without)."""
    from repro_torch.core.vc_asgd import assimilation_weights
    if not hasattr(VK, "_operand"):
        return {}
    g = torch.Generator(device="cuda").manual_seed(1)
    p, gr, m, v = (torch.randn(MAIN_N, generator=g, device="cuda")
                   for _ in range(4))
    f32 = (torch.float32,)
    c1 = c2 = np.float32(0.5)
    VK.adam_update_flat(p, gr, m, v, 1e-3, 0.9, 0.999, 1e-8, 0.0, c1, c2)
    fn = VK._entry("adam", torch.float32)
    sc = VK.adam_scalars(1e-3, 0.9, 0.999, 1e-8, 0.0, c1, c2)
    ptrs = [t.data_ptr() for t in (p, gr, m, v)]
    outs = [torch.empty_like(p) for _ in range(3)]
    optrs = [t.data_ptr() for t in outs]
    dev = p.get_device()
    stream = LA._raw_stream(dev)

    def checks():
        n = VK._operand("p", p, VK.STORAGE)[0]
        VK._flat("p", p, n)
        d, shape = p.get_device(), p.shape
        for name, t in (("grad", gr), ("m", m), ("v", v)):
            VK._like(name, t, f32, d, shape)

    def lerp_checks():
        n = VK._operand("server", p, VK.STORAGE)[0]
        VK._flat("server", p, n)
        VK._like("client", gr, (p.dtype,), p.get_device(), p.shape)

    out = {
        "adam checks (4 operands)": checks,
        "adam scalars (AdamScalars)":
            lambda: VK.adam_scalars(1e-3, 0.9, 0.999, 1e-8, 0.0, c1, c2),
        "adam outputs (3 empty_like)":
            lambda: (torch.empty_like(p), torch.empty_like(m),
                     torch.empty_like(v)),
        "stream lookup": lambda: (LA._current_device(), LA._raw_stream(dev)),
        "adam ctypes call + launch":
            lambda: fn(*ptrs, *optrs, sc, MAIN_N, stream),
        "lerp checks (2 operands)": lerp_checks,
        "lerp scalars": lambda: VK.lerp_scalars(ALPHA),
        "lerp output (1 empty_like)": lambda: torch.empty_like(p),
    }
    if hasattr(VK, "_assimilate_checks"):
        cl = torch.randn(N_CLIENTS, MAIN_N, generator=g, device="cuda")
        w = assimilation_weights(N_CLIENTS, ALPHA)
        VK.assimilate_flat(p, cl, w)
        afn = VK._entries["assimilate_fixed", torch.float32]
        wv = VK.assimilate_weights(w)
        cp, op = cl.data_ptr(), outs[0].data_ptr()
        out.update({
            "assimilate checks (server + clients)":
                lambda: VK._assimilate_checks(p, cl),
            "assimilate weights (FixedWeights)":
                lambda: VK.assimilate_weights(w),
            "assimilate ctypes call + launch":
                lambda: afn(ptrs[0], cp, op, wv, N_CLIENTS, MAIN_N, stream)})
    if hasattr(SK, "_pack_checks"):
        pq, psc, pidx = pack_payload(torch, g, PACK_K[MAIN_N])
        body = SK.pack_body(pq, psc, pidx)
        k, ng, qp, sp, ip, _ = SK._pack_checks(pq, psc, pidx)
        bp, pfn = body.data_ptr(), SK._pack_body
        out.update({
            "pack checks (3 operands)":
                lambda: SK._pack_checks(pq, psc, pidx),
            "pack output (torch.empty)": lambda: torch.empty(
                5 * k + 4 * ng, dtype=torch.uint8, device=dev),
            "pack ctypes call + launch":
                lambda: pfn(qp, sp, ip, bp, k, ng, stream)})
    if hasattr(SK, "_quantize_pack_checks"):
        kq = QPACK_K[MAIN_N]
        sel = torch.randn(kq, generator=g, device="cuda")
        sidx = torch.arange(kq, dtype=torch.int32, device="cuda")
        ngq = -(-kq // QBLOCK)
        qb_, qq_, qs_ = SK.quantize_pack(sel, sidx)
        _, sp_, ip_, _ = SK._quantize_pack_checks(sel, sidx, QBLOCK)
        qptrs = (qb_.data_ptr(), qq_.data_ptr(), qs_.data_ptr())
        qfn = SK._quantize_pack
        out.update({
            "quantize_pack checks (2 operands)":
                lambda: SK._quantize_pack_checks(sel, sidx, QBLOCK),
            "quantize_pack outputs (3 torch.empty)": lambda: (
                torch.empty(5 * kq + 4 * ngq, dtype=torch.uint8, device=dev),
                torch.empty(ngq * QBLOCK, dtype=torch.int8, device=dev),
                torch.empty(ngq, dtype=torch.float32, device=dev)),
            "quantize_pack outputs (1 torch.empty carved in 3)":
                lambda: carve(torch, 5 * kq + 4 * ngq, ngq * QBLOCK, ngq,
                              dev),
            "quantize_pack ctypes call + launch":
                lambda: qfn(sp_, ip_, *qptrs, kq, QBLOCK, stream)})
    if hasattr(QK, "_dequantize_checks"):
        dq, dsc, _ = pack_payload(torch, g, PACK_K[MAIN_N])
        dk = dq.numel()
        dout = QK.dequantize_int8(dq, dsc, dk)
        dqp, dsp, _ = QK._dequantize_checks(dq, dsc, dk, QBLOCK)
        dop, dfn = dout.data_ptr(), QK._dequantize
        out.update({
            "dequantize checks (2 operands)":
                lambda: QK._dequantize_checks(dq, dsc, dk, QBLOCK),
            "dequantize output (torch.empty)": lambda: torch.empty(
                dk, dtype=torch.float32, device=dev),
            "dequantize ctypes call + launch":
                lambda: dfn(dqp, dsp, dop, dk, QBLOCK, stream)})
    ec, ex = p, torch.randn(N_REPLICAS, MAIN_N, generator=g, device="cuda")
    eco, exo = VK.easgd_elastic_flat(ec, ex, BETA)
    efn = VK._entries["easgd", torch.float32]
    eptrs = (ec.data_ptr(), ex.data_ptr(), eco.data_ptr(), exo.data_ptr())

    def easgd_checks():
        n, _ = VK._operand("center", ec, VK.STORAGE)
        VK._flat("center", ec, n)
        VK._rows("replicas", ex, ec.dtype, ec.get_device(), n)

    out.update({
        "easgd checks (center + replicas)": easgd_checks,
        "easgd outputs (2 empty_like)":
            lambda: (torch.empty_like(ec), torch.empty_like(ex)),
        "easgd ctypes call + launch":
            lambda: efn(*eptrs, BETA, N_REPLICAS, MAIN_N, stream)})
    out.update(codec_stages(torch, g, QK, TK, LA, dev, stream))
    return out


def codec_stages(torch, g, QK, TK, LA, dev, stream) -> dict:
    """B9's stages at k = 656, B6's and B7's on the bench bus (``lo``,
    ``tau``, ``tie_start`` and the budget the selection's device
    tensors): the checks, the output allocations and the ctypes call with
    its launch, the checks and the C entry taken as the tree's wrapper
    takes them (B7 in a tree without the lean launch path: ``_check_bus``,
    ``_scalar`` and ``check_cuda``, and the entry looked up on the library
    at each call)."""
    k = PACK_K[MAIN_N]
    x = torch.randn(k, generator=g, device="cuda") * 0.01
    q, sc = QK.quantize_int8(x)
    xp, qp, sp, ng = x.data_ptr(), q.data_ptr(), sc.data_ptr(), sc.numel()
    n = TOPK_N[MAIN_N]
    bus, lo = topk_bus(torch, g, n)
    words, counts = TK.blocked_topk_stats(bus, lo)
    bp, lp, wp, cp = (t.data_ptr() for t in (bus, lo, words, counts))
    nb = counts.numel()
    tau, tie_start, budget = exact_inputs(torch, TK, bus, lo)
    kept, res = TK.threshold_sparsify_exact(bus, tau, tie_start, budget)
    tp, btp, tsp, kp, rp = (t.data_ptr() for t in (tau, budget, tie_start,
                                                   kept, res))
    if hasattr(TK, "_exact_checks"):
        echecks = lambda: TK._exact_checks(bus, tau, tie_start, budget)
        ecall = lambda: TK._exact(bp, tp, 0.0, btp, 0, tsp, kp, rp, n,
                                  stream)
    else:
        def echecks():
            TK._check_bus(bus)
            TK._scalar("tau", tau, torch.float32, bus.device)
            TK._scalar("tie_budget", budget, torch.int32, bus.device)
            LA.check_cuda("tie_start", tie_start, (torch.int32,))
            return tie_start.device != bus.device or tie_start.numel() != nb
        elib = TK._library()
        ecall = lambda: elib.tk_exact(bp, tp, btp, tsp, kp, rp, n, stream)
    return {
        "quantize checks": lambda: QK._quantize_checks(x, QBLOCK),
        "quantize outputs (2 torch.empty)": lambda: (
            torch.empty(k, dtype=torch.int8, device=dev),
            torch.empty(ng, dtype=torch.float32, device=dev)),
        "quantize ctypes call + launch":
            lambda: QK._quantize(xp, qp, sp, k, QBLOCK, stream),
        "stats checks (x, lo)": lambda: TK._stats_checks(bus, lo),
        "stats outputs (2 torch.empty)": lambda: (
            torch.empty((nb, 256), dtype=torch.int32, device=dev),
            torch.empty(nb, dtype=torch.int32, device=dev)),
        "stats ctypes call + launch":
            lambda: TK._stats(bp, lp, 0, wp, cp, n, stream),
        "exact checks (x, tau, tie_start, budget)": echecks,
        "exact outputs (2 torch.empty)": lambda: (
            torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev)),
        "exact ctypes call + launch": ecall}


def carve(torch, body: int, q: int, ng: int, dev) -> tuple:
    """B11's three outputs as views of one allocation, each on a 16-byte
    boundary (the alternative to three ``torch.empty``, timed as a
    stage)."""
    qo = -(-body // 16) * 16
    so = qo + -(-q // 16) * 16
    buf = torch.empty(so + 4 * ng, dtype=torch.uint8, device=dev)
    return (buf[:body], buf[qo:qo + q].view(torch.int8),
            buf[so:so + 4 * ng].view(torch.float32))


def b13_host(torch, FK) -> dict:
    out = {}
    for dt in (torch.bfloat16, torch.float32):
        q = torch.randn(1, 4, 128, 128, device="cuda").to(dt)
        k = torch.randn(1, 2, 128, 128, device="cuda").to(dt)
        out[f"{FK.route(q)} {str(dt)[6:]}"] = (
            lambda q=q, k=k: FK.flash_attention(q, k, k))
    return host_us(torch, out)


def client_steps(torch) -> dict:
    """Median host us of one client step and of the Adam.update_flat in
    it (a timing wrapper on the class attribute, removed after)."""
    from repro_torch.core import flat as F
    from repro_torch.core.tasks import MLPTask, make_classification_data
    from repro_torch.optim.optimizers import Adam
    task = MLPTask()
    data = make_classification_data(n_train=1500, n_val=300, seed=0)
    x = torch.from_numpy(data.x_train).cuda()
    y = torch.from_numpy(data.y_train).cuda().long()
    base = F.flatten(task.init_params(0, device="cuda"))
    spent = [0.0]
    update_flat = Adam.update_flat

    def timed(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = update_flat(self, *args, **kwargs)
        spent[0] += time.perf_counter() - t0
        return out

    Adam.update_flat = timed
    try:
        task.client_train(base, x, y, steps=20, seed=0)
        steps, adam = [], []
        for r in range(ROUNDS):
            spent[0] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            task.client_train(base, x, y, steps=TRAIN_STEPS, seed=r)
            torch.cuda.synchronize()
            steps.append(1e6 * (time.perf_counter() - t0) / TRAIN_STEPS)
            adam.append(1e6 * spent[0] / TRAIN_STEPS)
    finally:
        Adam.update_flat = update_flat
    return {"client step": statistics.median(steps),
            "Adam.update_flat": statistics.median(adam)}


def bench_rows() -> list:
    from repro_torch.benchmarks import run as bench
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main(["--only", "flat,flat_adam"])
    return [ln for ln in buf.getvalue().splitlines()
            if ln.startswith(("flat.", "flat_adam."))]


def b14_ms(torch, WK) -> float:
    """CUDA-event ms of one B14 call at [4, 32, 2048, 64] f32."""
    g = torch.Generator(device="cuda").manual_seed(2048 + 64)
    rnd = lambda: torch.randn(4, 32, 2048, 64, generator=g, device="cuda")
    args = (rnd() * 0.4, rnd() * 0.4, rnd(),
            torch.sigmoid(rnd()) * 0.6 + 0.35,
            torch.randn(32, 64, generator=g, device="cuda") * 0.2)
    return event_ms(torch, {"wkv6": lambda: WK.wkv6(*args)}, 10)["wkv6"]


def b15_ms(torch, MK) -> float:
    """CUDA-event ms of one B15 call at jamba's prefill shape."""
    g = torch.Generator(device="cuda").manual_seed(2048 + 8192)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")
    b, T, di, ds = 4, 2048, 8192, 16
    xdbc = rnd(b, T, 256 + 2 * ds) * 0.4
    args = ((rnd(b, T, di) * 0.4).to(torch.bfloat16),
            torch.nn.functional.softplus(rnd(b, T, di)),
            xdbc[..., 256:256 + ds], xdbc[..., 256 + ds:],
            -torch.exp(rnd(di, ds) * 0.3), torch.ones(di, device="cuda"))
    return event_ms(torch, {"scan": lambda: MK.mamba_scan(*args)},
                    10)["scan"]


def capturable(name: str, TK) -> bool:
    """Whether a call of ``calls`` can be captured in a CUDA graph: not
    B7 with ``tau`` and the budget as numbers in a tree whose wrapper
    copies them to the card (a host-to-device copy of pageable
    memory)."""
    return not name.endswith("numbers") or hasattr(TK, "_exact_checks")


def size_of(name: str, n: int) -> str:
    """The size label of a call of ``calls(..., n)``."""
    if "quantize_pack" in name:
        return f"k={QPACK_K[n]}"
    if "topk" in name or "exact" in name:
        return f"N={TOPK_N[n]}"
    if "easgd" in name:
        return f"N={n} n={N_REPLICAS}"
    if ("pack_body" in name or name == "torch.cat" or "quantize" in name
            or name == "torch.mul"):
        return f"k={PACK_K[n]}"
    if "assimilate" in name or name == "torch.addmv":
        return f"N={n} n={N_CLIENTS}"
    return f"N={n}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(Path(__file__).resolve().parents[2]),
                    help="the src directory to import repro_torch from")
    ap.add_argument("--label", default="", help="a name for this tree")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("wrapper_cost needs a CUDA card")
    from repro_torch.kernels import flash_attention as FK
    from repro_torch.kernels import launches as LA
    from repro_torch.kernels import mamba_scan as MK
    from repro_torch.kernels import quantize as QK
    from repro_torch.kernels import rwkv6_scan as WK
    from repro_torch.kernels import sparse_pack as SK
    from repro_torch.kernels import topk_mask as TK
    from repro_torch.kernels import vc_asgd_update as VK

    small = calls(torch, np, VK, SK, QK, TK, MAIN_N)
    parts = stages(torch, np, VK, SK, QK, TK, LA)
    host = host_us(torch, {**small, **parts})
    rec = {"label": args.label, "src": args.src,
           "device": torch.cuda.get_device_name(0),
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True, text=True,
               timeout=60).stdout.strip(),
           "host_us": {k: host[k] for k in small},
           "stages_us": {k: host[k] for k in parts},
           "event_ms": {f"{k} {size_of(k, MAIN_N)}": ms for k, ms in
                        event_ms(torch, small, 50).items()},
           "graph_us": {k: graph_us(torch, fn) for k, fn in small.items()
                        if capturable(k, TK)}}
    del small, parts
    torch.cuda.empty_cache()
    big = calls(torch, np, VK, SK, QK, TK, BIG_N)
    rec["event_ms"].update({f"{k} {size_of(k, BIG_N)}": ms for k, ms in
                            event_ms(torch, big, 10).items()})
    del big
    torch.cuda.empty_cache()
    kb = PACK_K[BIG_N]
    kq = QPACK_K[BIG_N]
    ngq = -(-kq // QBLOCK)
    rec["bound_ms"] = {
        f"B1 N={BIG_N}": 1e3 * 12 * BIG_N / HBM_BYTES_PER_S,
        f"B3 N={BIG_N}": 1e3 * 28 * BIG_N / HBM_BYTES_PER_S,
        f"B2 N={BIG_N} n={N_CLIENTS}":
            1e3 * 4 * (N_CLIENTS + 2) * BIG_N / HBM_BYTES_PER_S,
        f"B12 k={kb}": 1e3 * 2 * (5 * kb + 4 * -(-kb // QBLOCK))
            / HBM_BYTES_PER_S,
        f"B10 k={kb}": 1e3 * (5 * kb + 4 * -(-kb // QBLOCK))
            / HBM_BYTES_PER_S,
        "B14 [4,32,2048,64]": 1e3 * 4 * (5 * 4 * 32 * 2048 * 64
                                         + 4 * 32 * 64 * 64 + 32 * 64)
            / HBM_BYTES_PER_S,
        f"B11 k={kq}": 1e3 * (8 * kq + 5 * kq + 4 * ngq + QBLOCK * ngq
                              + 4 * ngq) / HBM_BYTES_PER_S,
        f"B9 k={kb}": 1e3 * (5 * kb + 4 * -(-kb // QBLOCK))
            / HBM_BYTES_PER_S,
        **{f"B6 N={nt}": 1e3 * (4 * nt + nt / 8 + 4 * -(-nt // 8192))
           / HBM_BYTES_PER_S for nt in TOPK_N.values()},
        **{f"B7 N={nt}": 1e3 * (12 * nt + 4 * -(-nt // 8192))
           / HBM_BYTES_PER_S for nt in TOPK_N.values()},
        **{f"B5 N={nt} n={N_REPLICAS}": 1e3 * 8 * (N_REPLICAS + 1) * nt
           / HBM_BYTES_PER_S for nt in (MAIN_N, BIG_N)},
        "B15 [4,2048,8192] ds 16": 1e3 * 4 * 2048 * 8192 * 16
            / (16 * 132 * 1.98e9)}
    rec["b13_host_us"] = b13_host(torch, FK)
    rec["b14_ms"] = b14_ms(torch, WK)
    torch.cuda.empty_cache()
    rec["b15_ms"] = b15_ms(torch, MK)
    torch.cuda.empty_cache()
    rec["bench"] = bench_rows()
    rec["client_step_us"] = client_steps(torch)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
