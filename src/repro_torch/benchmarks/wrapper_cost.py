"""Per-call cost of five kernel wrappers of the main path — B1
(``vc_asgd_lerp_flat``, Eq. 1) and B3 (``adam_update_flat``, fused Adam)
of the training loop, B2 (``assimilate_flat``, Eq. 2 over n = 4 clients)
of the batched fold, B12 (``pack_body``) of every sparse frame and B10
(``dequantize_int8``) of every compressed submit and sparse assimilation
— beside the one PyTorch call that computes the same function
(``torch.lerp``, ``torch._fused_adam_``, ``torch.addmv``, ``torch.cat``
of the three byte views, ``torch.mul`` of the zero-padded q by its
scales), of B13's wrapper, and B14's time at rwkv6-1.6b's prefill
shape.

    python src/repro_torch/benchmarks/wrapper_cost.py [--src DIR] [--label L]

Needs one CUDA card.  ``--src`` imports ``repro_torch`` from DIR (default:
this checkout's ``src``), so that two checkouts can be timed in turns on
one card, each in its own process (A, B, B, A).  Prints one JSON line:

* ``host_us``: host microseconds a call, the host clock around
  ``HOST_CALLS`` back-to-back calls at the main sizes (the MLP bus, N =
  16,384 f32; its sparse payload, k = 656), where the kernel is shorter
  than the call; every call of the tree and every stage below timed in
  turns, ``ROUNDS`` rounds, the median kept;
* ``event_ms``: CUDA-event milliseconds a call over 50 calls at the main
  sizes and 10 at N = 2^27 / k = 6,710,886, the calls of one size in
  turns (A B B A, twice, after a warm-up), the mean kept;
* ``graph_us``: device microseconds a call at the main sizes, the calls
  captured 100 at a time in one CUDA graph and replayed (no host work
  between launches: what is left is the kernel and the launch gap);
* ``bound_ms``: bytes moved at 3.35 TB/s at 2^27 / k = 6,710,886 (12 B
  an element for Eq. 1, 28 for Adam, 4 (n + 2) for Eq. 2; twice the
  body's 5k + 4 ng bytes for the pack; 5k + 4 ng for the dequantize),
  and B14's at [4, 32, 2,048, 64] f32 (337.6 MB);
* ``stages_us``: where a wrapper call's host time goes (checks, scalars
  or weights, output allocation, stream lookup, the ctypes call with its
  launch), each stage alone, timed in the same turns as ``host_us`` (only
  the stages a tree's wrappers expose);
* ``b13_host_us``: one B13 wrapper call on each route at [1, 4/2, 128,
  128], as ``chip_smoke.py`` phase 6a times it;
* ``b14_ms``: CUDA-event ms of one B14 call at rwkv6-1.6b's prefill
  shape, [4, 32, 2,048, 64] f32 (chip_smoke.py phase 7a's shape a), 10
  calls a timing after a warm-up, the mean of four timings;
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
import sys
import time
from pathlib import Path

MAIN_N, BIG_N = 16384, 2 ** 27
# B12's payload at each bus size: the MLP's upload at density 0.05, and
# 0.05 of 2^27
PACK_K = {MAIN_N: 656, BIG_N: int(BIG_N * 0.05)}
N_CLIENTS = 4                    # B2: 4b's batch of four results
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


def calls(torch, np, VK, SK, QK, n: int) -> dict:
    """name -> a zero-argument call at bus size ``n`` (f32; B12 and B10
    at ``PACK_K[n]``)."""
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
    }


def pack_payload(torch, g, k: int) -> tuple:
    """A sparse payload of k values as compress_flat makes it: q int8 [k],
    scales f32 [ceil(k / 256)], indices int32 [k]."""
    q = torch.randint(-127, 128, (k,), generator=g, device="cuda",
                      dtype=torch.int8)
    sc = torch.rand(-(-k // QBLOCK), generator=g, device="cuda") * 0.01
    idx = torch.randint(0, 2 ** 31 - 1, (k,), generator=g, device="cuda",
                        dtype=torch.int32)
    return q, sc, idx


def stages(torch, np, VK, SK, QK, LA) -> dict:
    """name -> one stage of a B3, B1, B2, B12 or B10 wrapper call at the
    main sizes, alone (the stages this tree's wrappers expose)."""
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
    return out


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


def size_of(name: str, n: int) -> str:
    """The size label of a call of ``calls(..., n)``."""
    if ("pack_body" in name or name == "torch.cat" or "dequantize" in name
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
    from repro_torch.kernels import quantize as QK
    from repro_torch.kernels import rwkv6_scan as WK
    from repro_torch.kernels import sparse_pack as SK
    from repro_torch.kernels import vc_asgd_update as VK

    small = calls(torch, np, VK, SK, QK, MAIN_N)
    parts = stages(torch, np, VK, SK, QK, LA)
    host = host_us(torch, {**small, **parts})
    rec = {"label": args.label, "src": args.src,
           "device": torch.cuda.get_device_name(0),
           "host_us": {k: host[k] for k in small},
           "stages_us": {k: host[k] for k in parts},
           "event_ms": {f"{k} {size_of(k, MAIN_N)}": ms for k, ms in
                        event_ms(torch, small, 50).items()},
           "graph_us": {k: graph_us(torch, fn) for k, fn in small.items()}}
    del small, parts
    torch.cuda.empty_cache()
    big = calls(torch, np, VK, SK, QK, BIG_N)
    rec["event_ms"].update({f"{k} {size_of(k, BIG_N)}": ms for k, ms in
                            event_ms(torch, big, 10).items()})
    del big
    torch.cuda.empty_cache()
    kb = PACK_K[BIG_N]
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
            / HBM_BYTES_PER_S}
    rec["b13_host_us"] = b13_host(torch, FK)
    rec["b14_ms"] = b14_ms(torch, WK)
    torch.cuda.empty_cache()
    rec["bench"] = bench_rows()
    rec["client_step_us"] = client_steps(torch)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
