"""Kernel benchmarks of the port: the counterpart of the reference's
``benchmarks/kernel_bench.py`` suites ``bench_kernels``,
``bench_flat_assimilate``, ``bench_flat_adam`` and ``bench_compression``,
on the same models, buses, shapes and densities.

Every suite runs on one device.  On the card a row is timed with CUDA
events after a warm-up; on the CPU (the plain PyTorch versions) with the
host clock, fewer times.  A row that runs kernels also gives the launches
of one call (``launches`` in the JSON, ``launches=<kernel>:<n>`` in
``derived``), read as the change of the counters in
``kernels/launches.py`` over one call: the counters are never reset here.

The suites with a fused-launch story keep the reference's ``_launches``
dicts (``flat``: flat / per_leaf; ``flat_adam``: flat; ``compression``:
blocked_topk / quantize_pack / pack_body), which ``run.py --check`` holds
to ``results/BASELINE_launches.json`` on the card.  The port counts real
launches, not traced ``pallas_call``s: ``per_leaf`` 96 is 24 leaves x 4
clients, one per-tensor Eq. 1 launch each.  On the CPU every count is 0.

``flat_adam``'s ``train_ckpt_one_pass`` writes the one-pass train record
(``[params | m | v]`` of the bench bus, ``checkpoint/store.py``) to a
temporary directory: host-clock us a record (the copy off the card and
the file write; no kernel) and the file's bytes.  Rows the port adds:
``bench_kernels``' ``dc_lerp_flat_16M`` (B4), ``threshold_sparsify_2M``
(B8) and ``quantize_pack_105k`` (B11), each with its bound at the card's
3.35 TB/s and its error against the plain version.
"""
from __future__ import annotations

import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import save_train_checkpoint
from repro_torch.core import compression as C
from repro_torch.core import flat as F
from repro_torch.core import vc_asgd as V
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as R
from repro_torch.kernels.launches import launch_counts
from repro_torch.optim.optimizers import Adam
from repro_torch.runtime import vc_runtime as VR
from repro_torch.transfer import wire

HBM_BYTES_PER_S = 3.35e12            # H100 SXM HBM3
# the reference's bench model (kernel_bench.py:111): 24 leaves, 2,101,504
# parameters on a 2,105,344-element bus (257 tiles of 8,192)
BENCH_SIZES = [(256, 256), (1024, 64), (64,), (512, 512), (128, 1024),
               (1024,)]
N_LOGICAL, N_PADDED = 2_101_504, 2_105_344
DENSITY = 0.05
K_BENCH = max(1, int(N_LOGICAL * DENSITY))        # 105,075
N_CLIENTS, ALPHA = 4, 0.9
CPU_ITERS = 2                        # host-clock iterations on the CPU
CKPT_ITERS = 3                       # train records timed (after one)

Row = Dict[str, object]


def bound_us(nbytes: float) -> float:
    """The least time the card can move ``nbytes`` in, in us."""
    return 1e6 * nbytes / HBM_BYTES_PER_S


def cuda_ms(fn: Callable, iters: int) -> float:
    """Mean device time of ``fn()`` in ms: CUDA events around ``iters``
    back-to-back calls, after 3 warm-up calls."""
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


class Timer:
    """Mean time of one call of ``fn`` on ``device`` and the kernel
    launches of one call.  The card: ``cuda_ms``; the CPU: the host clock
    around ``CPU_ITERS`` calls after one."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"

    def run(self, fn: Callable, iters: int):
        """(us per call, {kernel: launches of one call})."""
        before = launch_counts()
        fn()
        after = launch_counts()
        launches = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        if not self.cuda:
            t0 = time.perf_counter()
            for _ in range(CPU_ITERS):
                fn()
            return (time.perf_counter() - t0) / CPU_ITERS * 1e6, launches
        return 1e3 * cuda_ms(fn, iters), launches


def row(us: float, derived: str, launches: Optional[dict] = None) -> Row:
    """A CSV row: ``derived`` carries no commas (run.py prints
    ``name,us_per_call,derived``)."""
    out: Row = {"us_per_call": round(us, 1), "derived": derived}
    if launches:
        out["derived"] = derived + " launches=" + "+".join(
            f"{k}:{v}" for k, v in sorted(launches.items()))
        out["launches"] = dict(launches)
    return out


def _normal(rng: np.random.Generator, shape, scale: float = 1.0
            ) -> np.ndarray:
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(a).to(device)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def bench_model(device, seed: int = 0) -> dict:
    """The 24-leaf, 2,101,504-parameter bench model, N(0, 1) f32."""
    rng = np.random.default_rng(seed)
    return {f"layer{rep}/p{i}": _t(_normal(rng, shp), device)
            for rep in range(4) for i, shp in enumerate(BENCH_SIZES)}


def bench_clients(tree: dict, seed: int = 1000) -> list:
    """N_CLIENTS copies of ``tree`` + 0.01 N(0, 1)."""
    out = []
    for c in range(N_CLIENTS):
        rng = np.random.default_rng(seed + c)
        out.append({k: v + _t(_normal(rng, tuple(v.shape), 0.01), v.device)
                    for k, v in tree.items()})
    return out


# ---------------------------------------------------------------------------
# bench_kernels
# ---------------------------------------------------------------------------

def bench_kernels(device) -> Dict[str, Row]:
    """One row a kernel at the reference's shapes (B1's per-tensor entry
    at 2^24, B13 at [1, 8/2, 1024, 64], B14 at [2, 4, 128, 64], B9 at
    2^22, B1 against its plain version at 4,096) and the port's three
    new rows: B4 at 2^24 f32, B8 on the bench bus at tau 0.01, B11 at the
    bench bus's k = 105,075."""
    tm = Timer(device)
    rng = np.random.default_rng(0)
    out: Dict[str, Row] = {}

    n = 1 << 24
    s, c = _t(_normal(rng, n), device), _t(_normal(rng, n), device)
    us, ln = tm.run(lambda: K.fused_lerp(s, c, 0.95), 20)
    out["vc_asgd_lerp_16M"] = row(us, f"{12 * n / (us * 1e-6) / 1e9:.1f}GB/s",
                                  ln)

    q = _t(_normal(rng, (1, 8, 1024, 64), 0.3), device)
    k = _t(_normal(rng, (1, 2, 1024, 64), 0.3), device)
    v = _t(_normal(rng, (1, 2, 1024, 64)), device)
    us, ln = tm.run(lambda: K.flash_attention(q, k, v, causal=True), 20)
    fl = 2 * 2 * 8 * 1024 * 1024 * 64 / 2                # causal half
    out["attention_1k"] = row(us, f"{fl / (us * 1e-6) / 1e9:.1f}GFLOP/s", ln)

    r_ = _t(_normal(rng, (2, 4, 128, 64), 0.3), device)
    w = torch.sigmoid(_t(_normal(rng, (2, 4, 128, 64)), device)) * 0.5 + 0.4
    u = _t(_normal(rng, (4, 64), 0.2), device)
    us, ln = tm.run(lambda: K.wkv6(r_, r_, r_, w, u), 20)
    out["wkv6_T128"] = row(us, "-", ln)

    x = _t(_normal(rng, 1 << 22), device)
    us, ln = tm.run(lambda: K.quantize_int8(x), 20)
    out["quantize_int8_4M"] = row(
        us, f"{x.numel() * 4 / (us * 1e-6) / 1e9:.1f}GB/s", ln)

    sp, cp = _t(_normal(rng, 4096), device), _t(_normal(rng, 4096), device)
    err = max_err(K.fused_lerp(sp, cp, 0.9), R.vc_asgd_lerp(sp, cp, 0.9))
    out["pallas_vs_ref_lerp"] = row(0.0, f"maxerr={err:.1e}")

    # B4: four f32 streams in, one out (20 B an element)
    g, b = _t(_normal(rng, n), device), _t(_normal(rng, n), device)
    us, ln = tm.run(lambda: K.fused_dc_lerp_flat(s, c, g, b, 0.9, 0.05), 20)
    err = max_err(K.fused_dc_lerp_flat(s, c, g, b, 0.9, 0.05),
                  R.vc_asgd_dc_lerp(s, c, g, b, 0.9, 0.05))
    out["dc_lerp_flat_16M"] = row(
        us, f"{20 * n / (us * 1e-6) / 1e9:.1f}GB/s "
            f"bound={bound_us(20 * n):.1f}us maxerr={err:.1e}", ln)
    del s, c, g, b

    # B8: x in, kept and residual out (12 B an element)
    d = _t(_normal(rng, N_PADDED, 0.02), device)
    us, ln = tm.run(lambda: K.threshold_sparsify(d, 0.01), 50)
    (kk, kr), (pk, pr) = K.threshold_sparsify(d, 0.01), \
        R.threshold_sparsify(d, 0.01)
    err = max(max_err(kk, pk), max_err(kr, pr))
    out["threshold_sparsify_2M"] = row(
        us, f"{12 * N_PADDED / (us * 1e-6) / 1e9:.1f}GB/s "
            f"bound={bound_us(12 * N_PADDED):.2f}us maxerr={err:.1e}", ln)

    # B11: sel and idx in; body, padded q and scales out
    kq = K_BENCH
    sel = _t(_normal(rng, kq, 0.02), device)
    idx = torch.arange(kq, dtype=torch.int32, device=device) * 20
    ng = -(-kq // 256)
    nbytes = quantize_pack_bytes(kq)
    us, ln = tm.run(lambda: K.fused_quantize_pack(sel, idx), 50)
    got, want = K.fused_quantize_pack(sel, idx), R.quantize_pack(sel, idx)
    err = max(max_err(a, b_) for a, b_ in zip(got, want))
    out["quantize_pack_105k"] = row(
        us, f"k={kq} ng={ng} bound={bound_us(nbytes):.2f}us "
            f"maxerr={err:.1e}", ln)
    return out


def quantize_pack_bytes(k: int, block: int = 256) -> int:
    """B11's floor: sel and idx read once; body, q and scales written."""
    ng = -(-k // block)
    return 8 * k + (5 * k + 4 * ng) + ng * block + 4 * ng


# ---------------------------------------------------------------------------
# bench_flat_assimilate
# ---------------------------------------------------------------------------

def bench_flat_assimilate(device) -> Dict[str, Row]:
    """Eq. 2 on the bench model: the per-leaf tree fold (one per-tensor
    Eq. 1 launch a leaf and client) against ONE fused pass over the
    stacked [4, N] bus; the compressed round per leaf and island against
    ONE global top-k per island."""
    tm = Timer(device)
    tree = bench_model(device)
    clients = bench_clients(tree)
    fp = F.flatten(tree)
    cbuf = torch.stack([F.flatten_like(c, fp.spec) for c in clients])
    n_leaves = len(F.tree_flatten(tree)[0])

    def per_leaf():
        folded = tree
        for c in clients:
            folded = V.vc_asgd_update(folded, c, ALPHA)
        return folded

    us_tree, ln_tree = tm.run(per_leaf, 20)
    us_flat, ln_flat = tm.run(
        lambda: V.assimilate_many_flat(fp, cbuf, ALPHA), 20)
    islands = {k: torch.stack([c[k] for c in clients]) for k in tree}
    surv = torch.ones(N_CLIENTS, dtype=torch.bool)
    us_cleaf, ln_cleaf = tm.run(
        lambda: VR.compressed_assimilate_per_leaf(
            tree, islands, ALPHA, surv, density=DENSITY, device=device), 3)
    us_cflat, ln_cflat = tm.run(
        lambda: VR.compressed_assimilate(tree, islands, ALPHA, surv,
                                         density=DENSITY, device=device), 3)
    flat, per = sum(ln_flat.values()), sum(ln_tree.values())
    return {
        "model": row(0.0, f"{n_leaves} leaves / {fp.spec.n} params / "
                          f"{N_CLIENTS} clients / padded={fp.spec.padded}"),
        "assimilate_treemap": row(us_tree, f"{n_leaves * N_CLIENTS} lerps",
                                  ln_tree),
        "assimilate_flat": row(
            us_flat, f"speedup={us_tree / max(us_flat, 1e-9):.2f}x", ln_flat),
        "pallas_launches": row(0.0, f"flat={flat} per_leaf={per}"),
        "compressed_per_leaf": row(
            us_cleaf, f"{n_leaves}x{N_CLIENTS} topk calls", ln_cleaf),
        "compressed_flat": row(
            us_cflat, f"speedup={us_cleaf / max(us_cflat, 1e-9):.2f}x",
            ln_cflat),
        "_launches": {"flat": flat, "per_leaf": per},
    }


# ---------------------------------------------------------------------------
# bench_flat_adam
# ---------------------------------------------------------------------------

def ckpt_us(fp, fos) -> tuple:
    """(host-clock us a one-pass train record of ``fp`` / ``fos``, the
    file's bytes): ``CKPT_ITERS`` saves after one, each from a settled
    device, to a temporary directory."""
    cuda = fp.buf.device.type == "cuda"
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "train.msgpack"
        save_train_checkpoint(path, fp, fos)
        total = 0.0
        for _ in range(CKPT_ITERS):
            if cuda:
                torch.cuda.synchronize(fp.buf.device)
            t0 = time.perf_counter()
            save_train_checkpoint(path, fp, fos)
            total += time.perf_counter() - t0
        return 1e6 * total / CKPT_ITERS, path.stat().st_size


def bench_flat_adam(device) -> Dict[str, Row]:
    """One Adam step on the bench model: the tree walk (leaf by leaf)
    against ONE fused pass over the (params | m | v) lanes of the bus;
    and the one-pass train record of those three lanes."""
    tm = Timer(device)
    tree = bench_model(device)
    rng = np.random.default_rng(999)
    grads = {k: _t(_normal(rng, tuple(v.shape), 0.01), device)
             for k, v in tree.items()}
    opt = Adam(lr=1e-3, weight_decay=0.01)
    state_t = opt.init(tree)
    fp = F.flatten(tree)
    fos = opt.init_flat(fp)
    gbuf = F.flatten_like(grads, fp.spec)
    n_leaves = len(F.tree_flatten(tree)[0])
    us_tree, ln_tree = tm.run(lambda: opt.update(grads, state_t, tree), 20)
    us_flat, ln_flat = tm.run(lambda: opt.update_flat(gbuf, fos, fp), 20)
    flat = sum(ln_flat.values())
    us_ckpt, ckpt_bytes = ckpt_us(*opt.update_flat(gbuf, fos, fp))
    return {
        "model": row(0.0, f"{n_leaves} leaves / {fp.spec.n} params / "
                          f"padded={fp.spec.padded}"),
        "adam_treemap": row(us_tree, f"{n_leaves} leaf walks x3 trees",
                            ln_tree),
        "adam_flat": row(
            us_flat, f"speedup={us_tree / max(us_flat, 1e-9):.2f}x", ln_flat),
        "pallas_launches": row(0.0, f"flat={flat} (vs {n_leaves} per-leaf)"),
        "train_ckpt_one_pass": row(us_ckpt, f"{ckpt_bytes} bytes single "
                                            f"record (params|m|v) host "
                                            f"clock"),
        "_launches": {"flat": flat},
    }


# ---------------------------------------------------------------------------
# bench_compression
# ---------------------------------------------------------------------------

def bench_compression(device) -> Dict[str, Row]:
    """The compression path on the bench bus (2,105,344 elements, density
    0.05, k = 105,075): the blocked exact top-k, compress_flat, the wire
    encode and decode, the dense decompress and the whole compressed
    round; and the launches of the blocked pipeline at 2^20 (B6 + B7,
    where the bracket holds: checked), of B11 and of B12."""
    tm = Timer(device)
    rng = np.random.default_rng(0)
    delta = _t(_normal(rng, N_PADDED, 0.02), device)
    residual = _t(_normal(rng, N_PADDED, 0.002), device)
    k = K_BENCH
    us_select, ln_select = tm.run(lambda: C.select_topk(delta, k), 20)
    us_compress, ln_compress = tm.run(
        lambda: C.compress_flat(delta, density=DENSITY, logical_n=N_LOGICAL,
                                residual=residual), 20)
    payload, _ = C.compress_flat(delta, density=DENSITY, logical_n=N_LOGICAL,
                                 residual=residual)
    frame = wire.encode_sparse(payload)
    us_encode, ln_encode = tm.run(lambda: wire.encode_sparse(payload), 10)
    us_decode, _ = tm.run(lambda: wire.decode(frame), 10)
    us_decompress, ln_decompress = tm.run(
        lambda: C.decompress_flat(C.CompressedDelta(
            payload.values, payload.scales, payload.indices, (N_PADDED,),
            DENSITY, 256)), 20)

    # launches of the blocked pipeline, of B11 and of B12
    small = _t(_normal(rng, C.MIN_FAST_N, 0.02), device)
    ks = int(C.MIN_FAST_N * DENSITY)
    lo = C.bracket(small, ks)
    c_lo = int((C.magnitude_bits(small) >= lo).sum())
    if not (ks <= c_lo <= ks + C.MARGIN and int(lo) > 0):
        raise RuntimeError(f"the 2^20 launch probe missed its bracket "
                           f"(c_lo {c_lo}, k {ks}): it must take B6 + B7")
    launches = {}
    for name, fn in (
            ("blocked_topk", lambda: C.blocked_topk_sparsify(small, ks)),
            ("quantize_pack", lambda: K.fused_quantize_pack(
                payload.values.float()[:4096], payload.indices[:4096])),
            ("pack_body", lambda: K.pack_body(
                payload.values[:4096], payload.scales[:16],
                payload.indices[:4096]))):
        before = launch_counts()
        fn()
        after = launch_counts()
        launches[name] = sum(after.values()) - sum(before.values())

    tree = bench_model(device)
    islands = {key: torch.stack([c[key] for c in bench_clients(tree)])
               for key in tree}
    surv = torch.ones(N_CLIENTS, dtype=torch.bool)
    us_total, ln_total = tm.run(
        lambda: VR.compressed_assimilate(tree, islands, ALPHA, surv,
                                         density=DENSITY, device=device), 3)
    return {
        "model": row(0.0, f"n={N_LOGICAL} padded={N_PADDED} k={k} "
                          f"density={DENSITY}"),
        "select_topk": row(us_select, "blocked exact top-k (sampled "
                                      "bracket)", ln_select),
        "compress_flat": row(us_compress, "select+quantize+error-feedback",
                             ln_compress),
        "encode_sparse": row(us_encode, f"{len(frame)} bytes one-transfer "
                                        f"body", ln_encode),
        "decode": row(us_decode, "validate+split frame"),
        "decompress_flat": row(us_decompress, "dequant+scatter to dense",
                               ln_decompress),
        "compressed_vs_pre_pr": row(us_total, f"compressed_assimilate "
                                              f"{N_CLIENTS} islands",
                                    ln_total),
        "pallas_launches": row(0.0, " ".join(f"{key}={v}" for key, v
                                             in launches.items())),
        "_launches": launches,
    }
