"""The port's mamba block (B15's plain version, prefill and decode)
against the JAX package, on the CPU.

* B15's plain version (``kernels/ref.py::mamba_scan``: what
  ``ops.mamba_scan`` runs for CPU tensors, and what the CUDA kernel is
  held against on the card) against the reference's ``ref.mamba_scan`` at
  the reference test's three shapes: 1e-6 (both step the same f32
  recurrence op by op; the sums over the state dim may associate
  differently).  Its final state against the ``ssm`` state that the
  reference's chunked associative scan (``mamba_chunked``) returns, fed
  the reference's own scan inputs: 2e-4.  The reference's Pallas
  ``mamba_scan`` does not run under the installed jax (``pl.load`` is
  gone; ROADMAP queue C), so it is not a party here.
* The port's prefill (``mamba_forward``: one ``ops.mamba_scan`` call over
  the sequence) against ``mamba_chunked`` and the token-loop
  ``mamba_recurrent_ref``, at the reduced jamba config in f32, with
  sequences shorter than, not a multiple of, and a multiple of
  ``scan_chunk``: 2e-4 (the reference's own
  ``test_mamba_chunked_vs_recurrent``); the decode carry (pre-conv tail)
  exactly.  One decode step: 2e-5.

Inputs are drawn with numpy from a seed; the reference's weights are
carried over as numpy arrays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as ref_get_reduced
from repro.kernels import ref as JR
from repro.models import mamba as JM
from repro_torch.configs import get_reduced
from repro_torch.kernels import build, launches, ops
from repro_torch.kernels import mamba_scan as MK
from repro_torch.kernels import ref as R
from repro_torch.models import mamba as M

torch.set_num_threads(2)

ARCH = "jamba-v0.1-52b"


def _np32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _scan_inputs(b, T, di, ds, seed=0):
    """The reference test_mamba_scan's distributions."""
    rng = np.random.default_rng(seed)
    u = (rng.standard_normal((b, T, di)) * 0.4).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, T, di)))).astype(np.float32)
    B = (rng.standard_normal((b, T, ds)) * 0.4).astype(np.float32)
    C = (rng.standard_normal((b, T, ds)) * 0.4).astype(np.float32)
    A = (-np.exp(rng.standard_normal((di, ds)) * 0.3)).astype(np.float32)
    D = np.ones(di, np.float32)
    return u, dt, B, C, A, D


def _cfgs(**kw):
    """The reduced jamba config in both packages, f32 compute."""
    kw = {"compute_dtype": "float32", **kw}
    return ref_get_reduced(ARCH).replace(**kw), get_reduced(ARCH).replace(**kw)


def _mamba_params(rcfg, seed=0):
    p = JM.init_mamba(jax.random.PRNGKey(seed), rcfg)
    return p, {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


# ---------------------------------------------------------------------------
# B15's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("di,ds,T_", [(128, 8, 16), (256, 16, 33),
                                      (128, 4, 5)])
def test_plain_mamba_scan_matches_reference(di, ds, T_):
    args = _scan_inputs(2, T_, di, ds, seed=di + ds + T_)
    y, h = R.mamba_scan(*(torch.from_numpy(a) for a in args))
    want = JR.mamba_scan(*(jnp.asarray(a) for a in args))
    assert y.dtype == torch.float32 and tuple(y.shape) == (2, T_, di)
    assert h.dtype == torch.float32 and tuple(h.shape) == (2, di, ds)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_plain_mamba_scan_stores_in_u_dtype_and_takes_strided_views():
    u, dt, B, C, A, D = _scan_inputs(2, 9, 32, 4, seed=1)
    # B and C as column slices of one [b, T, 8 + 2 ds] buffer (x_proj's)
    xdbc = np.concatenate([np.zeros((2, 9, 8), np.float32), B, C], -1)
    t = torch.from_numpy(xdbc)
    Bv, Cv = t[..., 8:12], t[..., 12:]
    assert not Bv.is_contiguous()
    y, h = R.mamba_scan(torch.from_numpy(u), torch.from_numpy(dt), Bv, Cv,
                        torch.from_numpy(A), torch.from_numpy(D))
    want, h2 = R.mamba_scan(*(torch.from_numpy(a)
                              for a in (u, dt, B, C, A, D)))
    assert torch.equal(y, want) and torch.equal(h, h2)
    y16, h16 = R.mamba_scan(torch.from_numpy(u).to(torch.bfloat16),
                            torch.from_numpy(dt), Bv, Cv,
                            torch.from_numpy(A), torch.from_numpy(D))
    assert y16.dtype == torch.bfloat16 and h16.dtype == torch.float32
    # the one rounding to bf16 is the last operation
    u16 = torch.from_numpy(u).to(torch.bfloat16).float()
    y32, _ = R.mamba_scan(u16, torch.from_numpy(dt), Bv, Cv,
                          torch.from_numpy(A), torch.from_numpy(D))
    assert torch.equal(y16, y32.to(torch.bfloat16))


@pytest.mark.parametrize("s,chunk", [(37, 8), (64, 16), (5, 16)])
def test_plain_mamba_scan_final_state_matches_mamba_chunked(s, chunk):
    """Feed the reference's own scan inputs of one mamba layer to the
    plain version: its final state equals the ssm state of the chunked
    associative scan (and its y the chunked output before the gate)."""
    rcfg, _ = _cfgs(scan_chunk=chunk)
    p, _ = _mamba_params(rcfg, seed=s)
    x = jnp.asarray(np.random.default_rng(s).standard_normal(
        (2, s, rcfg.d_model)).astype(np.float32) * 0.5)
    u, _, _, dt_r, B, C = JM._ssm_inputs(p, x, rcfg)
    dt = jax.nn.softplus(dt_r @ p["dt_proj"] + p["dt_bias"])
    _, st = JM.mamba_chunked(p, x, rcfg)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    _, h = R.mamba_scan(t(u), t(dt), t(B), t(C), -torch.exp(t(p["a_log"])),
                        t(p["d_skip"]))
    np.testing.assert_allclose(h.numpy(), np.asarray(st.ssm), rtol=2e-4,
                               atol=2e-4)


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the CPU route must not build kernels")
    monkeypatch.setattr(build, "build_all", refuse)
    monkeypatch.setattr(build, "load", refuse)


def test_ops_mamba_scan_routes_cpu_tensors_to_the_plain_version(no_build):
    args = [torch.from_numpy(a) for a in _scan_inputs(1, 11, 16, 4)]
    launches.reset_launch_count()
    y, h = ops.mamba_scan(*args)
    want, h2 = R.mamba_scan(*args)
    assert torch.equal(y, want) and torch.equal(h, h2)
    assert launches.launch_count("mamba_scan") == 0


def test_kernel_wrapper_refuses_cpu_tensors(no_build):
    args = [torch.from_numpy(a) for a in _scan_inputs(1, 4, 16, 4)]
    with pytest.raises(ValueError, match="CUDA"):
        MK.mamba_scan(*args)


def _bad_args():
    z = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt)
    ok = dict(u=z(1, 5, 8), dt=z(1, 5, 8), B=z(1, 5, 4), C=z(1, 5, 4),
              A=z(8, 4), D=z(8))
    yield "state dim", {**ok, "B": z(1, 5, 6), "C": z(1, 5, 6), "A": z(8, 6)}
    yield "u dtype", {**ok, "u": z(1, 5, 8, dt=torch.float16)}
    yield "dt dtype", {**ok, "dt": z(1, 5, 8, dt=torch.bfloat16)}
    yield "B dtype", {**ok, "B": z(1, 5, 4, dt=torch.bfloat16)}
    yield "one shape", {**ok, "dt": z(1, 6, 8)}
    yield "B and C must be", {**ok, "C": z(1, 4, 4)}
    yield "3-D", {**ok, "u": z(5, 8)}
    yield "unit stride", {**ok, "u": z(1, 8, 5).transpose(1, 2)}
    yield "non-empty", {**ok, "u": z(1, 0, 8), "dt": z(1, 0, 8),
                        "B": z(1, 0, 4), "C": z(1, 0, 4)}
    yield "A must be", {**ok, "A": z(4, 8)}
    yield "D must be", {**ok, "D": z(9)}
    yield "contiguous float32", {**ok, "A": z(4, 8).t()}


@pytest.mark.parametrize("what,args", list(_bad_args()),
                         ids=[w for w, _ in _bad_args()])
def test_kernel_validation_refuses(what, args):
    with pytest.raises(ValueError, match=what):
        MK.validate(args["u"], args["dt"], args["B"], args["C"], args["A"],
                    args["D"])


def test_kernel_validation_takes_every_state_dim_and_strided_views():
    for ds in MK.STATE_DIMS:
        xdbc = torch.zeros(2, 9, 16 + 2 * ds)
        u = torch.zeros(2, 9, 24, dtype=torch.bfloat16)
        MK.validate(u, torch.zeros(2, 9, 24), xdbc[..., 16:16 + ds],
                    xdbc[..., 16 + ds:], torch.zeros(24, ds), torch.zeros(24))


def test_mamba_scan_is_registered():
    assert "mamba_scan" in launches.KERNELS
    assert launches.SOURCE["mamba_scan"].endswith(
        "kernels/csrc/mamba_scan.cu")
    assert build.SOURCES["mamba_scan"].is_file()
    # the line named is the Pallas kernel function itself
    path, line = launches.REPLACES["mamba_scan"].split(":")
    root = build.CSRC.parents[3]
    text = (root / path).read_text().splitlines()[int(line) - 1]
    assert text.startswith("def _mamba_kernel(")


# ---------------------------------------------------------------------------
# the mamba layer: prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [5, 29, 64])
def test_mamba_forward_matches_chunked_and_recurrent_reference(s):
    """s = 5 < scan_chunk, 29 (not a multiple: the reference's Python loop
    over chunks, the last one short), 64 (its lax.scan over chunks)."""
    rcfg, pcfg = _cfgs(scan_chunk=8)
    p, pt = _mamba_params(rcfg, seed=s)
    x = (np.random.default_rng(s).standard_normal((2, s, pcfg.d_model))
         * 0.5).astype(np.float32)
    out, st = M.mamba_forward(pt, torch.from_numpy(x), pcfg)
    o_c, st_c = JM.mamba_chunked(p, jnp.asarray(x), rcfg)
    o_r = JM.mamba_recurrent_ref(p, jnp.asarray(x), rcfg)
    tol = dict(rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(out.numpy(), np.asarray(o_c), **tol)
    np.testing.assert_allclose(out.numpy(), np.asarray(o_r), **tol)
    np.testing.assert_allclose(st.ssm.numpy(), np.asarray(st_c.ssm), **tol)
    np.testing.assert_array_equal(st.conv.numpy(), np.asarray(st_c.conv))
    assert st.ssm.dtype == torch.float32 and st.conv.is_contiguous()
    # the port's own token-loop oracle agrees with both
    np.testing.assert_allclose(
        M.mamba_recurrent_ref(pt, torch.from_numpy(x), pcfg).numpy(),
        np.asarray(o_r), **tol)


def test_mamba_decode_matches_the_reference():
    rcfg, pcfg = _cfgs()
    p, pt = _mamba_params(rcfg, seed=7)
    di, ds, dc = 128, 4, 4
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, pcfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((3, di, dc - 1)).astype(np.float32)
    ssm = (rng.standard_normal((3, di, ds)) * 0.3).astype(np.float32)
    y, st = M.mamba_decode(pt, torch.from_numpy(x), M.MambaState(
        torch.from_numpy(conv), torch.from_numpy(ssm)), pcfg)
    y_r, st_r = JM.mamba_decode(p, jnp.asarray(x), JM.MambaState(
        jnp.asarray(conv), jnp.asarray(ssm)), rcfg)
    tol = dict(rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **tol)
    np.testing.assert_allclose(st.ssm.numpy(), np.asarray(st_r.ssm), **tol)
    np.testing.assert_allclose(st.conv.numpy(), np.asarray(st_r.conv), **tol)


def test_prefill_state_continues_into_decode():
    """Prefill over s tokens, then decode token s from its state: the
    same output as prefill over s + 1 tokens at its last position."""
    _, pcfg = _cfgs()
    _, pt = _mamba_params(_cfgs()[0], seed=3)
    x = torch.from_numpy((np.random.default_rng(3).standard_normal(
        (2, 21, pcfg.d_model)) * 0.5).astype(np.float32))
    full, _ = M.mamba_forward(pt, x, pcfg)
    _, st = M.mamba_forward(pt, x[:, :20], pcfg)
    y, _ = M.mamba_decode(pt, x[:, 20], st, pcfg)
    np.testing.assert_allclose(y.numpy(), full[:, 20].numpy(), rtol=2e-5,
                               atol=2e-5)


def test_init_mamba_follows_the_reference():
    rcfg, pcfg = _cfgs()
    port = M.init_mamba(torch.Generator().manual_seed(0), pcfg)
    ref = JM.init_mamba(jax.random.PRNGKey(0), rcfg)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in port.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in ref.items()}
    np.testing.assert_array_equal(port["a_log"].numpy(),
                                  np.asarray(ref["a_log"]))
    assert torch.equal(port["d_skip"], torch.ones(128))
    assert torch.count_nonzero(port["conv_b"]) == 0
    # dt = softplus(dt_bias) is log-uniform in [0.001, 0.1]
    dt = torch.nn.functional.softplus(port["dt_bias"])
    assert float(dt.min()) >= 0.001 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    assert abs(float(torch.log(dt).mean()) - np.log(0.01)) < 0.5


@pytest.mark.parametrize("make", ["mamba", "rwkv", "cache"])
def test_decode_state_constructors_place_every_field_on_the_device(make):
    """Every field of an empty decode state lands on the device asked for
    (the meta device here: nothing is allocated)."""
    from repro_torch.models import rwkv as W
    from repro_torch.models.layers import make_decode_cache
    meta = torch.device("meta")
    state = {
        "mamba": lambda: M.mamba_decode_state(2, get_reduced(ARCH), meta),
        "rwkv": lambda: W.rwkv_state_init(2, get_reduced("rwkv6-1.6b"),
                                          meta),
        "cache": lambda: make_decode_cache(2, 2, 1, 8, 16, torch.float32,
                                           prefilled=8, device=meta),
    }[make]()
    assert all(t.device == meta for t in state)
