"""Port parity: repro_torch.core.flat against repro.core.flat.

Same leaves (numpy, seeded) -> the same ``spec.meta()`` and the same
buffer bytes; the port's round-trip and zero tail hold on their own,
including the flat gradient that autograd returns through unflatten.
Tolerance: none — layouts and bytes are compared exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat as RF
from repro_torch.core import flat as PF

torch.set_num_threads(2)


def _leaves(seed):
    """An unsorted-insertion-order dict (sorted order differs) with a
    nested dict and a tuple, as numpy f32 arrays."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"w2": f(7, 5), "b1": f(3), "a": {"z": f(2, 2), "k": f(9)},
            "w1": (f(4, 3), f(6))}


def _to(tree, conv):
    if isinstance(tree, dict):
        return {k: _to(v, conv) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_to(v, conv) for v in tree)
    return conv(tree)


def test_meta_and_bytes_match_reference_for_unsorted_dict():
    leaves = _leaves(0)
    ref = RF.flatten(_to(leaves, jnp.asarray))
    port = PF.flatten(_to(leaves, torch.from_numpy))
    assert list(leaves) != sorted(leaves)          # insertion order differs
    assert port.spec.meta() == ref.spec.meta()
    assert port.buf.numpy().tobytes() == np.asarray(ref.buf).tobytes()


def test_bf16_leaf_meta_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 3)).astype(np.float32)
    ref = RF.flatten({"h": jnp.asarray(x).astype(jnp.bfloat16),
                      "f": jnp.asarray(x[0])})
    port = PF.flatten({"h": torch.from_numpy(x).to(torch.bfloat16),
                       "f": torch.from_numpy(x[0])})
    assert port.spec.meta() == ref.spec.meta()
    assert port.buf.numpy().tobytes() == np.asarray(ref.buf).tobytes()


def test_roundtrip_and_zero_tail():
    tree = _to(_leaves(2), torch.from_numpy)
    fp = PF.flatten(tree)
    assert fp.spec.padded % PF.BLOCK == 0
    assert torch.count_nonzero(fp.buf[fp.spec.n:]) == 0
    back = PF.unflatten(fp)
    flat_a, _ = PF.tree_flatten(tree)
    flat_b, _ = PF.tree_flatten(back)
    for a, b in zip(flat_a, flat_b):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(PF.flatten_like(back, fp.spec), fp.buf)


def test_unflatten_returns_views_and_flat_gradient_has_zero_tail():
    fp = PF.flatten(_to(_leaves(3), torch.from_numpy))
    buf = fp.buf.clone().requires_grad_(True)
    tree = PF.unflatten(fp.with_buf(buf))
    for leaf in PF.tree_flatten(tree)[0]:           # views, not copies
        assert (leaf.untyped_storage().data_ptr()
                == buf.untyped_storage().data_ptr())
    loss = sum((l ** 2).sum() for l in PF.tree_flatten(tree)[0])
    (g,) = torch.autograd.grad(loss, buf)
    assert torch.equal(g[:fp.spec.n], 2 * buf.detach()[:fp.spec.n])
    assert torch.count_nonzero(g[fp.spec.n:]) == 0


def test_flatten_like_rejects_other_layout_and_stack_checks_specs():
    fp = PF.flatten({"a": torch.zeros(3)})
    with pytest.raises(ValueError):
        PF.flatten_like({"a": torch.zeros(4)}, fp.spec)
    other = PF.flatten({"a": torch.zeros(5)})
    assert PF.stack_flats([fp, fp]).shape == (2, fp.spec.padded)
    with pytest.raises(ValueError):
        PF.stack_flats([fp, other])


def test_spec_from_meta_roundtrip():
    fp = PF.flatten(_to(_leaves(4), torch.from_numpy))
    spec = PF.TreeSpec.from_meta(fp.spec.meta(), treedef=fp.spec.treedef)
    assert spec == fp.spec


def test_tree_views_and_helpers_match_reference():
    """``TreeSpec.num_leaves``, ``FlatParams.tree``, ``FlatOptState.
    leaf_m`` / ``leaf_v`` and ``zeros_like_flat`` against the
    reference's on the same leaves: equal structure, equal bytes; the
    port's trees are views of the lanes."""
    leaves = _leaves(3)
    ref = RF.flatten(_to(leaves, jnp.asarray))
    port = PF.flatten(_to(leaves, torch.from_numpy))
    assert port.spec.num_leaves == ref.spec.num_leaves == 6
    sharded = PF.flatten_sharded(_to(leaves, torch.from_numpy), 3)
    assert sharded.spec.num_leaves == 6

    def same(got, want):
        if isinstance(want, dict):
            assert sorted(got) == sorted(want)
            for k in want:
                same(got[k], want[k])
        elif isinstance(want, (tuple, list)):
            assert len(got) == len(want)
            for g, w in zip(got, want):
                same(g, w)
        else:
            assert got.dtype == torch.float32
            assert got.numpy().tobytes() == np.asarray(want).tobytes()

    same(port.tree(), ref.tree())
    rng = np.random.default_rng(4)
    m, v = (rng.standard_normal(ref.spec.padded).astype(np.float32)
            for _ in range(2))
    rstate = RF.FlatOptState(m=jnp.asarray(m), v=jnp.asarray(v),
                             step=jnp.zeros((), jnp.int32), spec=ref.spec)
    pstate = PF.FlatOptState(m=torch.from_numpy(m), v=torch.from_numpy(v),
                             step=0, spec=port.spec)
    same(pstate.leaf_m(), rstate.leaf_m())
    same(pstate.leaf_v(), rstate.leaf_v())
    pstate.leaf_m()["b1"][0] = 7.0                   # a view of the lane
    assert pstate.m[port.spec.offsets[2]] == 7.0     # a.k, a.z, then b1
    z = PF.zeros_like_flat(port.spec)
    want = np.asarray(RF.zeros_like_flat(ref.spec))
    assert z.dtype == torch.float32 and z.numpy().tobytes() == want.tobytes()
    assert PF.zeros_like_flat(port.spec, dtype=torch.bfloat16).dtype == \
        torch.bfloat16
