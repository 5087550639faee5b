"""The sharded bus layout of the port (``core/flat.py``:
``ShardedTreeSpec``, ``shard_spec``, ``sharded_tree_spec``,
``flatten_sharded``) against the spec half of the reference's
``tests/test_sharded_flat.py``, and sharded records in the checkpoint
store.

Tolerance: none — offsets, shard tables and meta equal the reference's,
buffers are byte-identical, records restore bit for bit, and a record
written n-way refuses any other partitioning.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from repro.checkpoint import store as RS
from repro.core import flat as RF
from repro_torch.checkpoint import (load_flat_checkpoint,
                                    load_train_checkpoint,
                                    save_flat_checkpoint,
                                    save_train_checkpoint)
from repro_torch.core import flat as F

torch.set_num_threads(2)


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((300, 41)).astype(np.float32),
            "b": (rng.standard_normal(9).astype(np.float32),
                  np.arange(-3, 11, dtype=np.float32)),
            "deep": {"m": rng.standard_normal((2, 3, 4)).astype(np.float32),
                     "v": rng.standard_normal(130).astype(np.float32)}}


def _port(t):
    return {"w": torch.from_numpy(t["w"]),
            "b": tuple(torch.from_numpy(x) for x in t["b"]),
            "deep": {k: torch.from_numpy(v) for k, v in t["deep"].items()}}


def _ref(t):
    return jax.tree.map(jnp.asarray, t)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 7])
def test_sharded_layout_contract_and_reference_bytes(n_shards):
    t = _np_tree()
    fp = F.flatten_sharded(_port(t), n_shards)
    sp = fp.spec
    assert isinstance(sp, F.ShardedTreeSpec)
    assert sp.padded == n_shards * sp.shard_len and sp.shard_len % F.BLOCK == 0
    base = F.tree_spec(_port(t))
    assert (sp.offsets, sp.sizes, sp.n) == (base.offsets, base.sizes, base.n)
    assert not fp.buf[sp.n:].any()
    back = F.unflatten(fp)
    for a, b in zip(F.tree_flatten(_port(t))[0], F.tree_flatten(back)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ref = RF.flatten_sharded(_ref(t), n_shards)
    assert sp.meta() == ref.spec.meta()
    assert fp.buf.numpy().tobytes() == np.asarray(ref.buf).tobytes()
    assert sp.shard_table() == ref.spec.shard_table()


@pytest.mark.parametrize("n_shards", [1, 2, 5])
def test_shard_table_partitions_every_leaf_exactly_once(n_shards):
    sp = F.sharded_tree_spec(_port(_np_tree(1)), n_shards)
    seen = {i: np.zeros(sz, bool) for i, sz in enumerate(sp.sizes)}
    for shard_i, segs in enumerate(sp.shard_table()):
        lo, hi = sp.shard_bounds(shard_i)
        for leaf_idx, leaf_off, length in segs:
            g = sp.offsets[leaf_idx] + leaf_off
            assert lo <= g and g + length <= hi
            assert not seen[leaf_idx][leaf_off:leaf_off + length].any()
            seen[leaf_idx][leaf_off:leaf_off + length] = True
    assert all(cov.all() for cov in seen.values())
    with pytest.raises(IndexError):
        sp.shard_bounds(n_shards)


def test_shard_spec_rejects_bad_counts_and_keeps_offsets():
    sp = F.tree_spec(_port(_np_tree(2)))
    with pytest.raises(ValueError):
        F.shard_spec(sp, 0)
    s3 = F.shard_spec(sp, 3, axis="data")
    assert s3.meta()["shard"] == {"n_shards": 3, "shard_len": s3.shard_len,
                                  "axis": "data"}
    assert s3.meta() == RF.shard_spec(RF.tree_spec(_ref(_np_tree(2))), 3,
                                      axis="data").meta()


@settings(max_examples=20, deadline=None)
@given(data=st.data())
def test_property_sharded_roundtrip(data):
    n_leaves = data.draw(st.integers(min_value=1, max_value=5))
    shapes = [tuple(data.draw(st.integers(min_value=1, max_value=17))
                    for _ in range(data.draw(st.integers(1, 3))))
              for _ in range(n_leaves)]
    n_shards = data.draw(st.integers(min_value=1, max_value=6))
    rng = np.random.default_rng(data.draw(st.integers(0, 2 ** 16)))
    tree = {f"p{i}": torch.from_numpy(
        rng.standard_normal(s).astype(np.float32)) for i, s in
        enumerate(shapes)}
    fp = F.flatten_sharded(tree, n_shards)
    assert fp.spec.padded == n_shards * fp.spec.shard_len
    back = F.unflatten(fp)
    for k in tree:
        assert torch.equal(tree[k], back[k])


def test_sharded_records_roundtrip_and_pin_the_partitioning(tmp_path):
    t = _np_tree(3)
    fp = F.flatten_sharded(_port(t), 4)
    opt = F.FlatOptState(m=fp.buf * 0.5, v=fp.buf * fp.buf, step=7,
                         spec=fp.spec)
    save_train_checkpoint(tmp_path / "train.msgpack", fp, opt, {"round": 3})
    fp2, opt2, extra = load_train_checkpoint(tmp_path / "train.msgpack",
                                             fp.spec, device="cpu")
    assert extra["round"] == 3 and isinstance(fp2.spec, F.ShardedTreeSpec)
    assert fp2.spec.n_shards == 4 and opt2.step == 7
    assert torch.equal(fp2.buf, fp.buf) and torch.equal(opt2.m, opt.m)
    with pytest.raises(ValueError, match="shard-layout"):
        load_train_checkpoint(tmp_path / "train.msgpack",
                              F.shard_spec(F.tree_spec(_port(t)), 2),
                              device="cpu")
    with pytest.raises(ValueError, match="shard-layout"):
        load_train_checkpoint(tmp_path / "train.msgpack",
                              F.tree_spec(_port(t)), device="cpu")
    # a flat record crosses packages both ways, byte for byte
    rfp = RF.flatten_sharded(_ref(t), 4)
    RS.save_flat_checkpoint(tmp_path / "ref.msgpack", rfp, {"k": 1})
    got, extra = load_flat_checkpoint(tmp_path / "ref.msgpack", fp)
    assert extra == {"k": 1} and torch.equal(got.buf, fp.buf)
    save_flat_checkpoint(tmp_path / "port.msgpack", fp, {"k": 1})
    back, _ = RS.load_flat_checkpoint(tmp_path / "port.msgpack", rfp)
    assert np.asarray(back.buf).tobytes() == fp.buf.numpy().tobytes()
    with pytest.raises(ValueError, match="shard-layout"):
        load_flat_checkpoint(tmp_path / "ref.msgpack",
                             F.flatten_sharded(_port(t), 3))
