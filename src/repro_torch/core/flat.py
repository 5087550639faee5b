"""FlatParams — one contiguous parameter bus for the whole assimilation path.

Port of ``repro/core/flat.py`` to torch tensors, with the same layout
contract, so a bus built here is byte-identical to the reference's:

* Leaves are packed back-to-back in ``jax.tree.flatten`` order — for a
  dict that is SORTED-key order, not insertion order — each leaf raveled
  C-contiguously and cast to the buffer dtype (float32 by default).
* ``TreeSpec`` is the offset table; ``offsets[i] + sizes[i] ==
  offsets[i+1]`` (no inter-leaf padding).
* The tail is zero-padded up to a multiple of ``BLOCK`` (8192), the tile
  every flat kernel assumes.  Zero padding is a fixed point of every flat
  op, so the tail stays zero.
* ``unflatten`` returns VIEWS of the buffer (a no-op cast keeps the view),
  so a loss taken through them differentiates w.r.t. the buffer and the
  gradient arrives flat, with an exactly-zero tail.

Trees are nested dicts / lists / tuples of tensors.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, List, Sequence, Tuple

import torch

# tile of the flat kernels (kernels/vc_asgd_update.py checks against it)
BLOCK = 8 * 1024

# tree<->bus conversion counters (the boundary of the flat world)
_conversions = {"flatten": 0, "unflatten": 0}


def conversion_counts() -> dict:
    return dict(_conversions)


def reset_conversion_counts() -> None:
    _conversions["flatten"] = 0
    _conversions["unflatten"] = 0


# ---------------------------------------------------------------------------
# tree structure: jax.tree.flatten order over dicts / lists / tuples
# ---------------------------------------------------------------------------

def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, treedef).  Dicts flatten in sorted-key order, exactly like
    ``jax.tree.flatten``; a treedef is a hashable nested tuple."""
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        leaves, defs = [], []
        for k in keys:
            lv, d = tree_flatten(tree[k])
            leaves += lv
            defs.append(d)
        return leaves, ("dict", keys, tuple(defs))
    if isinstance(tree, (list, tuple)):
        leaves, defs = [], []
        for x in tree:
            lv, d = tree_flatten(x)
            leaves += lv
            defs.append(d)
        return leaves, (type(tree).__name__, None, tuple(defs))
    return [tree], None


def tree_unflatten(treedef, leaves: Sequence) -> Any:
    it = iter(leaves)

    def build(d):
        if d is None:
            return next(it)
        kind, keys, defs = d
        if kind == "dict":
            return {k: build(c) for k, c in zip(keys, defs)}
        out = [build(c) for c in defs]
        return tuple(out) if kind == "tuple" else out

    return build(treedef)


def dtype_name(dtype: torch.dtype) -> str:
    """The reference's dtype name ("float32", "bfloat16", ...)."""
    return str(dtype).removeprefix("torch.")


def torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype name {name!r}")
    return dt


@dataclass(frozen=True)
class TreeSpec:
    """Static description of a flattened tree: the leaf offset table."""

    treedef: Any                          # nested tuple (hashable); None = leaf list
    shapes: Tuple[Tuple[int, ...], ...]   # per-leaf shapes
    dtypes: Tuple[str, ...]               # per-leaf storage dtype names
    offsets: Tuple[int, ...]              # element offset of each leaf
    sizes: Tuple[int, ...]                # element count of each leaf
    n: int                                # logical elements (sum of sizes)
    padded: int                           # physical length (BLOCK multiple)

    def meta(self) -> dict:
        """JSON-serializable layout (no treedef) — equal to the
        reference's ``TreeSpec.meta()`` for the same tree."""
        return {"shapes": [list(s) for s in self.shapes],
                "dtypes": list(self.dtypes),
                "offsets": list(self.offsets),
                "n": self.n, "padded": self.padded}

    @classmethod
    def from_meta(cls, meta: dict, treedef=None) -> "TreeSpec":
        """Rebuild a spec from ``meta()`` (the checkpoint/interchange
        form); ``treedef`` None unflattens to a tuple of leaves."""
        shapes = tuple(tuple(int(d) for d in s) for s in meta["shapes"])
        sizes = tuple(math.prod(s) for s in shapes)
        spec = cls(treedef=treedef if treedef is not None
                   else ("tuple", None, (None,) * len(shapes)),
                   shapes=shapes, dtypes=tuple(meta["dtypes"]),
                   offsets=tuple(int(o) for o in meta["offsets"]),
                   sizes=sizes, n=int(meta["n"]), padded=int(meta["padded"]))
        if spec.n != sum(sizes) or spec.padded % BLOCK:
            raise ValueError(f"inconsistent flat layout meta {meta}")
        return spec


@dataclass(frozen=True)
class FlatParams:
    """One contiguous 1-D parameter buffer plus its TreeSpec."""

    buf: torch.Tensor                     # [spec.padded], compute dtype
    spec: TreeSpec

    def with_buf(self, buf) -> "FlatParams":
        return FlatParams(buf, self.spec)


@dataclass(frozen=True)
class FlatOptState:
    """Adam moments as two extra f32 lanes of the bus (same TreeSpec).
    ``step`` is a host int: reading it never waits for the device."""

    m: torch.Tensor                       # [spec.padded], float32
    v: torch.Tensor                       # [spec.padded], float32
    step: int
    spec: TreeSpec


def init_opt_state(spec: TreeSpec, device) -> FlatOptState:
    """Fresh Adam lanes for a parameter bus with layout ``spec``."""
    z = torch.zeros((spec.padded,), dtype=torch.float32, device=device)
    return FlatOptState(m=z, v=z.clone(), step=0, spec=spec)


def _padded_len(n: int, pad_to: int) -> int:
    return max(pad_to, -(-n // pad_to) * pad_to)


def tree_spec(tree, *, pad_to: int = BLOCK) -> TreeSpec:
    """Layout of ``tree`` on the flat bus (no data movement)."""
    leaves, treedef = tree_flatten(tree)
    if not leaves:
        raise ValueError("cannot flatten an empty tree")
    shapes = tuple(tuple(int(d) for d in l.shape) for l in leaves)
    dtypes = tuple(dtype_name(l.dtype) for l in leaves)
    sizes = tuple(math.prod(s) for s in shapes)
    offsets, off = [], 0
    for s in sizes:
        offsets.append(off)
        off += s
    return TreeSpec(treedef=treedef, shapes=shapes, dtypes=dtypes,
                    offsets=tuple(offsets), sizes=sizes, n=off,
                    padded=_padded_len(off, pad_to))


def _pack(leaves, spec: TreeSpec, dtype) -> torch.Tensor:
    dev = leaves[0].device
    parts = [l.reshape(-1).to(device=dev, dtype=dtype) for l in leaves]
    pad = spec.padded - spec.n
    if pad:
        parts.append(torch.zeros((pad,), dtype=dtype, device=dev))
    return torch.cat(parts)


def flatten(tree, *, dtype=torch.float32, pad_to: int = BLOCK) -> FlatParams:
    """Pack every leaf into one contiguous buffer (tail zero-padded), on
    the leaves' device."""
    _conversions["flatten"] += 1
    spec = tree_spec(tree, pad_to=pad_to)
    leaves, _ = tree_flatten(tree)
    return FlatParams(_pack(leaves, spec, dtype), spec)


def unflatten(fp: FlatParams):
    """Rebuild the tree, each leaf a view of the buffer cast back to its
    recorded dtype (a same-dtype cast is a no-op, so the view survives)."""
    _conversions["unflatten"] += 1
    spec = fp.spec
    leaves = [fp.buf[o:o + s].view(shape).to(torch_dtype(dt))
              for o, s, shape, dt in zip(spec.offsets, spec.sizes,
                                         spec.shapes, spec.dtypes)]
    return tree_unflatten(spec.treedef, leaves)


def flatten_like(tree, spec: TreeSpec, *, dtype=torch.float32
                 ) -> torch.Tensor:
    """Flatten ``tree`` onto an EXISTING layout, checking it matches.
    Returns just the buffer (the caller already holds the spec)."""
    _conversions["flatten"] += 1
    leaves, _ = tree_flatten(tree)
    shapes = tuple(tuple(int(d) for d in l.shape) for l in leaves)
    if shapes != spec.shapes:
        raise ValueError(
            f"tree layout mismatch: {shapes} vs spec {spec.shapes}")
    return _pack(leaves, spec, dtype)


def stack_flats(flats: Sequence[FlatParams]) -> torch.Tensor:
    """[n, padded] client matrix for the fused Eq. 2 reduction."""
    if not flats:
        raise ValueError("need at least one FlatParams")
    spec0 = flats[0].spec
    for f in flats[1:]:
        if f.spec.shapes != spec0.shapes or f.spec.padded != spec0.padded:
            raise ValueError("FlatParams layouts differ")
    return torch.stack([f.buf for f in flats])
