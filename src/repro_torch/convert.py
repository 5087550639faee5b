"""Carry weights across from the JAX package.

Both functions take the reference's parameters as numpy arrays (a tree of
them, or a flat bus buffer with its ``TreeSpec.meta()``), so the two
packages can be fed the same weights and compared.  Nothing here imports
the reference.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import flat as F
from repro_torch.device import resolve_device


def _tensor(a, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_reference(tree_of_numpy, device="cuda") -> F.FlatParams:
    """A reference parameter tree (leaves as numpy arrays) -> FlatParams on
    ``device``, laid out exactly like the reference's ``flatten``."""
    dev = resolve_device(device)
    leaves, treedef = F.tree_flatten(tree_of_numpy)
    return F.flatten(F.tree_unflatten(treedef,
                                       [_tensor(l, dev) for l in leaves]))


def flat_from_reference(buf_np, spec_meta: dict, device="cuda",
                        treedef: Optional[object] = None) -> F.FlatParams:
    """A reference flat buffer plus its ``TreeSpec.meta()`` -> FlatParams
    on ``device``.  ``treedef`` (e.g. a port spec's) restores leaf names
    on unflatten; without it the tree is a tuple of leaves."""
    dev = resolve_device(device)
    spec = F.TreeSpec.from_meta(spec_meta, treedef=treedef)
    buf = _tensor(buf_np, dev).reshape(-1)
    if buf.numel() != spec.padded:
        raise ValueError(f"buffer has {buf.numel()} elements, layout "
                         f"expects {spec.padded}")
    return F.FlatParams(buf, spec)
