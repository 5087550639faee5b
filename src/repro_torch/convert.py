"""Carry weights, payloads and scheme state across from the JAX package.

Every function but ``lm_params_to_reference`` (the way back, for a
checkpoint either package reads) takes the reference's objects as numpy
arrays or anything ``np.asarray`` reads (a tree of them, a flat bus
buffer with its ``TreeSpec.meta()``, a ``CompressedDelta``, a scheme
state, an LM's parameter tree — attention, mamba, rwkv and MoE leaves
alike, a vision stub's projection, whisper's encoder-decoder — or its
decode states), so the two packages can be started from
the same state and compared.  Nothing here imports the reference: its
objects are read by attribute.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import flat as F
from repro_torch.core.compression import CompressedDelta
from repro_torch.device import resolve_device
from repro_torch.models.layers import DecodeCache
from repro_torch.models.mamba import MambaState
from repro_torch.models.rwkv import RWKVState
from repro_torch.models.whisper import CrossCache, WhisperDecCache


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":        # ml_dtypes' bf16: no numpy view
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)   # exact: bf16 ⊂ f32
    return torch.from_numpy(a).to(device)


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


def compressed_from_reference(p, device="cuda") -> CompressedDelta:
    """A reference ``CompressedDelta`` (or any object with its fields,
    arrays readable by ``np.asarray``) -> the port's, on ``device``."""
    dev = resolve_device(device)
    return CompressedDelta(
        values=_tensor(np.asarray(p.values, np.int8), dev),
        scales=_tensor(np.asarray(p.scales, np.float32), dev),
        indices=_tensor(np.asarray(p.indices, np.int32), dev),
        shape=tuple(int(d) for d in p.shape), density=float(p.density),
        block=int(p.block))


def _carry(value, spec: F.TreeSpec, dev: torch.device):
    if hasattr(value, "buf") and hasattr(value, "spec"):      # FlatParams
        return F.FlatParams(_tensor(np.asarray(value.buf), dev).reshape(-1),
                            spec)
    if isinstance(value, dict):
        return {k: _carry(v, spec, dev) for k, v in value.items()}
    if isinstance(value, (set, frozenset)):
        return set(value)
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    return _tensor(np.asarray(value), dev)                     # an array


def state_from_reference(ref_state, port_state, device="cuda"):
    """Copy a reference scheme state onto ``port_state`` (the port scheme's
    ``init_state`` of the same params): params, version and the scheme's
    own fields — replica matrix and pending rows of the pod, replicas or
    backups dicts of FlatParams, BSP's pending buffers, lost slots and
    slot owners — each converted to ``device`` on the port's bus layout.
    Returns ``port_state``."""
    dev = resolve_device(device)
    spec = port_state.params.spec
    for name in vars(port_state):
        setattr(port_state, name, _carry(getattr(ref_state, name), spec, dev))
    return port_state


def lm_params_from_reference(tree_of_numpy, cfg, device="cuda") -> dict:
    """A reference ``init_lm`` tree (leaves readable by ``np.asarray``, or
    torch tensors, as a checkpoint in that layout loads) ->
    the port's LM parameters on ``device``: ``embed``, ``final_norm`` and
    a vision stub's ``vis_proj`` as they are, and each ``group{gi}`` — a
    list over the group's blocks of dicts stacked ``[repeats, ...]`` for
    ``lax.scan`` — unstacked into one dict per layer, in
    ``cfg.all_blocks`` order.  For an encoder-decoder (``init_whisper``'s
    tree): ``enc`` and ``dec``, stacked ``[layers, ...]``, unstacked into
    one dict a layer; ``embed``, ``pos_table``, ``enc_norm`` and
    ``final_norm`` as they are."""
    dev = resolve_device(device)

    def conv(node, pick=None):
        if isinstance(node, dict):
            return {k: conv(v, pick) for k, v in node.items()}
        if isinstance(node, torch.Tensor):          # a port checkpoint's
            return (node if pick is None else node[pick]).to(dev)
        a = np.asarray(node)
        return _tensor(a if pick is None else a[pick], dev)

    if cfg.is_enc_dec:
        out = {k: conv(tree_of_numpy[k])
               for k in ("embed", "pos_table", "enc_norm", "final_norm")}
        for k, n in (("enc", cfg.encoder.n_layers), ("dec", cfg.n_layers)):
            out[k] = [conv(tree_of_numpy[k], i) for i in range(n)]
        return out
    blocks = []
    for gi, g in enumerate(cfg.layer_groups):
        group = tree_of_numpy[f"group{gi}"]
        for r in range(g.repeats):
            blocks.extend(conv(group[bi], r) for bi in range(len(g.blocks)))
    out = {"embed": conv(tree_of_numpy["embed"]),
           "final_norm": conv(tree_of_numpy["final_norm"]),
           "blocks": blocks}
    if cfg.vision is not None:
        out["vis_proj"] = conv(tree_of_numpy["vis_proj"])
    return out


def lm_params_to_reference(params: dict, cfg, device=None) -> dict:
    """The inverse of ``lm_params_from_reference``: the port's LM
    parameters -> the reference's ``init_lm`` (or ``init_whisper``) tree
    layout, as torch tensors on ``device`` (None: where they are):
    ``embed``, ``final_norm`` and ``vis_proj`` as they are, and per layer
    group ``group{gi}``, a list over the group's blocks of dicts whose
    leaves stack the group's repeats ``[repeats, ...]`` (whisper: ``enc``
    and ``dec`` stacked ``[layers, ...]``).  Flattened in sorted-key
    order it gives the reference's ``jax.tree.leaves`` order, so a
    checkpoint of it is read by either package."""
    def move(t):
        return t if device is None else t.to(device)

    def stack(nodes):
        if isinstance(nodes[0], dict):
            return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
        return torch.stack([move(n) for n in nodes])

    if cfg.is_enc_dec:
        return {k: (stack(v) if k in ("enc", "dec") else F.tree_map(move, v))
                for k, v in params.items()}
    out = {k: F.tree_map(move, params[k])
           for k in ("embed", "final_norm", "vis_proj") if k in params}
    blocks, i = params["blocks"], 0
    for gi, g in enumerate(cfg.layer_groups):
        nb = len(g.blocks)
        reps = [blocks[i + r * nb: i + (r + 1) * nb] for r in range(g.repeats)]
        out[f"group{gi}"] = [stack([rep[bi] for rep in reps])
                             for bi in range(nb)]
        i += g.repeats * nb
    if i != len(blocks):
        raise ValueError(f"{len(blocks)} blocks, the config has {i}")
    return out


_STATES = {"attn": DecodeCache, "mamba": MambaState, "rwkv": RWKVState}


def caches_from_reference(caches, cfg, device="cuda") -> list:
    """The reference's decode states — a tuple over layer groups of tuples
    over the group's blocks of ``DecodeCache``s (attention),
    ``MambaState``s (mamba) or ``RWKVState``s (rwkv) stacked
    ``[repeats, ...]`` — -> the port's list of one such state per layer
    on ``device``.  For an encoder-decoder: the reference's
    ``WhisperDecCache`` (a ``DecodeCache`` and a ``CrossCache`` stacked
    ``[layers, ...]``) -> the port's, one of each a layer."""
    dev = resolve_device(device)
    if cfg.is_enc_dec:
        per_layer = lambda state, stacked: [
            state(*(_tensor(np.asarray(f)[i], dev) for f in stacked))
            for i in range(cfg.n_layers)]
        return WhisperDecCache(per_layer(DecodeCache, caches.self_cache),
                               per_layer(CrossCache, caches.cross))
    out = []
    for gi, g in enumerate(cfg.layer_groups):
        for r in range(g.repeats):
            for bi, spec in enumerate(g.blocks):
                state = _STATES[spec.mixer]
                out.append(state(*(_tensor(np.asarray(f)[r], dev)
                                   for f in caches[gi][bi])))
    return out
