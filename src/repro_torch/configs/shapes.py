"""The input-shape cells and their input specs (port of
``repro/configs/shapes.py``).

Four cells an architecture (the 40-cell table):
  train_4k     seq 4096,   global batch 256  -> the train step
  prefill_32k  seq 32768,  global batch 32   -> the prefill step
  decode_32k   seq 32768,  global batch 128  -> the decode step (one token)
  long_500k    seq 524288, global batch 1    -> the decode step; only for
               archs whose per-step state is bounded or sub-quadratic
               (``ModelConfig.supports_long_decode``)

``input_specs`` gives every model input of a cell as a meta tensor (the
reference's ``ShapeDtypeStruct``): shapes and dtypes, nothing allocated.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import meta_spec
from repro_torch.models.plan import NULL_PLAN
from repro_torch.models.registry import build_model


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cell_applicable(cfg: ModelConfig, cell: ShapeCell) -> Optional[str]:
    """None if the cell runs for ``cfg``; else why it is skipped."""
    if cell.name == "long_500k" and not cfg.supports_long_decode:
        return ("pure full-attention stack: 500k dense-KV decode has no "
                "sub-quadratic mechanism in the published architecture")
    return None


def tune_for_shape(cfg: ModelConfig, cell: ShapeCell) -> ModelConfig:
    """The cell's chunk sizes: the recurrences' scan chunk (its working
    set scales with the local batch) and, at prefill_32k, 2,048-position
    attention blocks."""
    kw = {}
    if cfg.rwkv is not None:
        kw["scan_chunk"] = {"train_4k": 128,
                            "prefill_32k": 512}.get(cell.name, 128)
    elif cfg.mamba is not None:
        kw["scan_chunk"] = {"train_4k": 256,
                            "prefill_32k": 1024}.get(cell.name, 256)
    if cell.name == "prefill_32k":
        kw["attn_q_block"] = 2048
        kw["attn_kv_block"] = 2048
    return cfg.replace(**kw) if kw else cfg


def input_specs(cfg: ModelConfig, cell: ShapeCell, plan=NULL_PLAN):
    """Meta tensors for every model input of ``cell``: the batch of a
    train or prefill cell (whisper's frame embeddings, the VLM's patch
    embeddings in front of ``seq_len - n_patches`` tokens); for a decode
    cell the caches of a ``seq_len`` prompt under ``plan``
    (``Model.cache_specs``), one token a row and the position (0-dim)."""
    b, s = cell.global_batch, cell.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    if cell.kind in ("train", "prefill"):
        batch = {}
        if cfg.encoder is not None:
            batch["frame_embeds"] = meta_spec(
                (b, cfg.encoder.n_frames, cfg.encoder.d_model), bf16)
            batch["tokens"] = meta_spec((b, s), i32)
        elif cfg.vision is not None:
            batch["patch_embeds"] = meta_spec(
                (b, cfg.vision.n_patches, cfg.vision.vit_dim), bf16)
            batch["tokens"] = meta_spec((b, s - cfg.vision.n_patches), i32)
        else:
            batch["tokens"] = meta_spec((b, s), i32)
        return batch
    return {
        "caches": build_model(cfg).cache_specs(b, s, plan),
        "token": meta_spec((b,), i32),
        "pos": meta_spec((), i32),
    }
