"""Model configuration dataclasses (port of ``repro/models/common.py``).

Every architecture is a ``ModelConfig``: the embedding / FFN / attention
dimensions plus a layer plan (``layer_groups``) of repeated superblocks.
The reference scans over a group's repeats; the port loops over
``all_blocks``.  ``cdtype`` / ``pdtype`` are torch dtypes.  The encoder
and vision configs come over as plain dataclasses so the config modules
keep their fields; the dense family, rwkv and the hybrid mamba /
attention / MoE stack run in the port so far.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Literal, Optional, Tuple

import torch

AttnKind = Literal["full", "swa"]
MixerKind = Literal["attn", "mamba", "rwkv"]
FFNKind = Literal["dense", "moe", "none"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; one of "
                         f"{sorted(_DTYPES)}") from None


@dataclass(frozen=True)
class BlockSpec:
    """One layer of the network: a sequence mixer followed by an FFN."""

    mixer: MixerKind = "attn"
    attn_kind: AttnKind = "full"      # only for mixer == "attn"
    window: Optional[int] = None       # sliding window size for attn_kind=="swa"
    ffn: FFNKind = "dense"

    def short(self) -> str:
        m = {"attn": "A", "mamba": "M", "rwkv": "R"}[self.mixer]
        if self.mixer == "attn" and self.attn_kind == "swa":
            m = "a"
        f = {"dense": "d", "moe": "e", "none": "-"}[self.ffn]
        return m + f


@dataclass(frozen=True)
class LayerGroup:
    """``repeats`` copies of a superblock (a tuple of BlockSpecs)."""

    blocks: Tuple[BlockSpec, ...]
    repeats: int

    @property
    def n_layers(self) -> int:
        return len(self.blocks) * self.repeats


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # expert-parallel "virtual expert" factor: each expert split into
    # ep_virtual f-parallel slices (exact: the slices' outputs sum)
    ep_virtual: int = 1

    @property
    def n_virtual(self) -> int:
        return self.n_experts * self.ep_virtual

    @property
    def d_ff_virtual(self) -> int:
        if self.d_ff_expert % self.ep_virtual:
            raise ValueError(f"d_ff_expert {self.d_ff_expert} does not split "
                             f"into {self.ep_virtual} virtual experts")
        return self.d_ff_expert // self.ep_virtual


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None  # default: ceil(d_model / 16)


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    lora_dim_w: int = 64
    lora_dim_mix: int = 32


@dataclass(frozen=True)
class EncoderConfig:
    n_layers: int
    n_frames: int
    d_model: int
    n_heads: int
    d_ff: int


@dataclass(frozen=True)
class VisionStubConfig:
    n_patches: int
    vit_dim: int


@dataclass(frozen=True)
class ModelConfig:
    arch: str
    family: str                      # dense | moe | hybrid | ssm | vlm | audio
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    layer_groups: Tuple[LayerGroup, ...]
    head_dim: Optional[int] = None   # default d_model // n_heads
    norm: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    norm_eps: float = 1e-5
    mlp_act: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rope_theta_local: Optional[float] = None
    rope_pct: float = 1.0            # fraction of head_dim that is rotated
    pos_emb: Literal["rope", "learned", "sinusoidal", "none"] = "rope"
    tie_embeddings: bool = False
    logit_softcap: Optional[float] = None
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    encoder: Optional[EncoderConfig] = None
    vision: Optional[VisionStubConfig] = None
    max_seq: int = 131072
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    attn_q_block: int = 1024
    attn_kv_block: int = 1024
    scan_chunk: int = 256

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None \
            else self.d_model // self.n_heads

    @property
    def n_layers(self) -> int:
        return sum(g.n_layers for g in self.layer_groups)

    @property
    def all_blocks(self) -> Tuple[BlockSpec, ...]:
        out = []
        for g in self.layer_groups:
            for _ in range(g.repeats):
                out.extend(g.blocks)
        return tuple(out)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder is not None

    @property
    def is_attention_free(self) -> bool:
        return all(b.mixer != "attn" for b in self.all_blocks)

    @property
    def supports_long_decode(self) -> bool:
        """True when the per-step decode state is bounded or sub-quadratic:
        attention-free, all sliding-window (a rolling cache), or full
        attention in at most a quarter of the layers (jamba, gemma3).  A
        pure full-attention stack returns False (long_500k is skipped)."""
        blocks = self.all_blocks
        attn_blocks = [b for b in blocks if b.mixer == "attn"]
        if not attn_blocks:
            return True
        full = [b for b in attn_blocks if b.attn_kind == "full"]
        if not full:
            return True
        return len(full) <= len(blocks) // 4

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def describe(self) -> str:
        pat = "".join(b.short() for b in self.all_blocks)
        return (f"{self.arch}: {self.n_layers}L d={self.d_model} H={self.n_heads}"
                f"/kv={self.n_kv_heads} hd={self.hd} ff={self.d_ff} "
                f"V={self.vocab_size} pattern={pat}")


def uniform_groups(n_layers: int, block: BlockSpec, superblock: int = 1
                   ) -> Tuple[LayerGroup, ...]:
    """Homogeneous stack: one group of ``n_layers // superblock`` repeats."""
    if n_layers % superblock:
        raise ValueError(f"{n_layers} layers do not split into superblocks "
                         f"of {superblock}")
    return (LayerGroup(blocks=(block,) * superblock,
                       repeats=n_layers // superblock),)


def param_count(cfg: ModelConfig) -> int:
    """Exact parameter count from the shapes of ``Model.param_specs()``
    (meta tensors: nothing is drawn or allocated), summed in Python
    integers.  The reference's ``param_count`` takes each leaf's size as
    an int32 product, which wraps for leaves of 2^31 elements and more
    (jamba-v0.1's expert stacks): it gives 30,707,712 for the full jamba,
    this 51,570,315,264."""
    from repro_torch.core.flat import tree_flatten
    from repro_torch.models.registry import build_model

    leaves, _ = tree_flatten(build_model(cfg).param_specs())
    return sum(math.prod(t.shape) for t in leaves)
