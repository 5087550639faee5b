"""internvl2-2b [vlm]: InternViT frontend (STUB: precomputed patch
embeddings) + InternLM2-1.8b backbone; 24L d=2048 16H (GQA kv=8) d_ff=8192
vocab=92553.  [arXiv:2404.16821; hf]
Vocab 92553 is padded internally to 92560 for 16-way TP.
"""
from repro_torch.models.common import (BlockSpec, ModelConfig,
                                       VisionStubConfig, uniform_groups)


def config() -> ModelConfig:
    return ModelConfig(
        arch="internvl2-2b", family="vlm",
        d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
        vocab_size=92553,
        layer_groups=uniform_groups(24, BlockSpec()),
        norm="rmsnorm", mlp_act="swiglu", rope_theta=1_000_000.0,
        vision=VisionStubConfig(n_patches=256, vit_dim=1024),
        max_seq=32768 + 64,
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=160, vocab_size=251,
        layer_groups=uniform_groups(2, BlockSpec()),
        vision=VisionStubConfig(n_patches=8, vit_dim=32),
        max_seq=512, attn_q_block=32, attn_kv_block=32, scan_chunk=16,
    )
