"""stablelm-3b [dense]: 32L d=2560 32H (GQA kv=32 == MHA) d_ff=6912
vocab=50304.  [hf:stabilityai/stablelm-2-1_6b family; unverified]
StableLM-2 family traits: LayerNorm, partial rotary (25%), gated SiLU MLP.
"""
from repro_torch.models.common import BlockSpec, ModelConfig, uniform_groups


def config() -> ModelConfig:
    return ModelConfig(
        arch="stablelm-3b", family="dense",
        d_model=2560, n_heads=32, n_kv_heads=32, d_ff=6912,
        vocab_size=50304,
        layer_groups=uniform_groups(32, BlockSpec()),
        norm="layernorm", mlp_act="swiglu", rope_pct=0.25,
        rope_theta=10000.0, max_seq=32768 + 64,
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=64, n_heads=4, n_kv_heads=4, d_ff=160, vocab_size=256,
        layer_groups=uniform_groups(2, BlockSpec()),
        max_seq=512, attn_q_block=32, attn_kv_block=32, scan_chunk=16,
    )
