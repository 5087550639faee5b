"""granite-moe-1b-a400m [moe]: 24L d=1024 16H (GQA kv=8) per-expert
d_ff=512, 32 experts top-8, vocab=49155.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]  RMSNorm, SwiGLU experts,
tied embeddings.  Vocab padded 49155 -> 49168 for 16-way TP.
"""
from repro_torch.models.common import (BlockSpec, MoEConfig, ModelConfig,
                                       uniform_groups)

_MOE = BlockSpec(ffn="moe")


def config() -> ModelConfig:
    return ModelConfig(
        arch="granite-moe-1b-a400m", family="moe",
        d_model=1024, n_heads=16, n_kv_heads=8, d_ff=512,
        vocab_size=49155, tie_embeddings=True,
        layer_groups=uniform_groups(24, _MOE),
        norm="rmsnorm", mlp_act="swiglu", rope_theta=10000.0,
        moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
        max_seq=32768 + 64,
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=256,
        layer_groups=uniform_groups(2, _MOE),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64),
        max_seq=512, attn_q_block=32, attn_kv_block=32, scan_chunk=16,
    )
