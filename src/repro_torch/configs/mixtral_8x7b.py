"""mixtral-8x7b [moe]: 32L d=4096 32H (GQA kv=8) d_ff=14336, 8 experts
top-2, sliding-window attention (4096).  [arXiv:2401.04088; hf]
RMSNorm, SwiGLU experts, rope theta 1M.  long_500k runs with the rolling
SWA cache (bounded window -> sub-quadratic decode state).
"""
from repro_torch.models.common import (BlockSpec, MoEConfig, ModelConfig,
                                       uniform_groups)

_BLK = BlockSpec(attn_kind="swa", window=4096, ffn="moe")


def config() -> ModelConfig:
    return ModelConfig(
        arch="mixtral-8x7b", family="moe",
        d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336,
        vocab_size=32000,
        layer_groups=uniform_groups(32, _BLK),
        norm="rmsnorm", mlp_act="swiglu", rope_theta=1_000_000.0,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=14336),
        max_seq=524288 + 64,
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=256,
        layer_groups=uniform_groups(
            2, BlockSpec(attn_kind="swa", window=32, ffn="moe")),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64),
        max_seq=512, attn_q_block=32, attn_kv_block=32, scan_chunk=16,
    )
