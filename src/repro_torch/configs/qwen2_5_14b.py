"""qwen2.5-14b [dense]: 48L d=5120 40H (GQA kv=8) d_ff=13824 vocab=152064,
QKV bias.  [hf:Qwen/Qwen2.5 family; hf]  RMSNorm, SwiGLU, rope theta 1M.
40 heads do not divide the 16-way model axis -> context-parallel attention
(DESIGN.md §6); hillclimbed against padded-head TP in EXPERIMENTS.md §Perf.
"""
from repro_torch.models.common import BlockSpec, ModelConfig, uniform_groups


def config() -> ModelConfig:
    return ModelConfig(
        arch="qwen2.5-14b", family="dense",
        d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128, d_ff=13824,
        vocab_size=152064, qkv_bias=True,
        layer_groups=uniform_groups(48, BlockSpec()),
        norm="rmsnorm", mlp_act="swiglu", rope_theta=1_000_000.0,
        max_seq=32768 + 64,
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=80, n_heads=5, n_kv_heads=1, head_dim=16, d_ff=160,
        vocab_size=256,
        layer_groups=uniform_groups(2, BlockSpec()),
        max_seq=512, attn_q_block=32, attn_kv_block=32, scan_chunk=16,
    )
