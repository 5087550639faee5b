"""internlm2-1.8b [dense]: 24L d=2048 16H (GQA kv=8) d_ff=8192 vocab=92544.
[arXiv:2403.17297; hf]  Llama-style: RMSNorm, SwiGLU, RoPE theta 1M.
"""
from repro_torch.models.common import BlockSpec, ModelConfig, uniform_groups


def config() -> ModelConfig:
    return ModelConfig(
        arch="internlm2-1.8b", family="dense",
        d_model=2048, n_heads=16, n_kv_heads=8, d_ff=8192,
        vocab_size=92544,
        layer_groups=uniform_groups(24, BlockSpec()),
        norm="rmsnorm", mlp_act="swiglu", rope_theta=1_000_000.0,
        max_seq=32768 + 64,
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=160, vocab_size=256,
        layer_groups=uniform_groups(2, BlockSpec()),
        max_seq=512, attn_q_block=32, attn_kv_block=32, scan_chunk=16,
    )
