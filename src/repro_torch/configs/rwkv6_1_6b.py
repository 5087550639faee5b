"""rwkv6-1.6b "Finch" [ssm]: 24L d=2048 (attention-free) d_ff=7168
vocab=65536; data-dependent decay.  [arXiv:2404.05892; unverified]
32 heads of 64.  long_500k runs trivially: decode state is O(1) per seq.
"""
from repro_torch.models.common import (BlockSpec, ModelConfig, RWKVConfig,
                                       uniform_groups)

_BLK = BlockSpec(mixer="rwkv")


def config() -> ModelConfig:
    return ModelConfig(
        arch="rwkv6-1.6b", family="ssm",
        d_model=2048, n_heads=32, n_kv_heads=32, d_ff=7168,
        vocab_size=65536,
        layer_groups=uniform_groups(24, _BLK),
        norm="layernorm", pos_emb="none",
        rwkv=RWKVConfig(head_dim=64),
        max_seq=524288 + 64, scan_chunk=128,
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=64, d_ff=160, vocab_size=256, n_heads=4, n_kv_heads=4,
        layer_groups=uniform_groups(2, _BLK),
        rwkv=RWKVConfig(head_dim=16, lora_dim_w=8, lora_dim_mix=8),
        max_seq=512, attn_q_block=32, attn_kv_block=32, scan_chunk=16,
    )
