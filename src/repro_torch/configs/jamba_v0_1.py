"""jamba-v0.1-52b [hybrid]: 32L d=4096, Mamba:attention 7:1 interleave
(attention at index 4 of each 8-layer block), MoE 16 experts top-2 on odd
layers, attn 32H (GQA kv=8), d_ff=14336, vocab=65536.  [arXiv:2403.19887; hf]
long_500k runs: Mamba state is O(1) and the 4 attention layers use the
chunk-sharded decode cache.
"""
from repro_torch.models.common import (BlockSpec, LayerGroup, MambaConfig,
                                       MoEConfig, ModelConfig)


def _block(i: int) -> BlockSpec:
    mixer = "attn" if i == 4 else "mamba"
    ffn = "moe" if i % 2 == 1 else "dense"
    return BlockSpec(mixer=mixer, ffn=ffn)


def config() -> ModelConfig:
    return ModelConfig(
        arch="jamba-v0.1-52b", family="hybrid",
        d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336,
        vocab_size=65536,
        layer_groups=(LayerGroup(tuple(_block(i) for i in range(8)), 4),),
        norm="rmsnorm", mlp_act="swiglu", pos_emb="none",   # jamba: no rope
        moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        max_seq=524288 + 64, scan_chunk=256,
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
        vocab_size=256,
        layer_groups=(LayerGroup(tuple(_block(i) for i in range(8)), 1),),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64),
        mamba=MambaConfig(d_state=4, d_conv=4, expand=2),
        max_seq=512, attn_q_block=32, attn_kv_block=32, scan_chunk=16,
    )
