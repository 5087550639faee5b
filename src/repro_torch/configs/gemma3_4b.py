"""gemma3-4b [dense]: 34L d=2560 8H (GQA kv=4) d_ff=10240 vocab=262144,
5:1 local:global attention, 128k context.  [hf:google/gemma-3-1b-pt family;
unverified]  Gemma-3 traits: head_dim 256, QK-norm, GeGLU, RMSNorm, tied
embeddings, rope theta 1M global / 10k local, 1024-token sliding window.
"""
from repro_torch.models.common import BlockSpec, LayerGroup, ModelConfig

_LOCAL = BlockSpec(attn_kind="swa", window=1024)
_GLOBAL = BlockSpec(attn_kind="full")


def config() -> ModelConfig:
    return ModelConfig(
        arch="gemma3-4b", family="dense",
        d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
        d_ff=10240, vocab_size=262144,
        # 34 layers: [L L L L L G] x 5 + [L L L L]
        layer_groups=(LayerGroup((_LOCAL,) * 5 + (_GLOBAL,), 5),
                      LayerGroup((_LOCAL,), 4)),
        norm="rmsnorm", mlp_act="geglu", qk_norm=True, tie_embeddings=True,
        rope_theta=1_000_000.0, rope_theta_local=10_000.0,
        max_seq=524288 + 64,
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=160,
        vocab_size=256,
        layer_groups=(LayerGroup((BlockSpec(attn_kind="swa", window=32),) * 2
                                 + (_GLOBAL,), 1),),
        max_seq=512, attn_q_block=32, attn_kv_block=32, scan_chunk=16,
    )
