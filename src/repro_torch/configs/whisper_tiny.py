"""whisper-tiny [audio]: enc-dec, 4L each, d=384 6H d_ff=1536 vocab=51865.
Conv frontend is a STUB (precomputed frame embeddings).  [arXiv:2212.04356;
unverified]  LayerNorm, GELU MLP, sinusoidal enc / learned dec positions.
Vocab padded 51865 -> 51872 for 16-way TP.  long_500k: skipped (pure full
attention, and the published decoder context is 448).
"""
from repro_torch.models.common import (BlockSpec, EncoderConfig, ModelConfig,
                                       uniform_groups)


def config() -> ModelConfig:
    return ModelConfig(
        arch="whisper-tiny", family="audio",
        d_model=384, n_heads=6, n_kv_heads=6, d_ff=1536,
        vocab_size=51865,
        layer_groups=uniform_groups(4, BlockSpec()),
        norm="layernorm", mlp_act="gelu", pos_emb="learned",
        encoder=EncoderConfig(n_layers=4, n_frames=1500, d_model=384,
                              n_heads=6, d_ff=1536),
        max_seq=32768 + 64,
    )


def reduced() -> ModelConfig:
    return config().replace(
        d_model=32, n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=128,
        layer_groups=uniform_groups(2, BlockSpec()),
        encoder=EncoderConfig(n_layers=2, n_frames=16, d_model=32,
                              n_heads=2, d_ff=64),
        max_seq=256, attn_q_block=32, attn_kv_block=32, scan_chunk=16,
    )
