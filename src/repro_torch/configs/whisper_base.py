"""whisper-base [audio]: 6L enc + 6L dec, d=512, 8H (kv=8), ff=2048,
vocab=51865. Enc-dec; conv audio frontend is a STUB (input_specs provides
precomputed frame embeddings). [arXiv:2212.04356; unverified]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", family="encdec",
        num_layers=6, encoder_layers=6, encoder_seq=1500,
        d_model=512, num_heads=8, num_kv_heads=8, d_ff=2048,
        vocab_size=51865, rope_theta=1e4,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-base-smoke", family="encdec",
        num_layers=2, encoder_layers=2, encoder_seq=32,
        d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
        vocab_size=512, rope_theta=1e4, vocab_round=64,
    )
