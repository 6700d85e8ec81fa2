"""granite-3-2b [dense]: 40L, d=2048, 32H (GQA kv=8), ff=8192, vocab=49155.
[hf:ibm-granite/granite-3.0-2b-base; hf]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b", family="dense",
        num_layers=40, d_model=2048, num_heads=32, num_kv_heads=8,
        d_ff=8192, vocab_size=49155, head_dim=64, tie_embeddings=True,
        rope_theta=1e4,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="granite-3-2b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=16, tie_embeddings=True,
        vocab_round=64,
    )
