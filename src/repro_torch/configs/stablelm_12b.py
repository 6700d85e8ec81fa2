"""stablelm-12b [dense]: 40L, d=5120, 32H (GQA kv=8), ff=13824,
vocab=100352. [hf:stabilityai/stablelm-2-12b; hf]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b", family="dense",
        num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
        d_ff=13824, vocab_size=100352, head_dim=160, rope_theta=1e4,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=16, vocab_round=64,
    )
