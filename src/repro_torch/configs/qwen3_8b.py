"""qwen3-8b [dense]: 36L, d=4096, 32H (GQA kv=8), ff=12288, vocab=151936,
qk_norm. [hf:Qwen/Qwen3-8B; hf]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b", family="dense",
        num_layers=36, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=12288, vocab_size=151936, head_dim=128, qk_norm=True,
        rope_theta=1e6,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-8b-smoke", family="dense",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, head_dim=16, qk_norm=True, vocab_round=64,
    )
