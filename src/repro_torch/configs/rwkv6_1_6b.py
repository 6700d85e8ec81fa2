"""rwkv6-1.6b [ssm] "Finch": 24L, d=2048, attention-free, ff=7168,
vocab=65536, data-dependent per-channel decay. [arXiv:2404.05892;
unverified]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b", family="ssm",
        num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=7168, vocab_size=65536, head_dim=64,
        rwkv=True, rwkv_head_dim=64, rwkv_decay_lora=64,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b-smoke", family="ssm",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512, head_dim=16,
        rwkv=True, rwkv_head_dim=16, rwkv_decay_lora=8, vocab_round=64,
    )
