"""olmoe-1b-7b [moe]: 16L, d=2048, 16H (kv=16), per-expert ff=1024,
vocab=50304, MoE 64 experts top-8. [arXiv:2409.02060; hf]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b", family="moe",
        num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1024, moe_d_ff=1024, vocab_size=50304, head_dim=128,
        num_experts=64, experts_per_tok=8, rope_theta=1e4,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=64, moe_d_ff=64, vocab_size=512, head_dim=16,
        num_experts=8, experts_per_tok=2, vocab_round=64,
    )
