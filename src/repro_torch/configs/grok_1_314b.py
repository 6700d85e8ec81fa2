"""grok-1-314b [moe]: 64L, d=6144, 48H (GQA kv=8), ff=32768, vocab=131072,
MoE 8 experts top-2. [hf:xai-org/grok-1; unverified]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b", family="moe",
        num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=32768, moe_d_ff=32768, vocab_size=131072, head_dim=128,
        num_experts=8, experts_per_tok=2, rope_theta=1e4,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="grok-1-314b-smoke", family="moe",
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, moe_d_ff=128, vocab_size=512, head_dim=16,
        num_experts=4, experts_per_tok=2, vocab_round=64,
    )
