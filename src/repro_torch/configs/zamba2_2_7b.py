"""zamba2-2.7b [hybrid]: 54 Mamba2 layers, d=2560, shared attention block
(32H MHA kv=32, ff=10240) applied every 6 layers, vocab=32000, ssm_state=64.
[arXiv:2411.15242; hf]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32,
        d_ff=10240, vocab_size=32000, head_dim=80,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, attn_every=6,
        rope_theta=1e4,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b-smoke", family="hybrid",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        d_ff=128, vocab_size=512, head_dim=16,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2, attn_every=2,
        vocab_round=64,
    )
