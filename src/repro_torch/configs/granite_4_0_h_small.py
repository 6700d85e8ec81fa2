"""granite-4.0-h-small [hybrid_moe]: 40 layers, d=4096: 36 Mamba2 mixers
(128 heads of 64, d_state 128, one group, conv 4 over [x | B | C] with a
bias, chunk 256) and 4 GQA attention layers without positions (32 query
heads, 8 kv heads of 128) at 0-based layers 5, 15, 25 and 35; every layer
followed by 72 SwiGLU experts of 768, top 10, beside a shared SwiGLU of
1,536; vocab=100352, tied; embedding x12, attention scale 1/128, residual
x0.22, logits /16. [hf:ibm-granite/granite-4.0-h-small; config.json]"""
from .base import HybridMoEConfig

ATTENTION_LAYERS = (5, 15, 25, 35)


def config() -> HybridMoEConfig:
    return HybridMoEConfig(
        name="granite-4.0-h-small", family="hybrid_moe",
        num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=768, moe_d_ff=768, vocab_size=100352, head_dim=128,
        tie_embeddings=True, rope_theta=1e4, norm_eps=1e-5,
        num_experts=72, experts_per_tok=10, shared_expert_d_ff=1536,
        ssm_state=128, ssm_head_dim=64, ssm_expand=2,
        layer_types=tuple("attention" if i in ATTENTION_LAYERS else "mamba"
                          for i in range(40)),
        nope=True, ssm_conv_xbc=True, embedding_multiplier=12.0,
        attention_multiplier=0.0078125, residual_multiplier=0.22,
        logits_scaling=16.0,
    )


def smoke() -> HybridMoEConfig:
    return HybridMoEConfig(
        name="granite-4.0-h-small-smoke", family="hybrid_moe",
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=32, moe_d_ff=32, vocab_size=512, head_dim=16,
        tie_embeddings=True, rope_theta=1e4, norm_eps=1e-5,
        num_experts=16, experts_per_tok=4, shared_expert_d_ff=48,
        ssm_state=16, ssm_head_dim=16, ssm_expand=2,
        layer_types=("mamba", "attention", "mamba", "mamba"),
        nope=True, ssm_conv_xbc=True, embedding_multiplier=12.0,
        attention_multiplier=1.0 / 16, residual_multiplier=0.22,
        logits_scaling=16.0, vocab_round=64,
    )
