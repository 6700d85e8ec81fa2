"""smollm-135m [dense]: 30L, d=576, 9H (GQA kv=3), ff=1536, vocab=49152.
Llama-arch small. [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from .base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m", family="dense",
        num_layers=30, d_model=576, num_heads=9, num_kv_heads=3,
        d_ff=1536, vocab_size=49152, head_dim=64, tie_embeddings=True,
        rope_theta=1e4,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="smollm-135m-smoke", family="dense",
        num_layers=2, d_model=48, num_heads=3, num_kv_heads=1,
        d_ff=96, vocab_size=512, head_dim=16, tie_embeddings=True,
        vocab_round=64,
    )
