"""Model configuration of the dense language-model family.

The port of ``repro/configs/base.py``'s :class:`ModelConfig`, cut to the
fields the dense family reads. The reference's other families (MoE, SSM,
hybrid, encoder-decoder, VLM) are not ported yet (ROADMAP A18); their
fields are absent here and :meth:`ModelConfig.param_count` raises for them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

NOT_PORTED_FAMILIES = ("moe", "ssm", "hybrid", "encdec", "vlm")


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def check_family(family: str) -> None:
    """Raise unless ``family`` is one the port runs (only ``dense``)."""
    if family in NOT_PORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {family!r} is not ported yet: ROADMAP A18 "
            "(other families)")
    if family != "dense":
        raise ValueError(f"unknown model family {family!r}")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense (the only family ported)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    vocab_round: int = 256            # pad vocab so TP divides it

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_round)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), as the
        reference counts it: the final norm ``ln_f`` is not included."""
        check_family(self.family)
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        hd = self.head_dim
        n_q = self.num_heads * hd
        n_kv = self.num_kv_heads * hd
        total = v * d                       # embedding
        if not self.tie_embeddings:
            total += v * d                  # lm head
        attn = d * n_q + 2 * d * n_kv + n_q * d + (
            2 * hd if self.qk_norm else 0)
        mlp = 3 * d * f                     # SwiGLU: wi, wg, wo
        return total + self.num_layers * (attn + mlp + 2 * d)


__all__ = ["ModelConfig", "check_family", "NOT_PORTED_FAMILIES"]
