"""Model configuration of the dense and mixture-of-experts families.

The port of ``repro/configs/base.py``'s :class:`ModelConfig`, cut to the
fields the dense and MoE families read. The reference's other families
(SSM, hybrid, encoder-decoder, VLM) are not ported yet (ROADMAP A18c);
their fields are absent here and :meth:`ModelConfig.param_count` raises
for them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

PORTED_FAMILIES = ("dense", "moe")
NOT_PORTED_FAMILIES = ("ssm", "hybrid", "encdec", "vlm")


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def check_family(family: str) -> None:
    """Raise unless ``family`` is one the port runs (``dense``, ``moe``)."""
    if family in NOT_PORTED_FAMILIES:
        raise NotImplementedError(
            f"model family {family!r} is not ported yet: ROADMAP A18c "
            "(other families)")
    if family not in PORTED_FAMILIES:
        raise ValueError(f"unknown model family {family!r}")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe
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

    # MoE
    num_experts: int = 0
    experts_per_tok: int = 0
    moe_d_ff: int = 0                 # per-expert hidden dim (olmoe: 1024)

    vocab_round: int = 256            # pad vocab so TP divides it

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_round)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), as the
        reference counts it: the final norm ``ln_f`` is not included. An
        MoE block counts its router ``d·E`` and its experts ``E·3·d·ff``
        in place of the SwiGLU."""
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
        if self.family == "moe":
            ff = self.moe_d_ff or f
            ffn = d * self.num_experts + self.num_experts * 3 * d * ff
        else:
            ffn = 3 * d * f                 # SwiGLU: wi, wg, wo
        return total + self.num_layers * (attn + ffn + 2 * d)


__all__ = ["ModelConfig", "check_family", "PORTED_FAMILIES",
           "NOT_PORTED_FAMILIES"]
