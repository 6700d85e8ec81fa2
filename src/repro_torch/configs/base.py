"""Model configuration of every family.

The port of ``repro/configs/base.py``'s :class:`ModelConfig`: the dense,
mixture-of-experts, SSM (rwkv6), hybrid (zamba2), encoder-decoder
(whisper) and VLM (llama-3.2-vision) families, with the reference's
fields, defaults and analytic :meth:`ModelConfig.param_count`, and the
reference's shape grid (``ShapeConfig``, ``SHAPES``, ``supports_shape``),
which ``models/sharding.py`` ``resolve_plan`` reads.

Beside them, a family the reference does not have: ``hybrid_moe``
(granite-4.0-h-small, ``model_type`` ``granitemoehybrid``), configured by
:class:`HybridMoEConfig`, whose layers each pick their mixer by
``layer_types`` (Mamba2 or attention) and each end in a mixture of
experts beside a shared expert. Its fields are :class:`ModelConfig`'s
plus those the reference lacks; a plain :class:`ModelConfig` reads each of
them as the value that adds no operation, so the reference's families
compute what they computed before, and their fields stay the reference's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm", "hybrid_moe")


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def check_family(family: str) -> None:
    """Raise unless ``family`` is one of :data:`FAMILIES`."""
    if family not in FAMILIES:
        raise ValueError(f"unknown model family {family!r}; known: "
                         f"{FAMILIES}")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | hybrid | ssm | encdec | vlm
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
    dtype: str = "bfloat16"

    # MoE
    num_experts: int = 0
    experts_per_tok: int = 0
    moe_d_ff: int = 0                 # per-expert hidden dim (olmoe: 1024)

    # SSM / hybrid (zamba2-style)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    attn_every: int = 0               # shared attn block applied every k layers

    # RWKV6
    rwkv: bool = False
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64

    # Encoder–decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0              # stub frontend output length (frames)

    # VLM (llama-3.2-vision)
    cross_attn_every: int = 0         # every k-th layer is gated cross-attn
    num_image_tokens: int = 0         # stub patch-embedding length

    vocab_round: int = 256            # pad vocab so TP divides it

    # HybridMoEConfig's fields, as every other configuration reads them
    # (class attributes, not fields: the reference has no such fields).
    layer_types = ()
    shared_expert_d_ff = 0
    nope = False
    ssm_conv_xbc = False
    embedding_multiplier = 1.0
    attention_multiplier = 0.0
    residual_multiplier = 1.0
    logits_scaling = 1.0
    experts_held = 0
    experts_first = 0

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_round)

    @property
    def local_experts(self) -> int:
        """The experts whose weights this device holds."""
        return self.experts_held or self.num_experts

    @property
    def attention_free(self) -> bool:
        return self.rwkv

    @property
    def subquadratic(self) -> bool:
        """Can this arch run 500k-token decode? (SSM/hybrid/linear-attn)."""
        return self.rwkv or self.ssm_state > 0

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + head), formula
        for formula the reference's: the final norm ``ln_f`` is left out,
        and so are the leaves each branch below does not count.

        It is not the number of weights the model holds, for every family
        but dense and moe. Pinned as the reference computes it:

        * ssm counts four d×d matrices in the time mix, which holds five
          (``wr``, ``wk``, ``wv``, ``wg``, ``wo``), ``4·d`` for its
          vectors, which hold ``8·d`` (``mix`` 5·d, ``w0``, ``u``,
          ``ln_x``), and nothing for the channel mix's ``mix`` (2·d);
        * hybrid counts ``heads`` once for ``A_log``, ``D`` and
          ``dt_bias`` (3·heads), nothing for the Mamba ``norm`` (d_in),
          and ``2·d`` for the one layer norm ``ln``;
        * encdec counts no ``enc_ln_f`` and no cross-attention ``gate``;
        * vlm counts all L layers as self layers (a cross layer's
          attention, norms and SwiGLU have their shapes), then
          ``L / cross_attn_every`` attention blocks, norms and gates more:
          each cross layer's attention and norms twice.

        hybrid_moe, which the reference lacks, counts every weight the
        model holds but ``ln_f``: the held experts (:attr:`local_experts`)
        and the router over all of them.

        The card's memory figures come from the bytes of the tensors.
        """
        check_family(self.family)
        d, f, v = self.d_model, self.d_ff, self.padded_vocab
        hd = self.head_dim
        n_q = self.num_heads * hd
        n_kv = self.num_kv_heads * hd
        total = v * d                       # embedding
        if not self.tie_embeddings:
            total += v * d                  # lm head

        def attn_params():
            return d * n_q + 2 * d * n_kv + n_q * d + (
                2 * hd if self.qk_norm else 0)

        def dense_mlp(ff):
            return 3 * d * ff               # SwiGLU: wi, wg, wo

        if self.family == "encdec":
            enc = self.encoder_layers * (attn_params() + dense_mlp(f) + 2 * d)
            dec = self.num_layers * (2 * attn_params() + dense_mlp(f) + 3 * d)
            blocks = enc + dec
        elif self.family == "moe":
            ff = self.moe_d_ff or f
            per = attn_params() + d * self.num_experts + (
                self.num_experts * 3 * d * ff) + 2 * d
            blocks = self.num_layers * per
        elif self.family == "ssm":            # rwkv6
            per_tm = d * d * 4 + d * self.rwkv_decay_lora * 2 + 4 * d
            per_cm = 2 * d * f + d * d      # k, v and r projections
            blocks = self.num_layers * (per_tm + per_cm + 2 * d)
        elif self.family == "hybrid":         # zamba2
            d_in = self.ssm_expand * d
            heads = d_in // self.ssm_head_dim
            per_mamba = d * (2 * d_in + 2 * self.ssm_state + heads) + (
                d_in * d) + heads + d_in * 4 + 2 * d
            shared_attn = attn_params() + dense_mlp(f) + 2 * d
            blocks = self.num_layers * per_mamba + shared_attn  # shared
        elif self.family == "hybrid_moe":
            d_in = self.ssm_expand * d
            heads = d_in // self.ssm_head_dim
            conv = d_in + 2 * self.ssm_state if self.ssm_conv_xbc else d_in
            mamba = d * (2 * d_in + 2 * self.ssm_state + heads) + (
                d_in * d) + 3 * heads + d_in + 4 * conv + (
                conv if self.ssm_conv_xbc else 0)
            ff = self.moe_d_ff or f
            per_ffn = d * self.num_experts + self.local_experts * 3 * d * ff \
                + 3 * d * self.shared_expert_d_ff + 2 * d
            blocks = sum((mamba if t == "mamba" else attn_params()) + per_ffn
                         for t in self.layer_types)
        else:                                  # dense / vlm
            blocks = self.num_layers * (attn_params() + dense_mlp(f) + 2 * d)
            if self.cross_attn_every:
                n_cross = self.num_layers // self.cross_attn_every
                blocks += n_cross * (attn_params() + 2 * d + 1)
        return total + blocks


@dataclasses.dataclass(frozen=True)
class HybridMoEConfig(ModelConfig):
    """A ``hybrid_moe`` model (granite-4.0-h-small): each layer's mixer by
    ``layer_types`` ("mamba" or "attention"), then a mixture of experts
    beside a shared SwiGLU of ``shared_expert_d_ff``; attention without
    positions (``nope``); the Mamba2 conv over ``[x | B | C]`` with a bias
    (``ssm_conv_xbc``); the published scalars (the embedding times
    ``embedding_multiplier``, the attention scale ``attention_multiplier``
    in place of ``1/sqrt(head_dim)`` where nonzero, each sublayer's output
    times ``residual_multiplier`` into the residual, the logits divided by
    ``logits_scaling``); and the experts this device holds,
    ``[experts_first, experts_first + experts_held)`` of the
    ``num_experts`` the router spans (0 held: all of them)."""
    layer_types: Tuple[str, ...] = ()
    shared_expert_d_ff: int = 0
    nope: bool = False
    ssm_conv_xbc: bool = False
    embedding_multiplier: float = 1.0
    attention_multiplier: float = 0.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    experts_held: int = 0
    experts_first: int = 0

    def __post_init__(self):
        super().__post_init__()
        if len(self.layer_types) != self.num_layers or \
                set(self.layer_types) - {"mamba", "attention"}:
            raise ValueError(f"{self.name}: layer_types must give "
                             f"{self.num_layers} of 'mamba' and 'attention'")
        held = self.local_experts
        if self.experts_first < 0 or self.experts_first + held > \
                self.num_experts:
            raise ValueError(f"{self.name}: experts [{self.experts_first}, "
                             f"{self.experts_first + held}) are not among "
                             f"{self.num_experts}")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def supports_shape(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic sequence mixing."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch — 512k dense decode is "
                       "quadratic; skipped per assignment")
    return True, ""


__all__ = ["ModelConfig", "HybridMoEConfig", "check_family", "FAMILIES",
           "ShapeConfig", "SHAPES", "supports_shape"]
