"""Dense-family model assembly: weights, blocks, forward, head, loss.

The port of ``repro/models/transformer.py``'s dense family. The reference
stacks each weight over a leading layer axis and scans it; here every
layer is a :class:`Block` module in a ``ModuleList`` and the loop is a
Python loop, which eager PyTorch runs without compiling. ``RunConfig``
keeps every field of the reference's; the dense family reads
``attn_impl``, ``remat`` and ``loss_chunk``, and a non-default value of a
field only other families read is refused (:meth:`RunConfig.check`).
The loss avoids materialising (B, S, V) logits by taking the vocabulary
projection and the softmax cross-entropy a sequence chunk at a time,
each chunk checkpointed. Other families raise ``NotImplementedError``
(ROADMAP A18).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig, check_family
from ..kernels.ref import NEG_INF
from .attention import Attention, attention
from .common import dense_init, rms_norm, weight
from .mlp import MLP, mlp


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Per-run execution knobs, the reference's fields and defaults."""
    attn_impl: str = "chunked"       # chunked | pallas | naive
    moe_impl: str = "sort"           # sort | einsum
    moe_capacity: float = 1.25       # capacity factor (tokens may drop)
    moe_token_chunk: int = 8192      # dispatch chunk (bounds (T·k,d) buffers)
    remat: bool = False
    loss_chunk: int = 512
    rwkv_impl: str = "chunked"
    ssd_chunk: int = 64
    mesh: object = None              # required by moe_impl='ep_local'

    # Fields the dense family never reads: MoE, RWKV, SSD and the mesh.
    OTHER_FAMILIES = ("moe_impl", "moe_capacity", "moe_token_chunk",
                      "rwkv_impl", "ssd_chunk", "mesh")

    def check(self, family: str) -> None:
        """Raise on a field of an unported family set away from its default
        for ``family`` (only dense runs). :func:`attention` checks
        ``attn_impl``."""
        check_family(family)
        default = RunConfig()
        changed = [f for f in self.OTHER_FAMILIES
                   if getattr(self, f) != getattr(default, f)]
        if changed:
            raise ValueError(f"RunConfig fields {changed} belong to model "
                             f"families not ported yet (ROADMAP A18); the "
                             f"{family} family keeps their defaults")


def _norm(cfg: ModelConfig, dtype, device) -> nn.Parameter:
    return weight(torch.ones(cfg.d_model, dtype=dtype, device=device))


class Block(nn.Module):
    """Weights of one dense block: ln1, attention, ln2, SwiGLU."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device):
        super().__init__()
        self.ln1 = _norm(cfg, dtype, device)
        self.attn = Attention(cfg, generator, dtype, device)
        self.ln2 = _norm(cfg, dtype, device)
        self.mlp = MLP(cfg, generator, dtype, device)


class Transformer(nn.Module):
    """All weights of a dense model, initialised from ``generator``.

    ``embed`` (Vpad, d), ``ln_f`` (d,), ``lm_head`` (d, Vpad) unless the
    embeddings are tied, and ``blocks``, one :class:`Block` per layer.
    """

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator],
                 dtype: torch.dtype, device: torch.device):
        super().__init__()
        check_family(cfg.family)
        self.cfg = cfg
        v, d = cfg.padded_vocab, cfg.d_model
        self.embed = weight(dense_init((v, d), generator, dtype, device,
                                       in_axis_size=d))
        self.ln_f = _norm(cfg, dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = weight(dense_init((d, v), generator, dtype,
                                             device))
        self.blocks = nn.ModuleList(
            Block(cfg, generator, dtype, device)
            for _ in range(cfg.num_layers))

    @property
    def device(self) -> torch.device:
        return self.embed.device


def _dense_block(p: Block, cfg: ModelConfig, rc: RunConfig, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    x = x + attention(p.attn, cfg, rms_norm(x, p.ln1, cfg.norm_eps),
                      positions, impl=rc.attn_impl).out
    return x + mlp(p.mlp, rms_norm(x, p.ln2, cfg.norm_eps))


def _maybe_remat(fn: Callable, rc: RunConfig) -> Callable:
    """``fn`` recomputed in the backward (activation checkpointing) when
    ``rc.remat``, as the reference wraps it in ``jax.checkpoint``."""
    if not rc.remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def forward(params: Transformer, cfg: ModelConfig, rc: RunConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence forward to final hidden states (B, S, D)."""
    x = params.embed[tokens.long()]
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=x.device)
    for p in params.blocks:
        x = _maybe_remat(
            lambda x_, p_=p: _dense_block(p_, cfg, rc, x_, positions), rc)(x)
    return rms_norm(x, params.ln_f, cfg.norm_eps)


def lm_head(params: Transformer, cfg: ModelConfig) -> torch.Tensor:
    """The (d, Vpad) output projection: ``embed.T`` when tied."""
    if cfg.tie_embeddings:
        return params.embed.T
    return params.lm_head


def _ce_chunk(h: torch.Tensor, head: torch.Tensor, lab: torch.Tensor,
              vocab_size: int):
    """(sum of -log p(label), count of labels) over one chunk; labels -1
    are ignored, padded vocabulary columns masked to -1e30."""
    logits = torch.matmul(h.float(), head.float())          # (B, c, Vpad)
    vpad = head.shape[1]
    if vpad > vocab_size:
        col = torch.arange(vpad, device=logits.device)
        logits = torch.where(col < vocab_size, logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, lab.clamp(min=0)[..., None],
                              dim=-1)[..., 0]
    valid = (lab >= 0).float()
    return ((lse - ll) * valid).sum(), valid.sum()


def chunked_cross_entropy(hidden: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor, vocab_size: int,
                          chunk: int = 512) -> torch.Tensor:
    """Mean next-token CE without materialising (B, S, V) logits.

    hidden (B,S,D); head (D,Vpad); labels (B,S) with -1 = ignore. S is
    padded to a whole number of chunks with ignored labels. Each chunk is
    checkpointed, so only one chunk's logits live at a time, in the
    backward too; the sums accumulate chunk by chunk in f32, as the
    reference's scan does.
    """
    b, s, d = hidden.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    loss_sum = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, s + pad, chunk):
        ls, c = checkpoint(_ce_chunk, hidden[:, i:i + chunk], head,
                           labels[:, i:i + chunk], vocab_size,
                           use_reentrant=False)
        loss_sum, cnt = loss_sum + ls, cnt + c
    return loss_sum / torch.clamp(cnt, min=1.0)


def loss_fn(params: Transformer, cfg: ModelConfig, rc: RunConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token loss of ``batch`` (``tokens``, ``labels``: (B, S))."""
    hidden = forward(params, cfg, rc, batch["tokens"])
    return chunked_cross_entropy(hidden, lm_head(params, cfg),
                                 batch["labels"].long(), cfg.vocab_size,
                                 chunk=rc.loss_chunk)


__all__ = ["Block", "Transformer", "RunConfig", "forward", "lm_head",
           "chunked_cross_entropy", "loss_fn"]
