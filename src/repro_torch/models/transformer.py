"""Model assembly for every family: weights, blocks, forward, head, loss.

The port of ``repro/models/transformer.py``. The reference stacks each
weight over a leading layer axis (two for grouped stacks) and scans it;
here every layer is a module in a ``ModuleList`` and the loop is a Python
loop, which eager PyTorch runs without compiling. The families:

  dense / moe — one :class:`Block` a layer (attention, then a SwiGLU or,
                where the config has experts, a mixture of experts)
  vlm         — ``self_groups``: L/k groups of k−1 :class:`Block` s, and
                ``cross_layers``: one gated :class:`CrossLayer` a group,
                attending the stub image embeddings
  hybrid      — ``mamba_groups``: L/k groups of k :class:`MambaLayer` s,
                each group followed by the one ``shared_attn``
                :class:`Block` (its weights applied L/k times)
  hybrid_moe  — one :class:`HybridBlock` a layer: a Mamba2 mixer or
                attention by ``layer_types``, then a mixture of experts
                beside a shared SwiGLU; each sublayer's output enters the
                residual times ``residual_multiplier``
  ssm         — one :class:`RWKVBlock` a layer (time mix, channel mix)
  encdec      — ``encoder`` (non-causal :class:`Block` s over the stub
                frame embeddings) and ``enc_ln_f``, then decoder
                ``blocks``: causal self-attention, cross-attention to the
                encoder output, SwiGLU (:class:`DecoderBlock`)

``RunConfig`` keeps every field of the reference's; a non-default value of
a field the family does not read is refused (:meth:`RunConfig.check`).

A model of any family built on a mesh (``model.build_model(plan=,
mesh=)``) holds each weight's block (``models/parallel.py`` ``Layout`` in
``Transformer.layout``): the embedding is vocab-parallel (the rank's
vocabulary range looked up, exact zeros elsewhere, one all-reduce), the
head column-parallel (logits all-gathered over the vocabulary's and the
batch's axes, so every rank holds the same logits), the attention (self
and cross) and feed-forward tensor-parallel, the RWKV and Mamba2 mixers
head-parallel (``models/rwkv.py``, ``models/ssm.py``), and each weight's
d_model rows are gathered over data just before use (ZeRO-3). Every rank
is given the whole batch, stub embeddings included, and runs its rows.
``constrain`` keeps the reference's call sites: every block ends in it.
The loss is vocabulary-parallel (:func:`loss_fn`), and every collective
on the way carries its gradient (``models/parallel.py``), so
``train.train_step.make_train_step`` trains it.
The loss avoids materialising (B, S, V) logits by taking the vocabulary
projection and the softmax cross-entropy a sequence chunk at a time, each
chunk checkpointed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import spans
from ..configs.base import ModelConfig, check_family
from ..kernels.ref import NEG_INF
from . import rwkv as rwkv_mod
from . import ssm as ssm_mod
from .attention import Attention, attention
from .common import constrain, dense_init, param_axes, rms_norm, weight
from .mlp import MLP, MoE, mlp, moe
from .parallel import copy_to, reduce_from


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Per-run execution knobs, the reference's fields and defaults."""
    attn_impl: str = "chunked"       # chunked | pallas | naive
    moe_impl: str = "sort"           # sort | einsum | ep_local
    moe_capacity: float = 1.25       # capacity factor (tokens may drop)
    moe_token_chunk: int = 8192      # dispatch chunk (bounds (T·k,d) buffers)
    remat: bool = False
    loss_chunk: int = 512
    rwkv_impl: str = "chunked"
    ssd_chunk: int = 64
    mesh: object = None              # required by moe_impl='ep_local'

    # Fields only some families read, by family; every family reads
    # attn_impl, remat, loss_chunk and mesh (each runs on one).
    FAMILY_FIELDS = {"moe": ("moe_impl", "moe_capacity", "moe_token_chunk"),
                     "ssm": ("rwkv_impl",), "hybrid": ("ssd_chunk",),
                     "hybrid_moe": ("moe_impl", "moe_capacity",
                                    "moe_token_chunk", "ssd_chunk")}
    OTHER_FAMILIES = ("moe_impl", "moe_capacity", "moe_token_chunk",
                      "rwkv_impl", "ssd_chunk")

    def check(self, family: str) -> None:
        """Raise on a field that ``family`` does not read set away from its
        default: the MoE fields outside the moe family, ``rwkv_impl``
        outside ssm, ``ssd_chunk`` outside hybrid. Every family takes a
        ``mesh``. :func:`attention` checks ``attn_impl`` and :func:`moe`
        ``moe_impl``."""
        check_family(family)
        default = RunConfig()
        read = self.FAMILY_FIELDS.get(family, ())
        changed = [f for f in self.OTHER_FAMILIES if f not in read
                   and getattr(self, f) != getattr(default, f)]
        if changed:
            raise ValueError(f"RunConfig fields {changed} are not read by the "
                             f"{family} family, which keeps their defaults "
                             f"(the MoE fields are the moe family's, "
                             f"rwkv_impl the ssm's, ssd_chunk the hybrid's)")


def _norm(cfg: ModelConfig, dtype, device) -> nn.Parameter:
    return weight(torch.ones(cfg.d_model, dtype=dtype, device=device),
                  (None,))


class Block(nn.Module):
    """Weights of one block: ln1, attention, ln2, and a SwiGLU ``mlp`` or,
    where the config has experts, a mixture of experts ``moe`` (the
    reference's rule and leaf names)."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device):
        super().__init__()
        self.ln1 = _norm(cfg, dtype, device)
        self.attn = Attention(cfg, generator, dtype, device)
        self.ln2 = _norm(cfg, dtype, device)
        if cfg.num_experts:
            self.moe = MoE(cfg, generator, dtype, device)
        else:
            self.mlp = MLP(cfg, generator, dtype, device)


class CrossLayer(nn.Module):
    """A VLM cross layer: ln1, gated cross-attention ``xattn``, ln2,
    SwiGLU ``mlp``."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device):
        super().__init__()
        self.ln1 = _norm(cfg, dtype, device)
        self.xattn = Attention(cfg, generator, dtype, device, cross=True)
        self.ln2 = _norm(cfg, dtype, device)
        self.mlp = MLP(cfg, generator, dtype, device)


class DecoderBlock(nn.Module):
    """A whisper decoder block: ln1, self-attention ``attn``, ln_x,
    cross-attention ``xattn``, ln2, SwiGLU ``mlp``."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device):
        super().__init__()
        self.ln1 = _norm(cfg, dtype, device)
        self.attn = Attention(cfg, generator, dtype, device)
        self.ln_x = _norm(cfg, dtype, device)
        self.xattn = Attention(cfg, generator, dtype, device, cross=True)
        self.ln2 = _norm(cfg, dtype, device)
        self.mlp = MLP(cfg, generator, dtype, device)


class MambaLayer(nn.Module):
    """A hybrid layer: its norm ``ln`` and a Mamba2 block ``mamba``."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device):
        super().__init__()
        self.ln = _norm(cfg, dtype, device)
        self.mamba = ssm_mod.Mamba(cfg, generator, dtype, device)


class HybridBlock(nn.Module):
    """A hybrid_moe layer: ``ln1``, its mixer (``mamba``, a Mamba2 block,
    or ``attn``, by the layer's type), ``ln2``, the experts ``moe`` and
    the ``shared`` expert (a SwiGLU of ``shared_expert_d_ff``)."""

    def __init__(self, cfg: ModelConfig, kind: str, generator, dtype,
                 device):
        super().__init__()
        self.ln1 = _norm(cfg, dtype, device)
        if kind == "mamba":
            self.mamba = ssm_mod.Mamba(cfg, generator, dtype, device)
        else:
            self.attn = Attention(cfg, generator, dtype, device)
        self.ln2 = _norm(cfg, dtype, device)
        self.moe = MoE(cfg, generator, dtype, device)
        if cfg.shared_expert_d_ff:
            self.shared = MLP(cfg, generator, dtype, device,
                              d_ff=cfg.shared_expert_d_ff)


class RWKVBlock(nn.Module):
    """An RWKV6 block: ln1, time mix ``tm``, ln2, channel mix ``cm``."""

    def __init__(self, cfg: ModelConfig, generator, dtype, device):
        super().__init__()
        self.ln1 = _norm(cfg, dtype, device)
        self.tm = rwkv_mod.RWKVTimeMix(cfg, generator, dtype, device)
        self.ln2 = _norm(cfg, dtype, device)
        self.cm = rwkv_mod.RWKVChannelMix(cfg, generator, dtype, device)


def _stack(n: int, make: Callable[[], nn.Module]) -> nn.ModuleList:
    return nn.ModuleList(make() for _ in range(n))


class Transformer(nn.Module):
    """All weights of a model of any family, initialised from
    ``generator``.

    ``embed`` (Vpad, d), ``ln_f`` (d,), ``lm_head`` (d, Vpad) unless the
    embeddings are tied, and the family's layers under the reference's
    names (module docstring). A grouped stack is a ``ModuleList`` of
    ``ModuleList`` s, so ``mamba_groups.<g>.<j>`` is the reference's
    ``mamba_groups`` leaf at ``[g, j]``.
    """

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator],
                 dtype: torch.dtype, device: torch.device):
        super().__init__()
        check_family(cfg.family)
        self.cfg = cfg
        v, d = cfg.padded_vocab, cfg.d_model
        self.embed = weight(dense_init((v, d), generator, dtype, device,
                                       in_axis_size=d), ("vocab", "embed"))
        self.ln_f = _norm(cfg, dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = weight(dense_init((d, v), generator, dtype,
                                             device), ("embed", "vocab"))

        def make(cls):
            return lambda: cls(cfg, generator, dtype, device)

        if cfg.family in ("dense", "moe"):
            self.blocks = _stack(cfg.num_layers, make(Block))
        elif cfg.family == "vlm":
            k = cfg.cross_attn_every
            n_groups = cfg.num_layers // k
            self.self_groups = _stack(
                n_groups, lambda: _stack(k - 1, make(Block)))
            self.cross_layers = _stack(n_groups, make(CrossLayer))
        elif cfg.family == "hybrid":
            k = cfg.attn_every
            self.mamba_groups = _stack(
                cfg.num_layers // k, lambda: _stack(k, make(MambaLayer)))
            self.shared_attn = Block(cfg, generator, dtype, device)
        elif cfg.family == "ssm":
            self.blocks = _stack(cfg.num_layers, make(RWKVBlock))
        elif cfg.family == "hybrid_moe":
            self.blocks = nn.ModuleList(
                HybridBlock(cfg, kind, generator, dtype, device)
                for kind in cfg.layer_types)
        else:                                           # encdec
            self.encoder = _stack(cfg.encoder_layers, make(Block))
            self.enc_ln_f = _norm(cfg, dtype, device)
            self.blocks = _stack(cfg.num_layers, make(DecoderBlock))
        # Each weight's logical axes by name, kept past to_empty/to, and
        # the mesh layout of a sharded build (set by build_model).
        self.param_axes = param_axes(self)
        self.layout = None

    @property
    def device(self) -> torch.device:
        return self.embed.device


# The stub inputs the encdec and vlm families read, by batch key.
STUB_INPUTS = {"encdec": "audio_embeds", "vlm": "image_embeds"}


def check_stub_inputs(cfg: ModelConfig, audio_embeds: Optional[torch.Tensor],
                      image_embeds: Optional[torch.Tensor]) -> None:
    """Raise ``ValueError`` naming the batch key an encdec model
    (``audio_embeds``, (B, encoder_seq, d)) or a VLM (``image_embeds``,
    (B, num_image_tokens, d)) needs and was not given."""
    key = STUB_INPUTS.get(cfg.family)
    given = {"audio_embeds": audio_embeds, "image_embeds": image_embeds}
    if key is not None and given[key] is None:
        raise ValueError(f"the {cfg.family} family reads the stub input "
                         f"{key!r}, which was not given")


def ffn(p: Block, cfg: ModelConfig, rc: RunConfig,
        z: torch.Tensor, layout=None) -> torch.Tensor:
    """The block's feed-forward on the normed z (B, S, D): the experts
    with ``rc``'s MoE fields where the config has them, plus the shared
    expert where the block has one (the span ``moe.shared``), else the
    SwiGLU; on ``layout``'s mesh where given."""
    if cfg.num_experts:
        y = moe(p.moe, z, cfg, impl=rc.moe_impl,
                capacity_factor=rc.moe_capacity,
                token_chunk=rc.moe_token_chunk, layout=layout, mesh=rc.mesh)
        if hasattr(p, "shared"):
            with spans.span("moe.shared"):
                y = y + mlp(p.shared, z, layout)
        return y
    return mlp(p.mlp, z, layout)


def residual(cfg: ModelConfig, x: torch.Tensor,
             out: torch.Tensor) -> torch.Tensor:
    """x plus a hybrid_moe sublayer's output times
    ``residual_multiplier``."""
    return x + out * cfg.residual_multiplier


def embed_tokens(params: "Transformer", tokens: torch.Tensor
                 ) -> torch.Tensor:
    """The embedding rows of ``tokens``, times the config's
    ``embedding_multiplier`` where it is not 1. On a mesh the rank holds a
    vocabulary range: it looks up the tokens inside it, puts exact zeros
    elsewhere and all-reduces over the vocabulary's axes, which adds one
    row to zeros and so gives the unsharded rows bit for bit."""
    layout = params.layout
    mult = params.cfg.embedding_multiplier
    if layout is None:
        rows = params.embed[tokens.long()]
        return rows if mult == 1.0 else rows * mult
    emb = layout.whole(params.embed, 1)                  # (V_loc, d)
    vocab = layout.axes("vocab")
    n = emb.shape[0]
    local = tokens.long() - layout.index(vocab) * n
    inside = (local >= 0) & (local < n)
    rows = torch.where(inside[..., None], emb[local.clamp(0, n - 1)],
                       torch.zeros((), dtype=emb.dtype, device=emb.device))
    rows = reduce_from(rows, layout, vocab) if vocab else rows
    return rows if mult == 1.0 else rows * mult


def _dense_block(p: Block, cfg: ModelConfig, rc: RunConfig, x: torch.Tensor,
                 positions: torch.Tensor, causal: bool = True, layout=None
                 ) -> torch.Tensor:
    x = x + attention(p.attn, cfg, rms_norm(x, p.ln1, cfg.norm_eps),
                      positions, causal=causal, impl=rc.attn_impl,
                      layout=layout).out
    x = x + ffn(p, cfg, rc, rms_norm(x, p.ln2, cfg.norm_eps), layout)
    return constrain(x, layout, "batch", None, None)


def _cross_block(p: CrossLayer, cfg: ModelConfig, rc: RunConfig,
                 x: torch.Tensor, kv_src: torch.Tensor, layout=None
                 ) -> torch.Tensor:
    x = x + attention(p.xattn, cfg, rms_norm(x, p.ln1, cfg.norm_eps), None,
                      kv_x=kv_src, causal=False, impl=rc.attn_impl,
                      layout=layout).out
    x = x + mlp(p.mlp, rms_norm(x, p.ln2, cfg.norm_eps), layout)
    return constrain(x, layout, "batch", None, None)


def _hybrid_block(p: HybridBlock, cfg: ModelConfig, rc: RunConfig,
                  x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """A hybrid_moe layer over the whole sequence (no cache)."""
    z = rms_norm(x, p.ln1, cfg.norm_eps)
    if hasattr(p, "mamba"):
        o, _ = ssm_mod.mamba_block(p.mamba, cfg, z, chunk=rc.ssd_chunk,
                                   keep_state=False)
    else:
        o = attention(p.attn, cfg, z, positions, impl=rc.attn_impl).out
    x = residual(cfg, x, o)
    return residual(cfg, x, ffn(p, cfg, rc, rms_norm(x, p.ln2,
                                                      cfg.norm_eps)))


def _rwkv_block(p: RWKVBlock, cfg: ModelConfig, rc: RunConfig,
                x: torch.Tensor, tm_prev, cm_prev, state, layout=None,
                impl: Optional[str] = None, keep_state: bool = True):
    """An RWKV block: x, both carries and the WKV state (None where not
    ``keep_state``). ``impl`` overrides ``rc.rwkv_impl`` (decode passes
    ``scan``)."""
    z = rms_norm(x, p.ln1, cfg.norm_eps)
    o, tm_carry, state = rwkv_mod.rwkv_time_mix(
        p.tm, cfg, z, tm_prev, state, impl=impl or rc.rwkv_impl,
        layout=layout, keep_state=keep_state)
    x = x + o
    z = rms_norm(x, p.ln2, cfg.norm_eps)
    o, cm_carry = rwkv_mod.rwkv_channel_mix(p.cm, cfg, z, cm_prev, layout)
    x = constrain(x + o, layout, "batch", None, None)
    return x, tm_carry, cm_carry, state


def _mamba_layer(p: MambaLayer, cfg: ModelConfig, rc: RunConfig,
                 x: torch.Tensor, layout=None) -> torch.Tensor:
    o, _ = ssm_mod.mamba_block(p.mamba, cfg, rms_norm(x, p.ln, cfg.norm_eps),
                               chunk=rc.ssd_chunk, layout=layout,
                               keep_state=False)
    return constrain(x + o, layout, "batch", None, None)


def _decoder_block(p: DecoderBlock, cfg: ModelConfig, rc: RunConfig,
                   x: torch.Tensor, positions: torch.Tensor,
                   enc: torch.Tensor, layout=None) -> torch.Tensor:
    x = x + attention(p.attn, cfg, rms_norm(x, p.ln1, cfg.norm_eps),
                      positions, causal=True, impl=rc.attn_impl,
                      layout=layout).out
    x = x + attention(p.xattn, cfg, rms_norm(x, p.ln_x, cfg.norm_eps), None,
                      kv_x=enc, causal=False, impl=rc.attn_impl,
                      layout=layout).out
    x = x + mlp(p.mlp, rms_norm(x, p.ln2, cfg.norm_eps), layout)
    return constrain(x, layout, "batch", None, None)


def _maybe_remat(fn: Callable, rc: RunConfig) -> Callable:
    """``fn`` recomputed in the backward (activation checkpointing) when
    ``rc.remat``, as the reference wraps it in ``jax.checkpoint``."""
    if not rc.remat:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def encode(params: Transformer, cfg: ModelConfig, rc: RunConfig,
           audio_embeds: torch.Tensor, impl: Optional[str] = None
           ) -> torch.Tensor:
    """Whisper's encoder over the stub frame embeddings (B, enc_seq, D):
    non-causal self-attention with RoPE, SwiGLU, then ``enc_ln_f``.
    ``impl`` overrides ``rc.attn_impl`` (serving passes ``pallas``). On a
    mesh ``audio_embeds`` holds the rank's rows of the batch (the entry
    points cut them, :func:`rank_rows`)."""
    run = rc if impl is None else dataclasses.replace(rc, attn_impl=impl)
    layout = params.layout
    x = constrain(audio_embeds, layout, "batch", None, None)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    for p in params.encoder:
        x = _maybe_remat(lambda x_, p_=p: _dense_block(
            p_, cfg, run, x_, positions, causal=False, layout=layout), rc)(x)
    return rms_norm(x, params.enc_ln_f, cfg.norm_eps)


def _cross_source(src: torch.Tensor, layout) -> torch.Tensor:
    """The keys' and values' source of every cross layer (whisper's encoder
    output, the VLM's image embeddings), replicated over the heads' axes:
    each rank's heads read part of it, so its gradient, summed over every
    cross layer's uses first (in the unsharded model's order), is
    all-reduced once over those axes (``parallel.copy_to``)."""
    heads = layout.axes("heads") if layout is not None else ()
    return copy_to(src, layout, heads) if heads else src


def rank_rows(layout, tokens: torch.Tensor, *stubs: Optional[torch.Tensor]):
    """The rank's rows of the whole batch ``tokens`` and of each stub
    input (None stays None), the rows recorded as the call's for
    ``constrain``; all of them without a mesh."""
    if layout is None:
        return (tokens,) + stubs
    rows = layout.rows(tokens.shape[0])
    layout.batch_rows = rows.stop - rows.start
    return (tokens[rows],) + tuple(None if t is None else t[rows]
                                   for t in stubs)


def forward(params: Transformer, cfg: ModelConfig, rc: RunConfig,
            tokens: torch.Tensor, audio_embeds: Optional[torch.Tensor] = None,
            image_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence forward to final hidden states (B, S, D). An encdec
    model reads ``audio_embeds``, a VLM ``image_embeds``
    (:func:`check_stub_inputs`). On a mesh ``tokens`` and the stub inputs
    are the whole batch and the result the rank's rows of it."""
    check_stub_inputs(cfg, audio_embeds, image_embeds)
    layout = params.layout
    tokens, audio_embeds, image_embeds = rank_rows(layout, tokens,
                                                   audio_embeds, image_embeds)
    x = constrain(embed_tokens(params, tokens), layout, "batch", None, None)
    b = x.shape[0]
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=x.device)

    def run(fn, *args):
        return _maybe_remat(fn, rc)(*args)

    if cfg.family in ("dense", "moe"):
        for p in params.blocks:
            x = run(lambda x_, p_=p: _dense_block(p_, cfg, rc, x_, positions,
                                                  layout=layout), x)
    elif cfg.family == "vlm":
        img = _cross_source(image_embeds.to(x.dtype), layout)
        for group, pc in zip(params.self_groups, params.cross_layers):
            for p in group:
                x = run(lambda x_, p_=p: _dense_block(
                    p_, cfg, rc, x_, positions, layout=layout), x)
            x = run(lambda x_, p_=pc: _cross_block(p_, cfg, rc, x_, img,
                                                   layout), x)
    elif cfg.family == "hybrid":
        for group in params.mamba_groups:
            for p in group:
                x = run(lambda x_, p_=p: _mamba_layer(p_, cfg, rc, x_,
                                                      layout), x)
            x = run(lambda x_: _dense_block(params.shared_attn, cfg, rc, x_,
                                            positions, layout=layout), x)
    elif cfg.family == "hybrid_moe":
        for p in params.blocks:
            x = run(lambda x_, p_=p: _hybrid_block(p_, cfg, rc, x_,
                                                   positions), x)
    elif cfg.family == "ssm":
        h, n = rwkv_mod.rwkv_dims(cfg)
        zero_prev = torch.zeros((b, 1, cfg.d_model), dtype=x.dtype,
                                device=x.device)
        zero_state = torch.zeros((b, h, n, n), dtype=torch.float32,
                                 device=x.device)
        for p in params.blocks:
            x = run(lambda x_, p_=p: _rwkv_block(
                p_, cfg, rc, x_, zero_prev, zero_prev, zero_state, layout,
                keep_state=False)[0], x)
    else:                                               # encdec
        enc = _cross_source(encode(params, cfg, rc, audio_embeds), layout)
        for p in params.blocks:
            x = run(lambda x_, p_=p: _decoder_block(p_, cfg, rc, x_,
                                                    positions, enc, layout), x)
    return rms_norm(x, params.ln_f, cfg.norm_eps)


def lm_head(params: Transformer, cfg: ModelConfig) -> torch.Tensor:
    """The (d, Vpad) output projection: ``embed.T`` when tied."""
    if cfg.tie_embeddings:
        return params.embed.T
    return params.lm_head


class _VocabLogSumExp(torch.autograd.Function):
    """``logsumexp`` over the last dim of logits whose columns may be split
    over the mesh ``axes`` (none without a mesh): the local max all-reduced
    (max), the local sum of exponentials all-reduced (sum). Forward and
    backward are the operations of ``torch.logsumexp`` (max, ``exp(x −
    max)``, sum, log, + max; the gradient ``g · exp(x − lse)``), so over
    one rank the result and the gradient are its, bit for bit. The
    backward needs no collective: each rank's columns take their part."""

    @staticmethod
    def forward(ctx, x, layout, axes):
        m = x.amax(dim=-1, keepdim=True)
        if axes:
            m = layout.all_reduce(m, axes, "max")
        m = m.masked_fill(m.abs() == float("inf"), 0.0)
        total = (x - m).exp().sum(dim=-1)
        if axes:
            total = layout.all_reduce(total, axes)
        lse = total.log() + m[..., 0]
        ctx.save_for_backward(x, lse)
        return lse

    @staticmethod
    def backward(ctx, g):
        x, lse = ctx.saved_tensors
        return g[..., None] * (x - lse[..., None]).exp(), None, None


def _ce_chunk(h: torch.Tensor, head: torch.Tensor, lab: torch.Tensor,
              vocab_size: int, layout=None, axes=()):
    """(sum of -log p(label), count of labels) over one chunk; labels -1
    are ignored, padded vocabulary columns masked to -1e30. On a mesh
    ``head`` (d, V_loc) is the rank's block of a vocabulary split over
    ``axes``: the log-sum-exp runs over every column
    (:class:`_VocabLogSumExp`) and the label's logit comes from the rank
    that holds it, zeros elsewhere, summed over ``axes``."""
    logits = torch.matmul(h.float(), head.float())          # (B, c, V_loc)
    n = head.shape[1]
    first = layout.index(axes) * n if axes else 0
    if (layout.span(axes) if axes else 1) * n > vocab_size:
        col = first + torch.arange(n, device=logits.device)
        logits = torch.where(col < vocab_size, logits, NEG_INF)
    lse = _VocabLogSumExp.apply(logits, layout, axes)
    local = lab.clamp(min=0) - first
    inside = (local >= 0) & (local < n)
    ll = torch.take_along_dim(logits, local.clamp(0, n - 1)[..., None],
                              dim=-1)[..., 0]
    ll = torch.where(inside, ll, torch.zeros((), dtype=ll.dtype,
                                             device=ll.device))
    if axes:
        ll = reduce_from(ll, layout, axes)
    valid = (lab >= 0).float()
    return ((lse - ll) * valid).sum(), valid.sum()


def chunked_cross_entropy(hidden: torch.Tensor, head: torch.Tensor,
                          labels: torch.Tensor, vocab_size: int,
                          chunk: int = 512, layout=None) -> torch.Tensor:
    """Mean next-token CE without materialising (B, S, V) logits.

    hidden (B,S,D); head (D,Vpad); labels (B,S) with -1 = ignore. S is
    padded to a whole number of chunks with ignored labels. Each chunk is
    checkpointed, so only one chunk's logits live at a time, in the
    backward too; the sums accumulate chunk by chunk in f32, as the
    reference's scan does.

    On a mesh (``layout``) ``hidden`` and ``labels`` are the rank's rows
    and ``head`` its columns of the vocabulary: the loss is
    vocabulary-parallel (the hidden states' gradient summed over the
    vocabulary's axes) and the mean over every valid label of the global
    batch, the sum and the count all-reduced over the batch's axes. The
    sum's gradient is the rank's own (``reduce_from``), so the
    parameters' gradients are the rank's shares of the global mean's,
    summed over the data axes by the train step.
    """
    vocab = layout.axes("vocab") if layout is not None else ()
    if vocab:
        hidden = copy_to(hidden, layout, vocab)
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
                           labels[:, i:i + chunk], vocab_size, layout, vocab,
                           use_reentrant=False)
        loss_sum, cnt = loss_sum + ls, cnt + c
    batch = layout.axes("batch") if layout is not None else ()
    if batch:
        loss_sum = reduce_from(loss_sum, layout, batch)
        cnt = layout.all_reduce(cnt, batch)
    return loss_sum / torch.clamp(cnt, min=1.0)


def loss_fn(params: Transformer, cfg: ModelConfig, rc: RunConfig,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Mean next-token loss of ``batch`` (``tokens``, ``labels``: (B, S);
    ``audio_embeds`` or ``image_embeds`` where the family reads them).

    On a mesh every rank is given the whole batch and runs its rows of it
    (``layout.rows``); the result is the global batch's mean on every rank
    (:func:`chunked_cross_entropy`)."""
    layout = params.layout
    hidden = forward(params, cfg, rc, batch["tokens"],
                     audio_embeds=batch.get("audio_embeds"),
                     image_embeds=batch.get("image_embeds"))
    labels = batch["labels"].long()
    if cfg.logits_scaling != 1.0:
        hidden = hidden / cfg.logits_scaling
    if layout is None:
        head = lm_head(params, cfg)
    else:
        labels = labels[layout.rows(labels.shape[0])]
        head = (layout.whole(params.embed, 1).T if cfg.tie_embeddings
                else layout.whole(params.lm_head, 0))
    return chunked_cross_entropy(hidden, head, labels, cfg.vocab_size,
                                 chunk=rc.loss_chunk, layout=layout)


__all__ = ["Block", "CrossLayer", "DecoderBlock", "MambaLayer", "RWKVBlock",
           "HybridBlock", "residual",
           "Transformer", "RunConfig", "STUB_INPUTS", "check_stub_inputs",
           "embed_tokens", "ffn", "encode", "rank_rows", "forward",
           "lm_head", "chunked_cross_entropy", "loss_fn"]
