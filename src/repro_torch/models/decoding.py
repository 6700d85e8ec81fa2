"""Prefill and single-token decode for every family.

The port of ``repro/models/decoding.py``. Caches are a dict of tensors,
stacked as the layers that read them:

  dense/moe — k/v (L, B, S, KH, hd)
  vlm       — self k/v (G, k−1, B, S, KH, hd), cross xk/xv (G, B, Timg, KH, hd)
  hybrid    — Mamba conv (G, k, B, K−1, d_in), ssm (G, k, B, H, N, P) and
              the shared attention's ak/av (G, B, S, KH, hd)
  hybrid_moe — two kinds side by side, by ``layer_types``: each Mamba2
              layer's conv (Lm, B, K−1, C) (C the conv's width,
              ``ssm.conv_width``) and ssm (Lm, B, H, N, P), each attention
              layer's k/v (La, B, S, KH, hd), in layer order
  ssm       — token-shift carries tm_prev/cm_prev (L, B, 1, d), wkv
              state (L, B, H, N, N)
  encdec    — decoder self k/v (L, B, S, KH, hd), cross xk/xv
              (L, B, Tenc, KH, hd)

Keys, values, the token-shift carries and the Mamba conv states are kept
in the cache dtype (bf16 by default, as in the reference), the wkv and SSD
states in f32; decode casts each carry back to the activations' dtype on
reading it, as the reference does. :func:`prefill` writes fresh zero caches
and runs every attention through kernel B4 (the hybrid's shared block,
whisper's encoder and its decoder's self- and cross-attention, the VLM's
self and cross layers) whatever the model's ``RunConfig`` says; its
RWKV evaluator is ``rc.rwkv_impl`` and its SSD chunk ``rc.ssd_chunk``.
:func:`decode_step` writes one position of every cache in place, where the
reference threads the caches through its layer scan and returns new ones;
it runs RWKV by the exact scan whatever ``rc.rwkv_impl`` says, and
cross-attention reads the cached cross K/V without writing, rotating or
masking. An MoE block runs ``moe`` with the ``RunConfig``'s MoE fields
over the call's B·S tokens. Both run under ``torch.no_grad()``.

:func:`cache_specs` gives every family's cache specs under a plan, the
reference's ``init_caches`` specs: a KV cache leaf is sharded by
:func:`kv_spec` (batch, then kv heads, then the sequence on whatever
``seq_kv`` axes those two left free). On a mesh (a model of any family
built with a plan, ``Transformer.layout``) the entry points take the whole
batch on every rank, stub embeddings included, keep the rank's rows, hold
the rank's block of every cache, and return the whole logits on every
rank; a cache whose sequence is split is written, in prefill and in
decode, only where the rank holds the position. The cross K/V caches hold
the rank's kv heads; the Mamba2 conv cache the rank's channels, which are
its heads' (``models/ssm.py``); the WKV and SSD states and the token-shift
carries are whole on every model rank, so the mixers gather their heads'
states after each call (``models/rwkv.py``, ``models/ssm.py``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .. import spans
from ..configs.base import ModelConfig, check_family
from . import rwkv as rwkv_mod
from . import ssm as ssm_mod
from .attention import attention, decode_attention
from .common import constrain, rms_norm
from .mlp import mlp
from .sharding import ShardingPlan, entry_axes
from .transformer import (RunConfig, Transformer, _rwkv_block,
                          check_stub_inputs, embed_tokens, encode, ffn,
                          lm_head, rank_rows, residual)


def kv_spec(plan: ShardingPlan, ndim: int) -> tuple:
    """A KV cache leaf's spec, (…, batch, seq, kv heads, hd), with
    conflict-free axes: a mesh axis is used once, so where the kv heads
    and ``seq_kv`` both want 'model' (olmoe's 16 kv heads) the heads win
    and the sequence drops that axis; the batch's axes are taken first."""
    batch_ax, kv_ax = plan.axes.get("batch"), plan.axes.get("kv")
    used = set(entry_axes(batch_ax)) | set(entry_axes(kv_ax))
    seq = tuple(a for a in entry_axes(plan.axes.get("seq_kv"))
                if a not in used)
    seq_ax = seq if len(seq) > 1 else (seq[0] if seq else None)
    return (None,) * (ndim - 4) + (batch_ax, seq_ax, kv_ax, None)


def cache_specs(cfg: ModelConfig, plan: Optional[ShardingPlan] = None
                ) -> Dict[str, tuple]:
    """Every cache leaf's spec under ``plan``, by name: the spec tree of
    the reference's ``Model.abstract_caches``."""
    check_family(cfg.family)
    plan = plan or ShardingPlan.null()
    cross = plan.P(None, "batch", None, "kv", None)
    if cfg.family in ("dense", "moe"):
        return {"k": kv_spec(plan, 5), "v": kv_spec(plan, 5)}
    if cfg.family == "vlm":
        return {"k": kv_spec(plan, 6), "v": kv_spec(plan, 6), "xk": cross,
                "xv": cross}
    if cfg.family == "hybrid":
        return {"conv": plan.P(None, None, "batch", None, "ff"),
                "ssm": plan.P(None, None, "batch", None, None, None),
                "ak": kv_spec(plan, 5), "av": kv_spec(plan, 5)}
    if cfg.family == "hybrid_moe":
        return {"conv": plan.P(None, "batch", None, "ff"),
                "ssm": plan.P(None, "batch", None, None, None),
                "k": kv_spec(plan, 5), "v": kv_spec(plan, 5)}
    if cfg.family == "ssm":
        carry = plan.P(None, "batch", None, None)
        return {"tm_prev": carry, "cm_prev": carry,
                "state": plan.P(None, "batch", None, None, None)}
    return {"k": kv_spec(plan, 5), "v": kv_spec(plan, 5), "xk": cross,
            "xv": cross}                                       # encdec


def cache_shapes(cfg: ModelConfig, batch: int, seq_len: int
                 ) -> Dict[str, tuple]:
    """Every cache leaf's whole shape, by name, and whether it is f32
    (the recurrent states) rather than the cache dtype."""
    check_family(cfg.family)
    kh, hd = cfg.num_kv_heads, cfg.head_dim
    if cfg.family in ("dense", "moe"):
        shp = (cfg.num_layers, batch, seq_len, kh, hd)
        return {"k": (shp, False), "v": (shp, False)}
    if cfg.family == "vlm":
        g = cfg.num_layers // cfg.cross_attn_every
        shp = (g, cfg.cross_attn_every - 1, batch, seq_len, kh, hd)
        xshp = (g, batch, cfg.num_image_tokens, kh, hd)
        return {"k": (shp, False), "v": (shp, False), "xk": (xshp, False),
                "xv": (xshp, False)}
    if cfg.family == "hybrid":
        g, k = cfg.num_layers // cfg.attn_every, cfg.attn_every
        d_in, h, n = ssm_mod.ssm_dims(cfg)
        shp = (g, batch, seq_len, kh, hd)
        return {"conv": ((g, k, batch, ssm_mod.CONV_K - 1, d_in), False),
                "ssm": ((g, k, batch, h, n, cfg.ssm_head_dim), True),
                "ak": (shp, False), "av": (shp, False)}
    if cfg.family == "hybrid_moe":
        d_in, h, n = ssm_mod.ssm_dims(cfg)
        lm = cfg.layer_types.count("mamba")
        la = cfg.num_layers - lm
        return {"conv": ((lm, batch, ssm_mod.CONV_K - 1,
                          ssm_mod.conv_width(cfg)), False),
                "ssm": ((lm, batch, h, n, cfg.ssm_head_dim), True),
                "k": ((la, batch, seq_len, kh, hd), False),
                "v": ((la, batch, seq_len, kh, hd), False)}
    if cfg.family == "ssm":
        h, n = rwkv_mod.rwkv_dims(cfg)
        lyr = cfg.num_layers
        return {"tm_prev": ((lyr, batch, 1, cfg.d_model), False),
                "cm_prev": ((lyr, batch, 1, cfg.d_model), False),
                "state": ((lyr, batch, h, n, n), True)}
    shp = (cfg.num_layers, batch, seq_len, kh, hd)               # encdec
    xshp = (cfg.num_layers, batch, cfg.encoder_seq, kh, hd)
    return {"k": (shp, False), "v": (shp, False), "xk": (xshp, False),
            "xv": (xshp, False)}


def init_caches(cfg: ModelConfig, batch: int, seq_len: int,
                dtype: torch.dtype = torch.bfloat16,
                device=None, layout=None) -> Dict[str, torch.Tensor]:
    """Empty (zero) caches sized for ``seq_len`` decode of ``batch``
    sequences; on ``layout``'s mesh the rank's blocks of them."""
    specs = None
    if layout is not None:
        specs = cache_specs(cfg, layout.plan)
    out = {}
    for name, (shape, f32) in cache_shapes(cfg, batch, seq_len).items():
        if specs is not None:
            shape = tuple(sl.stop - sl.start
                          for sl in layout.block(shape, specs[name]))
        out[name] = torch.zeros(shape, dtype=torch.float32 if f32 else dtype,
                                device=device)
    return out


def seq_axes(layout) -> tuple:
    """The mesh axes a self-attention KV cache's sequence is split over."""
    if layout is None:
        return ()
    return entry_axes(kv_spec(layout.plan, 5)[2])


def _logits(params: Transformer, cfg: ModelConfig,
            x: torch.Tensor) -> torch.Tensor:
    """f32 logits (B, Vpad) of the last position of x (B, S, D), divided
    by the config's ``logits_scaling`` where it is not 1. On a mesh the
    head is the rank's vocabulary columns, and the logits are gathered
    over the vocabulary's and the batch's axes."""
    last = rms_norm(x[:, -1], params.ln_f, cfg.norm_eps)
    if cfg.logits_scaling != 1.0:
        last = last / cfg.logits_scaling
    layout = params.layout
    if layout is None:
        return torch.matmul(last.float(), lm_head(params, cfg).float())
    head = (layout.whole(params.embed, 1).T if cfg.tie_embeddings
            else layout.whole(params.lm_head, 0))
    logits = torch.matmul(last.float(), head.float())
    for axes, dim in ((layout.axes("vocab"), 1), (layout.axes("batch"), 0)):
        if axes:
            logits = layout.all_gather(logits, axes, dim)
    return logits


def _swiglu(p, cfg: ModelConfig, x: torch.Tensor, layout) -> torch.Tensor:
    """x plus the block p's SwiGLU on ``ln2`` of x, then the block's
    constraint."""
    x = x + mlp(p.mlp, rms_norm(x, p.ln2, cfg.norm_eps), layout)
    return constrain(x, layout, "batch", None, None)


@torch.no_grad()
def prefill(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
            cache_len: Optional[int] = None,
            cache_dtype: torch.dtype = torch.bfloat16,
            rc: Optional[RunConfig] = None,
            audio_embeds: Optional[torch.Tensor] = None,
            image_embeds: Optional[torch.Tensor] = None):
    """Run the prompt tokens (B, S); returns (last-token logits (B, Vpad)
    in f32, caches padded with zeros to ``cache_len``). ``rc`` (default
    ``RunConfig()``) gives the MoE, RWKV and SSD fields; an encdec model
    reads ``audio_embeds``, a VLM ``image_embeds``."""
    with spans.span("prefill"):
        return _prefill(params, cfg, tokens, cache_len, cache_dtype, rc,
                        audio_embeds, image_embeds)


def _prefill(params: Transformer, cfg: ModelConfig, tokens: torch.Tensor,
             cache_len: Optional[int], cache_dtype: torch.dtype,
             rc: Optional[RunConfig], audio_embeds: Optional[torch.Tensor],
             image_embeds: Optional[torch.Tensor]):
    check_stub_inputs(cfg, audio_embeds, image_embeds)
    rc = rc or RunConfig()
    layout = params.layout
    b, s = tokens.shape
    cache_len = cache_len or s
    tokens, audio_embeds, image_embeds = rank_rows(layout, tokens,
                                                   audio_embeds, image_embeds)
    x = constrain(embed_tokens(params, tokens), layout, "batch", None, None)
    positions = torch.arange(s, dtype=torch.int32, device=x.device)
    c = init_caches(cfg, b, cache_len, cache_dtype, x.device, layout)
    seq = seq_axes(layout)

    def self_attn(p, x_, k_cache, v_cache):
        """x_ plus p's causal self-attention through B4; its keys and
        values written into the first s positions of the caches (those
        of the rank's block of positions on a mesh)."""
        with spans.span("attn"):
            out = attention(p.attn, cfg, rms_norm(x_, p.ln1, cfg.norm_eps),
                            positions, impl="pallas", return_kv=True,
                            layout=layout)
            s_loc = k_cache.shape[1]
            lo = layout.index(seq) * s_loc if seq else 0
            n = max(0, min(s - lo, s_loc))
            k_cache[:, :n] = out.k[:, lo:lo + n].to(cache_dtype)
            v_cache[:, :n] = out.v[:, lo:lo + n].to(cache_dtype)
            return x_ + out.out

    def cross_attn(p, ln, x_, src, k_cache, v_cache):
        """x_ plus the gated cross-attention p over src through B4; its
        keys and values (the rank's kv heads) written into the cross
        caches."""
        with spans.span("attn"):
            out = attention(p, cfg, rms_norm(x_, ln, cfg.norm_eps), None,
                            kv_x=src, causal=False, impl="pallas",
                            return_kv=True, layout=layout)
            k_cache.copy_(out.k.to(cache_dtype))
            v_cache.copy_(out.v.to(cache_dtype))
            return x_ + out.out

    def swiglu(p, x_):
        with spans.span("ffn"):
            return _swiglu(p, cfg, x_, layout)

    if cfg.family in ("dense", "moe"):
        for layer, p in enumerate(params.blocks):
            x = self_attn(p, x, c["k"][layer], c["v"][layer])
            with spans.span("ffn"):
                x = x + ffn(p, cfg, rc, rms_norm(x, p.ln2, cfg.norm_eps),
                            layout)
            x = constrain(x, layout, "batch", None, None)
    elif cfg.family == "ssm":
        h, n = rwkv_mod.rwkv_dims(cfg)
        b_loc = x.shape[0]
        zero_prev = torch.zeros((b_loc, 1, cfg.d_model), dtype=x.dtype,
                                device=x.device)
        zero_state = torch.zeros((b_loc, h, n, n), dtype=torch.float32,
                                 device=x.device)
        for layer, p in enumerate(params.blocks):
            x, tm_c, cm_c, st = _rwkv_block(p, cfg, rc, x, zero_prev,
                                            zero_prev, zero_state, layout)
            c["tm_prev"][layer] = tm_c.to(cache_dtype)
            c["cm_prev"][layer] = cm_c.to(cache_dtype)
            c["state"][layer] = st
    elif cfg.family == "hybrid":
        shared = params.shared_attn
        for g, group in enumerate(params.mamba_groups):
            for j, p in enumerate(group):
                o, mc = ssm_mod.mamba_block(
                    p.mamba, cfg, rms_norm(x, p.ln, cfg.norm_eps),
                    chunk=rc.ssd_chunk, layout=layout)
                x = constrain(x + o, layout, "batch", None, None)
                c["conv"][g, j] = mc.conv.to(cache_dtype)
                c["ssm"][g, j] = mc.ssm
            x = self_attn(shared, x, c["ak"][g], c["av"][g])
            x = swiglu(shared, x)
    elif cfg.family == "hybrid_moe":
        n_mamba = n_attn = 0
        for p in params.blocks:
            if hasattr(p, "mamba"):
                with spans.span("mamba"):
                    o, mc = ssm_mod.mamba_block(
                        p.mamba, cfg, rms_norm(x, p.ln1, cfg.norm_eps),
                        chunk=rc.ssd_chunk)
                    x = residual(cfg, x, o)
                    c["conv"][n_mamba] = mc.conv.to(cache_dtype)
                    c["ssm"][n_mamba] = mc.ssm
                n_mamba += 1
            else:
                with spans.span("attn"):
                    out = attention(p.attn, cfg,
                                    rms_norm(x, p.ln1, cfg.norm_eps),
                                    positions, impl="pallas", return_kv=True)
                    c["k"][n_attn, :, :s] = out.k.to(cache_dtype)
                    c["v"][n_attn, :, :s] = out.v.to(cache_dtype)
                    x = residual(cfg, x, out.out)
                n_attn += 1
            with spans.span("ffn"):
                x = residual(cfg, x, ffn(p, cfg, rc,
                                         rms_norm(x, p.ln2, cfg.norm_eps)))
    elif cfg.family == "vlm":
        img = image_embeds.to(x.dtype)
        for g, (group, pc) in enumerate(zip(params.self_groups,
                                            params.cross_layers)):
            for j, p in enumerate(group):
                x = self_attn(p, x, c["k"][g, j], c["v"][g, j])
                x = swiglu(p, x)
            x = cross_attn(pc.xattn, pc.ln1, x, img, c["xk"][g], c["xv"][g])
            x = swiglu(pc, x)
    else:                                               # encdec
        enc = encode(params, cfg, rc, audio_embeds, impl="pallas")
        for layer, p in enumerate(params.blocks):
            x = self_attn(p, x, c["k"][layer], c["v"][layer])
            x = cross_attn(p.xattn, p.ln_x, x, enc, c["xk"][layer],
                           c["xv"][layer])
            x = swiglu(p, x)
    with spans.span("logits"):
        logits = _logits(params, cfg, x)
    return logits, c


@torch.no_grad()
def decode_step(params: Transformer, cfg: ModelConfig, token: torch.Tensor,
                caches: Dict[str, torch.Tensor], pos: int,
                rc: Optional[RunConfig] = None):
    """token (B,); pos an int. Returns (logits (B, Vpad) in f32, caches).

    The caches are updated in place at ``pos`` (the recurrent states
    replaced) and returned as given. ``rc`` (default ``RunConfig()``)
    gives the MoE fields. On a mesh ``token`` is the whole batch and the
    caches the rank's blocks.
    """
    rc = rc or RunConfig()
    c = caches
    layout = params.layout
    token, = rank_rows(layout, token)
    x = constrain(embed_tokens(params, token[:, None]), layout, "batch",
                  None, None)                            # (B, 1, D)
    seq = seq_axes(layout)

    def self_attn(p, x_, k_cache, v_cache):
        out = decode_attention(p.attn, cfg, rms_norm(x_, p.ln1, cfg.norm_eps),
                               pos, k_cache, v_cache, layout=layout,
                               seq_axes=seq)
        return x_ + out.out

    def cross_attn(p, ln, x_, k_cache, v_cache):
        out = decode_attention(p, cfg, rms_norm(x_, ln, cfg.norm_eps), pos,
                               k_cache, v_cache, update_cache=False,
                               rope_on_q=False, mask_to_pos=False,
                               layout=layout)
        return x_ + out.out

    if cfg.family in ("dense", "moe"):
        for layer, p in enumerate(params.blocks):
            x = self_attn(p, x, c["k"][layer], c["v"][layer])
            x = x + ffn(p, cfg, rc, rms_norm(x, p.ln2, cfg.norm_eps), layout)
            x = constrain(x, layout, "batch", None, None)
    elif cfg.family == "ssm":
        for layer, p in enumerate(params.blocks):
            tm_prev, cm_prev = c["tm_prev"][layer], c["cm_prev"][layer]
            x, tm_c, cm_c, st = _rwkv_block(
                p, cfg, rc, x, tm_prev.to(x.dtype), cm_prev.to(x.dtype),
                c["state"][layer], layout, impl="scan")
            tm_prev.copy_(tm_c.to(tm_prev.dtype))
            cm_prev.copy_(cm_c.to(cm_prev.dtype))
            c["state"][layer] = st
    elif cfg.family == "hybrid":
        shared = params.shared_attn
        for g, group in enumerate(params.mamba_groups):
            for j, p in enumerate(group):
                z = rms_norm(x, p.ln, cfg.norm_eps)
                conv = c["conv"][g, j]
                o, mc = ssm_mod.mamba_step(
                    p.mamba, cfg, z,
                    ssm_mod.MambaCache(conv=conv.to(z.dtype),
                                       ssm=c["ssm"][g, j]), layout=layout)
                x = constrain(x + o, layout, "batch", None, None)
                conv.copy_(mc.conv.to(conv.dtype))
                c["ssm"][g, j] = mc.ssm
            x = self_attn(shared, x, c["ak"][g], c["av"][g])
            x = _swiglu(shared, cfg, x, layout)
    elif cfg.family == "hybrid_moe":
        n_mamba = n_attn = 0
        for p in params.blocks:
            z = rms_norm(x, p.ln1, cfg.norm_eps)
            if hasattr(p, "mamba"):
                conv = c["conv"][n_mamba]
                o, mc = ssm_mod.mamba_step(
                    p.mamba, cfg, z,
                    ssm_mod.MambaCache(conv=conv.to(z.dtype),
                                       ssm=c["ssm"][n_mamba]))
                conv.copy_(mc.conv.to(conv.dtype))
                c["ssm"][n_mamba] = mc.ssm
                n_mamba += 1
            else:
                o = decode_attention(p.attn, cfg, z, pos, c["k"][n_attn],
                                     c["v"][n_attn]).out
                n_attn += 1
            x = residual(cfg, x, o)
            x = residual(cfg, x, ffn(p, cfg, rc,
                                     rms_norm(x, p.ln2, cfg.norm_eps)))
    elif cfg.family == "vlm":
        for g, (group, pc) in enumerate(zip(params.self_groups,
                                            params.cross_layers)):
            for j, p in enumerate(group):
                x = self_attn(p, x, c["k"][g, j], c["v"][g, j])
                x = _swiglu(p, cfg, x, layout)
            x = cross_attn(pc.xattn, pc.ln1, x, c["xk"][g], c["xv"][g])
            x = _swiglu(pc, cfg, x, layout)
    else:                                               # encdec
        for layer, p in enumerate(params.blocks):
            x = self_attn(p, x, c["k"][layer], c["v"][layer])
            x = cross_attn(p.xattn, p.ln_x, x, c["xk"][layer],
                           c["xv"][layer])
            x = _swiglu(p, cfg, x, layout)
    return _logits(params, cfg, x), caches


__all__ = ["init_caches", "cache_specs", "cache_shapes", "kv_spec",
           "seq_axes", "prefill", "decode_step"]
