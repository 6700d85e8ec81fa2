"""A configuration file made into the reference's sizes, the benchmark's
weights, and the program's model holding those same weights.

The weights are the benchmark's: one draw of a truncated normal over every
weight at once on the card, from a generator seeded with ``--seed``, cut
into the leaves the reference names (``reference.decoder.leaves``) and
scaled by ``1/sqrt(fan_in)``; norm scales start at ones. A configuration's
``init`` key may change two scales (:func:`make_weights`), so that the
residual stream keeps each token's content through the layers. The program's
model is built on the meta device (no weights of its own) and given these
tensors, so both sides read the same numbers.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from reference.decoder import Spec, leaves


def spec_of(conf: dict) -> Spec:
    """The reference's sizes from a configuration file's keys."""
    d, heads = conf["hidden_size"], conf["num_attention_heads"]
    rnd = conf["run"]["vocab_round"]
    vocab = conf["vocab_size"]
    run = conf["run"]
    return Spec(
        layers=conf["num_hidden_layers"], d_model=d, heads=heads,
        kv_heads=conf["num_key_value_heads"],
        head_dim=conf.get("head_dim", d // heads),
        d_ff=conf["intermediate_size"], vocab=vocab,
        padded_vocab=-(-vocab // rnd) * rnd,
        tied=conf["tie_word_embeddings"], rope_theta=conf["rope_theta"],
        eps=conf["rms_norm_eps"], experts=conf.get("num_experts", 0),
        top_k=conf.get("num_experts_per_tok", 0),
        capacity_factor=run.get("moe_capacity", 1.25),
        token_chunk=run.get("moe_token_chunk", 8192))


RESIDUAL_OUT = ("attn.wo", "mlp.wo", "moe.wo")


def make_weights(spec: Spec, seed: int, device,
                 init: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """Every weight of ``spec`` from ``seed``: views of one float32
    buffer. ``init`` (a configuration's ``init`` key) may set
    ``embed_std`` (the embedding's scale in place of ``1/sqrt(d)``) and
    ``residual_depth_scaled`` (the projections that write into the
    residual stream, ``RESIDUAL_OUT``, scaled again by ``1/sqrt(2 ·
    layers)``, as GPT-2 draws them). Without them the residual of random
    weights fills with the running mean that causal attention adds to
    every token, and a router then sends most tokens to the same few
    experts."""
    init = init or {}
    depth = (1.0 / math.sqrt(2 * spec.layers)
             if init.get("residual_depth_scaled") else 1.0)
    items = leaves(spec)
    total = sum(math.prod(shape) for _, shape, _ in items)
    gen = torch.Generator(device=device).manual_seed(seed)
    buf = torch.empty(total, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(buf, 0.0, 1.0, -2.0, 2.0, generator=gen)
    out, off = {}, 0
    for name, shape, fan_in in items:
        n = math.prod(shape)
        t = buf[off:off + n].view(shape)
        off += n
        if fan_in is None:
            t.fill_(1.0)
        elif name == "embed" and "embed_std" in init:
            t.mul_(float(init["embed_std"]))
        else:
            out_proj = name.endswith(RESIDUAL_OUT)
            t.mul_((depth if out_proj else 1.0) / math.sqrt(fan_in))
        out[name] = t
    return out


def as_dtype(weights: Dict[str, torch.Tensor],
             dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """``weights`` themselves for float32; else copies in ``dtype``, the
    router kept in float32 as the program keeps it."""
    if dtype == torch.float32:
        return weights
    return {n: t if n.endswith("router") else t.to(dtype)
            for n, t in weights.items()}


def port_config(conf: dict):
    """The program's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.base import ModelConfig

    spec = spec_of(conf)
    moe = conf["family"] == "moe"
    return ModelConfig(
        name=conf["name"], family=conf["family"], num_layers=spec.layers,
        d_model=spec.d_model, num_heads=spec.heads,
        num_kv_heads=spec.kv_heads, d_ff=spec.d_ff, vocab_size=spec.vocab,
        head_dim=spec.head_dim, tie_embeddings=spec.tied,
        rope_theta=spec.rope_theta, norm_eps=spec.eps,
        num_experts=spec.experts, experts_per_tok=spec.top_k,
        moe_d_ff=spec.d_ff if moe else 0,
        vocab_round=conf["run"]["vocab_round"])


def run_fields(conf: dict) -> dict:
    """The ``RunConfig`` fields a configuration file sets (the MoE ones)."""
    keys = ("moe_impl", "moe_capacity", "moe_token_chunk")
    return {k: conf["run"][k] for k in keys if k in conf["run"]}


def port_model(conf: dict, weights: Dict[str, torch.Tensor], rc=None):
    """The program's model of ``conf`` holding ``weights`` (no copy).
    Raises where the program's weights differ in name or shape."""
    from repro_torch.models import build_model
    from repro_torch.models.common import attach_axes
    from repro_torch.models.transformer import RunConfig

    rc = rc or RunConfig(**run_fields(conf))
    model = build_model(port_config(conf), device="meta", rc=rc)
    want = {n: tuple(p.shape) for n, p in model.named_parameters()}
    have = {n: tuple(t.shape) for n, t in weights.items()}
    if want != have:
        raise ValueError(f"the program's weights differ from the "
                         f"benchmark's: {sorted(set(want.items()) ^ set(have.items()))[:6]}")
    model.load_state_dict(weights, strict=True, assign=True)
    attach_axes(model, model.param_axes)
    return model


__all__ = ["spec_of", "make_weights", "as_dtype", "port_config",
           "port_model", "run_fields"]
