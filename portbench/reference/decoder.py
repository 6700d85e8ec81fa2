"""A plain PyTorch decoder: the reference that the benchmark holds the
program to.

Dense (SwiGLU) and mixture-of-experts decoder layers with grouped-query
attention and rotary positions, in float32, written from the layer
equations alone. It imports nothing of the program: the benchmark makes
the weights (``leaves`` names and sizes them) and hands the same tensors
to both sides, and everything else is worked out here again.

The equations (``d`` the width, ``H`` query heads of ``hd``, ``KH``
key/value heads, query head ``h`` reading key/value head ``h // (H/KH)``):

* ``x = embed[tokens]``; each layer ``x += attn(norm(x, ln1))`` then
  ``x += ffn(norm(x, ln2))``; ``norm(x, w) = x / sqrt(mean(x²) + eps) · w``.
* Attention projects ``x @ wq``, ``x @ wk``, ``x @ wv``, rotates queries
  and keys by position (the two halves of each head rotated together, the
  inverse frequencies ``theta^(-2i/hd)`` worked out in float64 and used in
  float32, the angles position × frequency in float32), takes a causal
  softmax of the scores scaled by ``1/sqrt(hd)``, and projects by ``wo``.
* The dense feed-forward is ``(silu(x @ wg) · (x @ wi)) @ wo``.
* The mixture of experts routes each token by its float32 router logits
  to its ``top_k`` largest (ties to the lower expert index), weighs the
  chosen experts by a softmax over their ``top_k`` logits, and gives each
  expert ``capacity`` slots: assignments are taken in token order (then in
  the token's own order of its choices), and those past the expert's
  slots are dropped. A dropped assignment adds nothing, and the weights of
  the token's other experts are not scaled up to make up for it. More
  than ``token_chunk`` tokens route a chunk at a time, the last chunk
  filled up with zero rows.
* The head is ``norm(x, ln_f) @ embed.T`` where the embeddings are tied,
  else ``@ lm_head``; the loss is the mean cross-entropy of the next token
  over the vocabulary's ``vocab`` real columns.

Departures from the published models are the benchmark's configuration
files' to state (their ``not_modelled`` key): this module is the function
that the program states it computes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

Weights = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Spec:
    """The sizes of one decoder. ``padded_vocab`` rows of the embedding
    are held; ``vocab`` of them are real tokens."""
    layers: int
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    padded_vocab: int
    tied: bool
    rope_theta: float
    eps: float
    experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    token_chunk: int = 8192

    @property
    def moe(self) -> bool:
        return self.experts > 0


def leaves(spec: Spec) -> List[Tuple[str, Tuple[int, ...], Optional[int]]]:
    """Every weight as ``(name, shape, fan_in)``; a norm scale, which
    starts at ones, has fan-in None. Matrices are ``(d_in, d_out)``
    (experts ``(E, d_in, d_out)``), applied as ``x @ w``."""
    d, hd, f = spec.d_model, spec.head_dim, spec.d_ff
    nq, nkv = spec.heads * hd, spec.kv_heads * hd
    out = [("embed", (spec.padded_vocab, d), d), ("ln_f", (d,), None)]
    if not spec.tied:
        out.append(("lm_head", (d, spec.padded_vocab), d))
    for layer in range(spec.layers):
        p = f"blocks.{layer}."
        out += [(p + "ln1", (d,), None), (p + "attn.wq", (d, nq), d),
                (p + "attn.wk", (d, nkv), d), (p + "attn.wv", (d, nkv), d),
                (p + "attn.wo", (nq, d), nq), (p + "ln2", (d,), None)]
        if spec.moe:
            e = spec.experts
            out += [(p + "moe.router", (d, e), d),
                    (p + "moe.wi", (e, d, f), d), (p + "moe.wg", (e, d, f), d),
                    (p + "moe.wo", (e, f, d), f)]
        else:
            out += [(p + "mlp.wi", (d, f), d), (p + "mlp.wg", (d, f), d),
                    (p + "mlp.wo", (f, d), f)]
    return out


def norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) \
        * w.float()


def rotate(x: torch.Tensor, positions: torch.Tensor,
           theta: float) -> torch.Tensor:
    """x (..., S, heads, hd) rotated at ``positions`` (S,)."""
    hd = x.shape[-1]
    half = hd // 2
    inv = torch.as_tensor(1.0 / theta ** (np.arange(half) * 2.0 / hd),
                          dtype=torch.float32, device=x.device)
    ang = positions.float()[:, None] * inv[None, :]       # (S, half)
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     rows: int = 1024) -> torch.Tensor:
    """q (B, S, H, hd), k and v (B, S, KH, hd) → (B, S, H, hd), taken
    ``rows`` query rows at a time so that the scores fit."""
    s, h, hd = q.shape[1], q.shape[2], q.shape[3]
    group = h // k.shape[2]
    kr = k.repeat_interleave(group, dim=2)
    vr = v.repeat_interleave(group, dim=2)
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for a in range(0, s, rows):
        b = min(s, a + rows)
        sc = torch.einsum("bqhd,bkhd->bhqk", q[:, a:b], kr[:, :b]) * scale
        keep = (torch.arange(a, b, device=q.device)[:, None]
                >= torch.arange(b, device=q.device)[None, :])
        sc = sc.masked_fill(~keep, float("-inf"))
        outs.append(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(sc, -1),
                                 vr[:, :b]))
    return torch.cat(outs, dim=1)


def attention(w: Weights, p: str, spec: Spec, h: torch.Tensor,
              positions: torch.Tensor):
    """The attention of layer prefix ``p`` on the normed h (B, S, d):
    (output (B, S, d), rotated keys and values (B, S, KH, hd))."""
    b, s, _ = h.shape
    hd = spec.head_dim
    q = (h @ w[p + "attn.wq"].float()).view(b, s, spec.heads, hd)
    k = (h @ w[p + "attn.wk"].float()).view(b, s, spec.kv_heads, hd)
    v = (h @ w[p + "attn.wv"].float()).view(b, s, spec.kv_heads, hd)
    q = rotate(q, positions, spec.rope_theta)
    k = rotate(k, positions, spec.rope_theta)
    o = causal_attention(q, k, v).reshape(b, s, spec.heads * hd)
    return o @ w[p + "attn.wo"].float(), k, v


def swiglu(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
           wo: torch.Tensor) -> torch.Tensor:
    return (torch.nn.functional.silu(x @ wg.float()) * (x @ wi.float())) \
        @ wo.float()


def capacity(tokens: int, spec: Spec) -> int:
    """Slots an expert has for ``tokens`` routed together: one more than
    its share ``tokens · top_k · capacity_factor / experts`` (rounded
    down), at least 4 and at most ``tokens``, rounded up to a multiple of
    32."""
    c = int(tokens * spec.top_k * spec.capacity_factor / spec.experts) + 1
    c = max(4, min(tokens, c))
    return -(-c // 32) * 32


def route(x: torch.Tensor, router: torch.Tensor, spec: Spec):
    """(gates (T, top_k), experts (T, top_k)) of the tokens x (T, d)."""
    logits = x.float() @ router.float()
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    k = spec.top_k
    return torch.softmax(vals[:, :k], dim=-1), idx[:, :k]


# Far above the router logits' round-off: a change of one unit in the last
# place of the input moves them by under 2e-6 over olmoe-1b-7b's 16 layers.
TIE_MARGIN = 1e-4


def near_ties(x: torch.Tensor, router: torch.Tensor,
              spec: Spec) -> Tuple[torch.Tensor, int]:
    """The tokens of x (T, d), routed together, whose outputs another
    sound float32 program may compute differently, and how many near-ties
    there are. A near-tie is a token whose ``top_k``-th and next router
    logits lie within ``TIE_MARGIN``: round-off can swap those two
    experts.
    Where either of them is full (its load reaches its capacity), the
    swap also moves the expert's capacity line by one, so the tokens of
    its last kept and first dropped assignments are marked too. Returns a
    bool (T,) mask of the marked tokens."""
    t, k = x.shape[0], spec.top_k
    vals, idx = torch.sort(x.float() @ router.float(), dim=-1,
                           descending=True, stable=True)
    tied = (vals[:, k - 1] - vals[:, k]) < TIE_MARGIN
    marked = tied.clone()
    if tied.any():
        c = capacity(t, spec)
        flat = idx[:, :k].reshape(-1)
        load = torch.bincount(flat, minlength=spec.experts)
        pair = torch.cat([idx[tied, k - 1], idx[tied, k]])
        for e in torch.unique(pair).tolist():
            if load[e] >= c:
                order = torch.nonzero(flat == e).squeeze(1)
                marked[order[c - 1:c + 1] // k] = True
    return marked, int(tied.sum())


def experts(w: Weights, p: str, spec: Spec, x: torch.Tensor):
    """The mixture of experts of layer prefix ``p`` on the tokens x (T, d)
    routed together: (output (T, d), assignments dropped)."""
    t = x.shape[0]
    gates, idx = route(x, w[p + "moe.router"], spec)
    c = capacity(t, spec)
    flat, flat_g = idx.reshape(-1), gates.reshape(-1)
    out = torch.zeros_like(x, dtype=torch.float32)
    dropped = 0
    for e in range(spec.experts):
        taken = torch.nonzero(flat == e).squeeze(1)       # token order
        dropped += max(0, taken.numel() - c)
        taken = taken[:c]
        tok = taken // spec.top_k
        y = swiglu(x[tok].float(), w[p + "moe.wi"][e], w[p + "moe.wg"][e],
                   w[p + "moe.wo"][e])
        out.index_add_(0, tok, y * flat_g[taken][:, None])
    return out, dropped


def feed_forward(w: Weights, p: str, spec: Spec, h: torch.Tensor):
    """The feed-forward of layer prefix ``p`` on the normed h (B, S, d):
    (output, assignments dropped)."""
    if not spec.moe:
        return swiglu(h, w[p + "mlp.wi"], w[p + "mlp.wg"], w[p + "mlp.wo"]), 0
    b, s, d = h.shape
    x = h.reshape(b * s, d)
    n, chunk = x.shape[0], spec.token_chunk
    if n <= chunk:
        y, dropped = experts(w, p, spec, x)
    else:
        x = torch.nn.functional.pad(x, (0, 0, 0, (-n) % chunk))
        parts = [experts(w, p, spec, xi) for xi in x.split(chunk)]
        y = torch.cat([part[0] for part in parts])[:n]
        dropped = sum(part[1] for part in parts)
    return y.view(b, s, d), dropped


def head(w: Weights, spec: Spec) -> torch.Tensor:
    """The (d, vocab) output projection over the real vocabulary."""
    if spec.tied:
        return w["embed"][:spec.vocab].float().T
    return w["lm_head"][:, :spec.vocab].float()


@dataclasses.dataclass
class Prefill:
    """One prompt's reference: the last position's logits over the real
    vocabulary, each layer's rotated keys and values (S, KH, hd), the
    expert assignments dropped over all layers, the routing choices
    within round-off of a tie (:func:`near_ties`), and for each position
    the first layer from which its rows may differ in another sound
    float32 program: one past the first layer where :func:`near_ties`
    marked it (``layers + 1`` where it never did; ``layers`` means the
    logits alone, where it is the last position)."""
    logits: torch.Tensor
    keys: List[torch.Tensor]
    values: List[torch.Tensor]
    dropped: int
    near_ties: int = 0
    tainted_from: Optional[torch.Tensor] = None

    @property
    def logits_tainted(self) -> bool:
        """Whether a near-tie lies upstream of the last position's
        logits."""
        return bool(self.tainted_from[-1] <= len(self.keys))


@torch.no_grad()
def prefill(w: Weights, spec: Spec, tokens: torch.Tensor) -> Prefill:
    """The reference over one prompt ``tokens`` (S,), layer by layer."""
    s = tokens.shape[0]
    pos = torch.arange(s, device=tokens.device)
    x = w["embed"][tokens.long()].float()[None]
    keys, values, dropped, ties = [], [], 0, 0
    if spec.moe and s > spec.token_chunk:
        raise ValueError(f"a prompt of {s} tokens routes in chunks of "
                         f"{spec.token_chunk}; near-ties are marked in one")
    tainted_from = torch.full((s,), spec.layers + 1, dtype=torch.long,
                              device=tokens.device)
    for layer in range(spec.layers):
        p = f"blocks.{layer}."
        o, k, v = attention(w, p, spec, norm(x, w[p + "ln1"], spec.eps), pos)
        keys.append(k[0])
        values.append(v[0])
        x = x + o
        h = norm(x, w[p + "ln2"], spec.eps)
        if spec.moe:
            marked, n = near_ties(h[0], w[p + "moe.router"], spec)
            ties += n
            tainted_from[marked] = torch.clamp(tainted_from[marked],
                                               max=layer + 1)
        y, n = feed_forward(w, p, spec, h)
        x = x + y
        dropped += n
    last = norm(x[0, -1], w["ln_f"], spec.eps)
    return Prefill(last @ head(w, spec), keys, values, dropped, ties,
                   tainted_from)


def _layer(x: torch.Tensor, positions: torch.Tensor, w: Weights, p: str,
           spec: Spec) -> torch.Tensor:
    o, _, _ = attention(w, p, spec, norm(x, w[p + "ln1"], spec.eps),
                        positions)
    x = x + o
    return x + feed_forward(w, p, spec, norm(x, w[p + "ln2"], spec.eps))[0]


def loss(w: Weights, spec: Spec, tokens: torch.Tensor,
         labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens`` (B, S) against
    ``labels`` (B, S). Each layer is recomputed in the backward, so that
    the gradients of a full-size model fit beside its optimizer state."""
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    x = w["embed"][tokens.long()].float()
    for layer in range(spec.layers):
        x = checkpoint(_layer, x, pos, w, f"blocks.{layer}.", spec,
                       use_reentrant=False)
    logits = norm(x, w["ln_f"], spec.eps) @ head(w, spec)
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, spec.vocab), labels.reshape(-1).long())


__all__ = ["Spec", "Weights", "leaves", "prefill", "Prefill", "loss",
           "capacity", "route", "norm", "rotate", "causal_attention"]
