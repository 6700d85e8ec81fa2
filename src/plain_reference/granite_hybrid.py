"""A plain PyTorch forward pass of granite-4.0-h-small (``model_type``
``granitemoehybrid``): the reference that the port's hybrid_moe family is
held to.

Written from the published layer equations alone, in float32 with TF32
off, with no cache and no batching: one prompt at a time. It imports
nothing of the port and no kernel. The weights are handed in by name
(:func:`leaves` names and sizes them, as the port names its own), so both
sides read the same tensors.

The equations, for a prompt of S tokens (``d`` the width, RMSNorm
``norm(x, w) = x / sqrt(mean(x²) + eps) · w``):

* ``x = embed[tokens] · embedding_multiplier``.
* Each layer ``l``: ``x += residual_multiplier · mixer_l(norm(x, ln1))``,
  then ``x += residual_multiplier · (experts(h) + shared(h))`` with
  ``h = norm(x, ln2)``. The mixer is Mamba2 or attention by
  ``layer_types[l]``.
* Mamba2 (heads H of P channels, state N, one group, conv of K taps):
  ``[z | xBC | dt] = h @ in_proj``; ``xBC`` (``H·P + 2·N`` channels) goes
  through a causal depthwise conv with a bias (K − 1 zero rows before the
  first token), then SiLU, and splits into ``x``, ``B``, ``C``;
  ``dt = softplus(dt + dt_bias)``, ``A = −exp(A_log)``; per head
  ``s_t = exp(dt_t·A) · s_{t−1} + dt_t · B_t ⊗ x_t`` and
  ``y_t = C_t · s_t + D · x_t``, from ``s_0 = 0``; the output is
  ``norm(y · silu(z), norm) @ out_proj``. The scan runs a block of
  ``chunk`` tokens at a time: inside a block the pairs (t ≥ s) are summed
  directly with their decay ``exp(Σ_{s<u≤t} dt_u·A)``, and the state is
  carried from block to block, so 32k tokens fit on one card. The final
  state ``s_S`` and the conv's last K − 1 input rows are what a decode
  machine receives.
* Attention: GQA (query head ``h`` reads kv head ``h // (H/KH)``), no
  positional encoding (NoPE), the causal softmax of ``q·k ·
  attention_multiplier``, then ``wo``; taken ``rows`` query rows at a
  time.
* The experts: router logits ``h @ router`` in float32 over all ``E``
  experts of the layer; each token's ``top_k`` largest (ties to the lower
  index); gates a softmax over those ``top_k`` logits; each expert a
  SwiGLU ``(silu(h @ wg) · (h @ wi)) @ wo``. This device holds experts
  ``[first, first + held)`` and adds only their part: one card's share of
  an expert-parallel deployment, whose other experts lie on other cards.
  The shared expert is a SwiGLU every token takes whole.
* The head is ``norm(x, ln_f) @ embed.T / logits_scaling`` over the real
  vocabulary (tied embeddings).

Departures from the published model, which the port makes too:

* Capacity: each expert takes at most ``capacity`` assignments of the
  tokens routed together (``tokens · top_k · capacity_factor / E + 1``,
  clipped to [4, tokens], rounded up to 32), in token order then in each
  token's order of its choices; the rest are dropped and the kept gates
  are not scaled up. The published model drops nothing.
* More than ``token_chunk`` tokens route a chunk at a time, the last
  chunk filled up with zero rows; capacity counts a chunk.
* The held experts: the published model adds all 72 experts' parts; here
  the card's 9 (``held``) are added, the router still 72 wide.

Routing is not continuous: where a token's ``top_k``-th and next router
logits lie within :data:`TIE_MARGIN`, another sound float32 program may
choose the other expert. :func:`prefill` marks such tokens
(``tainted_from``), where the swap touches a held expert, chunk by chunk.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import torch

F = torch.nn.functional
TIE_MARGIN = 1e-4


@dataclasses.dataclass(frozen=True)
class Spec:
    """The sizes of one granite-4.0-h-small-shaped model. ``padded_vocab``
    rows of the embedding are held; ``vocab`` of them are real tokens.
    ``experts`` is the router's width; ``held`` experts from ``first``
    are this device's."""
    layer_types: Tuple[str, ...]
    d_model: int
    heads: int
    kv_heads: int
    head_dim: int
    vocab: int
    padded_vocab: int
    eps: float
    ssm_heads: int
    ssm_head_dim: int
    ssm_state: int
    conv_k: int
    chunk: int
    experts: int
    held: int
    first: int
    top_k: int
    expert_ff: int
    shared_ff: int
    embedding_multiplier: float
    attention_multiplier: float
    residual_multiplier: float
    logits_scaling: float
    capacity_factor: float = 1.25
    token_chunk: int = 8192

    @property
    def layers(self) -> int:
        return len(self.layer_types)

    @property
    def d_inner(self) -> int:
        return self.ssm_heads * self.ssm_head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ssm_state

    @property
    def moe(self) -> bool:
        return True

    @property
    def mamba_layers(self) -> List[int]:
        return [i for i, t in enumerate(self.layer_types) if t == "mamba"]

    @property
    def attention_layers(self) -> List[int]:
        return [i for i, t in enumerate(self.layer_types) if t != "mamba"]


def leaves(spec: Spec) -> List[Tuple[str, Tuple[int, ...], object]]:
    """Every weight as ``(name, shape, init)``: ``init`` is the fan-in of a
    matrix drawn at ``1/sqrt(fan_in)``, ``"ones"`` for a norm scale or
    ``D``, ``"A_log"`` or ``"dt_bias"`` for Mamba2's published draws.
    Matrices are ``(d_in, d_out)`` (experts ``(held, d_in, d_out)``),
    applied as ``x @ w``."""
    d, hd = spec.d_model, spec.head_dim
    nq, nkv = spec.heads * hd, spec.kv_heads * hd
    h, di, c = spec.ssm_heads, spec.d_inner, spec.conv_dim
    f, fs, e = spec.expert_ff, spec.shared_ff, spec.held
    out = [("embed", (spec.padded_vocab, d), d), ("ln_f", (d,), "ones")]
    for layer, kind in enumerate(spec.layer_types):
        p = f"blocks.{layer}."
        out.append((p + "ln1", (d,), "ones"))
        if kind == "mamba":
            out += [(p + "mamba.in_proj", (d, di + c + h), d),
                    (p + "mamba.conv_w", (spec.conv_k, c), spec.conv_k),
                    (p + "mamba.conv_b", (c,), spec.conv_k),
                    (p + "mamba.A_log", (h,), "A_log"),
                    (p + "mamba.D", (h,), "ones"),
                    (p + "mamba.dt_bias", (h,), "dt_bias"),
                    (p + "mamba.norm", (di,), "ones"),
                    (p + "mamba.out_proj", (di, d), di)]
        else:
            out += [(p + "attn.wq", (d, nq), d), (p + "attn.wk", (d, nkv), d),
                    (p + "attn.wv", (d, nkv), d), (p + "attn.wo", (nq, d), nq)]
        out += [(p + "ln2", (d,), "ones"),
                (p + "moe.router", (d, spec.experts), d),
                (p + "moe.wi", (e, d, f), d), (p + "moe.wg", (e, d, f), d),
                (p + "moe.wo", (e, f, d), f),
                (p + "shared.wi", (d, fs), d), (p + "shared.wg", (d, fs), d),
                (p + "shared.wo", (fs, d), fs)]
    return out


def norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) \
        * w.float()


def swiglu(x: torch.Tensor, wi: torch.Tensor, wg: torch.Tensor,
           wo: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ wg.float()) * (x @ wi.float())) @ wo.float()


def scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
         b: torch.Tensor, c: torch.Tensor, block: int):
    """The Mamba2 recurrence (module docstring) from a zero state, a
    ``block`` of tokens at a time. x (S, H, P), dt (S, H), a (H,) ≤ 0,
    b and c (S, N) → y (S, H, P) without the ``D`` term, final state
    (H, N, P)."""
    s_len, h, p = x.shape
    state = torch.zeros((h, b.shape[1], p), dtype=torch.float32,
                        device=x.device)
    ys = []
    for lo in range(0, s_len, block):
        hi = min(s_len, lo + block)
        u = x[lo:hi] * dt[lo:hi, :, None]                 # (L, H, P)
        logd = torch.cumsum(dt[lo:hi] * a, dim=0)         # (L, H)
        t = torch.arange(hi - lo, device=x.device)
        gap = logd[:, None, :] - logd[None, :, :]         # (t, s, H)
        lower = (t[:, None] >= t[None, :])[:, :, None]
        decay = torch.exp(torch.where(lower, gap, -math.inf))
        pair = (c[lo:hi] @ b[lo:hi].T)[:, :, None] * decay
        y = torch.einsum("tsh,shp->thp", pair, u)
        y = y + torch.exp(logd)[:, :, None] * torch.einsum(
            "tn,hnp->thp", c[lo:hi], state)
        to_end = torch.exp(logd[-1] - logd)               # (L, H)
        state = torch.exp(logd[-1])[:, None, None] * state + torch.einsum(
            "sh,sn,shp->hnp", to_end, b[lo:hi], u)
        ys.append(y)
    return torch.cat(ys), state


def mamba(w, p: str, spec: Spec, h: torch.Tensor):
    """The Mamba2 mixer of layer prefix ``p`` on the normed h (S, d):
    (output (S, d), conv state (K − 1, conv channels), SSM state
    (H, N, P))."""
    s_len = h.shape[0]
    di, n, k = spec.d_inner, spec.ssm_state, spec.conv_k
    proj = h @ w[p + "mamba.in_proj"].float()
    z, xbc, dt = proj[:, :di], proj[:, di:di + spec.conv_dim], \
        proj[:, di + spec.conv_dim:]
    padded = torch.cat([torch.zeros((k - 1, spec.conv_dim),
                                    device=h.device), xbc])
    cw = w[p + "mamba.conv_w"].float()
    conv = w[p + "mamba.conv_b"].float().expand(s_len, -1)
    for i in range(k):
        conv = conv + padded[i:i + s_len] * cw[i]
    conv_state = padded[-(k - 1):].clone()      # not a view of padded
    xbc = F.silu(conv)
    xs, bs, cs = xbc[:, :di], xbc[:, di:di + n], xbc[:, di + n:]
    dt = F.softplus(dt + w[p + "mamba.dt_bias"].float())
    a = -torch.exp(w[p + "mamba.A_log"].float())
    xh = xs.reshape(s_len, spec.ssm_heads, spec.ssm_head_dim)
    y, state = scan(xh, dt, a, bs, cs, spec.chunk)
    y = y + w[p + "mamba.D"].float()[None, :, None] * xh
    y = y.reshape(s_len, di) * F.silu(z)
    out = norm(y, w[p + "mamba.norm"], spec.eps) @ \
        w[p + "mamba.out_proj"].float()
    return out, conv_state, state


def attention(w, p: str, spec: Spec, h: torch.Tensor, rows: int = 512):
    """The attention of layer prefix ``p`` on the normed h (S, d):
    (output (S, d), keys and values (S, KH, hd))."""
    s_len, hd = h.shape[0], spec.head_dim
    q = (h @ w[p + "attn.wq"].float()).view(s_len, spec.heads, hd)
    k = (h @ w[p + "attn.wk"].float()).view(s_len, spec.kv_heads, hd)
    v = (h @ w[p + "attn.wv"].float()).view(s_len, spec.kv_heads, hd)
    group = spec.heads // spec.kv_heads
    kr = k.repeat_interleave(group, dim=1)
    vr = v.repeat_interleave(group, dim=1)
    outs = []
    for lo in range(0, s_len, rows):
        hi = min(s_len, lo + rows)
        sc = torch.einsum("qhd,khd->hqk", q[lo:hi], kr[:hi]) \
            * spec.attention_multiplier
        keep = (torch.arange(lo, hi, device=h.device)[:, None]
                >= torch.arange(hi, device=h.device)[None, :])
        sc = sc.masked_fill(~keep, -math.inf)
        outs.append(torch.einsum("hqk,khd->qhd", torch.softmax(sc, -1),
                                 vr[:hi]))
    o = torch.cat(outs).reshape(s_len, spec.heads * hd)
    return o @ w[p + "attn.wo"].float(), k, v


def capacity(tokens: int, spec: Spec) -> int:
    """Slots an expert has for ``tokens`` routed together (module
    docstring)."""
    c = int(tokens * spec.top_k * spec.capacity_factor / spec.experts) + 1
    c = max(4, min(tokens, c))
    return -(-c // 32) * 32


def route(x: torch.Tensor, router: torch.Tensor, spec: Spec):
    """(the router's logits sorted, descending (T, E); their experts)."""
    return torch.sort(x.float() @ router.float(), dim=-1, descending=True,
                      stable=True)


def experts(w, p: str, spec: Spec, x: torch.Tensor, real: int):
    """The held experts' part of the layer's mixture on the tokens x
    (T, d) routed together, of which the first ``real`` are a prompt's
    and the rest the zero rows that fill up a chunk: (output (T, d), the
    prompt's assignments dropped over all experts, a bool (T,) mask of
    the tokens at a near-tie that touches a held expert, and the prompt's
    tokens at such a near-tie)."""
    t, k = x.shape[0], spec.top_k
    vals, idx = route(x, w[p + "moe.router"], spec)
    gates = torch.softmax(vals[:, :k], dim=-1).reshape(-1)
    chosen = idx[:, :k].reshape(-1)                       # token order
    c = capacity(t, spec)
    load = torch.bincount(chosen, minlength=spec.experts)
    # The fill rows come last in token order: they take no prompt
    # token's slot.
    own = torch.bincount(chosen[:real * k], minlength=spec.experts)
    dropped = int(torch.clamp(own - c, min=0).sum())
    out = torch.zeros_like(x, dtype=torch.float32)
    first, held = spec.first, spec.held
    for j in range(held):
        taken = torch.nonzero(chosen == first + j).squeeze(1)[:c]
        tok = taken // k
        y = swiglu(x[tok].float(), w[p + "moe.wi"][j], w[p + "moe.wg"][j],
                   w[p + "moe.wo"][j])
        out.index_add_(0, tok, y * gates[taken][:, None])

    def mine(e):
        return (e >= first) & (e < first + held)

    tied = ((vals[:, k - 1] - vals[:, k]) < TIE_MARGIN) & (
        mine(idx[:, k - 1]) | mine(idx[:, k]))
    tied[real:] = False
    marked = tied.clone()
    pair = torch.cat([idx[tied, k - 1], idx[tied, k]])
    for e in torch.unique(pair).tolist():
        if first <= e < first + held and load[e] >= c:
            line = torch.nonzero(chosen == e).squeeze(1)[c - 1:c + 1]
            marked[line // k] = True
    return out, dropped, marked, int(tied.sum())


def feed_forward(w, p: str, spec: Spec, h: torch.Tensor):
    """The layer's experts and shared expert on the normed h (S, d):
    (output, dropped, marked tokens (S,), near-ties), routing
    ``token_chunk`` tokens at a time where there are more."""
    s_len, chunk = h.shape[0], spec.token_chunk
    shared = swiglu(h, w[p + "shared.wi"], w[p + "shared.wg"],
                    w[p + "shared.wo"])
    if s_len <= chunk:
        y, dropped, marked, ties = experts(w, p, spec, h, s_len)
        return y + shared, dropped, marked, ties
    x = F.pad(h, (0, 0, 0, (-s_len) % chunk))
    parts = [experts(w, p, spec, xi, min(chunk, s_len - lo))
             for lo, xi in zip(range(0, s_len, chunk), x.split(chunk))]
    y = torch.cat([q[0] for q in parts])[:s_len]
    marked = torch.cat([q[2] for q in parts])[:s_len]
    return (y + shared, sum(q[1] for q in parts), marked,
            sum(q[3] for q in parts))


@dataclasses.dataclass
class Prefill:
    """One prompt's reference: the last position's logits over the real
    vocabulary; each attention layer's keys and values (S, KH, hd) and
    each Mamba2 layer's final conv state (K − 1, conv channels) and SSM
    state (H, N, P), in layer order; the expert assignments dropped and
    made; the near-ties; and for each position the first layer from
    which its rows may differ in another sound float32 program (one past
    the layer where it was marked; ``layers + 1`` where it never was)."""
    logits: torch.Tensor
    keys: List[torch.Tensor]
    values: List[torch.Tensor]
    conv_states: List[torch.Tensor]
    ssm_states: List[torch.Tensor]
    dropped: int
    assigned: int
    near_ties: int
    tainted_from: torch.Tensor

    @property
    def logits_tainted(self) -> bool:
        """Whether a near-tie lies upstream of the last position's
        logits."""
        return bool(self.tainted_from[-1] <= len(self.keys)
                    + len(self.conv_states))


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@torch.no_grad()
def prefill(w, spec: Spec, tokens: torch.Tensor) -> Prefill:
    """The reference over one prompt ``tokens`` (S,), layer by layer, in
    float32 with TF32 off."""
    _no_tf32()
    s_len = tokens.shape[0]
    rm = spec.residual_multiplier
    x = w["embed"][tokens.long()].float() * spec.embedding_multiplier
    keys, values, convs, states = [], [], [], []
    dropped = ties = 0
    tainted_from = torch.full((s_len,), spec.layers + 1, dtype=torch.long,
                              device=tokens.device)
    for layer, kind in enumerate(spec.layer_types):
        p = f"blocks.{layer}."
        h = norm(x, w[p + "ln1"], spec.eps)
        if kind == "mamba":
            o, conv, state = mamba(w, p, spec, h)
            convs.append(conv)
            states.append(state)
        else:
            o, k, v = attention(w, p, spec, h)
            keys.append(k)
            values.append(v)
        x = x + rm * o
        y, n, marked, t = feed_forward(w, p, spec,
                                       norm(x, w[p + "ln2"], spec.eps))
        x = x + rm * y
        dropped += n
        ties += t
        tainted_from[marked] = torch.clamp(tainted_from[marked],
                                           max=layer + 1)
    last = norm(x[-1], w["ln_f"], spec.eps) / spec.logits_scaling
    logits = last @ w["embed"][:spec.vocab].float().T
    assigned = s_len * spec.top_k * spec.layers
    return Prefill(logits, keys, values, convs, states, dropped, assigned,
                   ties, tainted_from)


@torch.no_grad()
def forward_logits(w, spec: Spec, tokens: torch.Tensor) -> torch.Tensor:
    """The logits (S, vocab) of every position of ``tokens`` (S,): what
    prefill and then decode through a cache must give."""
    _no_tf32()
    rm = spec.residual_multiplier
    x = w["embed"][tokens.long()].float() * spec.embedding_multiplier
    for layer, kind in enumerate(spec.layer_types):
        p = f"blocks.{layer}."
        h = norm(x, w[p + "ln1"], spec.eps)
        o = mamba(w, p, spec, h)[0] if kind == "mamba" else \
            attention(w, p, spec, h)[0]
        x = x + rm * o
        x = x + rm * feed_forward(w, p, spec,
                                  norm(x, w[p + "ln2"], spec.eps))[0]
    return (norm(x, w["ln_f"], spec.eps) / spec.logits_scaling) @ \
        w["embed"][:spec.vocab].float().T


__all__ = ["Spec", "leaves", "prefill", "Prefill", "forward_logits",
           "scan", "mamba", "attention", "experts", "feed_forward",
           "capacity", "route", "norm", "TIE_MARGIN"]
