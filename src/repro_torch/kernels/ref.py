"""Plain PyTorch versions of the hand-written kernels.

Each function here defines what its kernel in :mod:`.neighbor_min` or
:mod:`.flash_attention` must compute. The wrappers take these only for
tensors on the CPU; the tests hold them against the reference's oracles,
and ``chip_smoke.py`` holds the CUDA kernels against them on the card.

Every ELL function takes either one graph (``ell`` of shape ``(n, W)``,
state of shape ``(S,)``) or a batch (``ell`` of shape ``(B, R, W)``, state
of shape ``(B, S)``). A neighbour id outside ``[0, S)`` reads as the pad
slot: inactive with rank ``INF``, label ``-1``.
"""

from __future__ import annotations

import torch

INF_I32 = 2**31 - 1


def _gather(table: torch.Tensor, ell: torch.Tensor):
    """``table`` gathered through ``ell`` per graph, plus the in-range mask."""
    S = table.shape[-1]
    ok = (ell >= 0) & (ell < S)
    idx = torch.where(ok, ell, torch.zeros_like(ell)).long()
    if ell.dim() == 2:
        return table[idx], ok
    B = ell.shape[0]
    vals = torch.gather(table, 1, idx.reshape(B, -1)).reshape(ell.shape)
    return vals, ok


def neighbor_min_ref(ell: torch.Tensor, ranks: torch.Tensor,
                     active: torch.Tensor) -> torch.Tensor:
    """Per row: min of ``ranks[id]`` over neighbour ids with ``active[id]``.

    ``INF_I32`` where no neighbour is active. int32 out, shape ``ell[..., 0]``.
    """
    if ell.shape[-1] == 0:
        return torch.full(ell.shape[:-1], INF_I32, dtype=torch.int32,
                          device=ell.device)
    vals, ok = _gather(ranks, ell)
    act, _ = _gather(active, ell)
    masked = torch.where(ok & act, vals, torch.full_like(vals, INF_I32))
    return masked.amin(dim=-1).to(torch.int32)


def label_agree_ref(ell: torch.Tensor, labels_p: torch.Tensor) -> torch.Tensor:
    """Per row ``r``: how many neighbour ids carry the label ``labels_p[r]``.

    The pad slot's label is the ``-1`` sentinel, never a real label, so
    padding contributes nothing. int32 out, shape ``ell[..., 0]``.
    """
    R = ell.shape[-2]
    nbr, ok = _gather(labels_p, ell)
    own = labels_p[..., :R]
    same = ok & (nbr == own.unsqueeze(-1))
    return same.sum(dim=-1).to(torch.int32)


NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """Attention forward in f32 math. q (B,H,Sq,D), k/v (B,KH,Sk,D).

    GQA by repeating each KV head over its ``H // KH`` query heads; scores
    scaled by ``1/sqrt(D)``; causal rows offset by ``Sk - Sq`` (a query
    suffix against a longer key prefix), masked to ``-1e30``; output in
    ``q``'s dtype.
    """
    sq, d = q.shape[2], q.shape[3]
    sk = k.shape[2]
    group = q.shape[1] // k.shape[1]
    kr = k.float().repeat_interleave(group, dim=1)
    vr = v.float().repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr) * float(
        1.0 / (d ** 0.5))
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr).to(q.dtype)


__all__ = ["neighbor_min_ref", "label_agree_ref", "attention_ref",
           "INF_I32", "NEG_INF"]
