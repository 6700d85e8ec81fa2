"""Plain PyTorch versions of the hand-written kernels.

Each function here defines what its kernel in :mod:`.neighbor_min`,
:mod:`.mis_pivot` or :mod:`.flash_attention` must compute. The wrappers
take these only for tensors on the CPU; the tests hold them against the
reference's oracles, and ``chip_smoke.py`` holds the CUDA kernels against
them on the card.

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


UNDECIDED, IN_MIS, REMOVED = 0, 1, 2


def mis_pivot_ref(row_offsets: torch.Tensor, dst: torch.Tensor,
                  ranks: torch.Tensor, eligible: torch.Tensor):
    """Greedy MIS rounds and the PIVOT capture of k samples of one graph.

    ``row_offsets`` (n+2,) and ``dst``: the graph's CSR (sorted by src,
    padded with the sentinel ``n``); ``ranks`` (k, n) int32, a permutation
    per row; ``eligible`` (n,) bool. Returns ``status`` (k, n) int32,
    ``labels`` (k, n) int32 and ``rounds`` (k,) int32. Every sample steps
    together; a sample's round count stops growing once it has no
    undecided vertex, and its further rounds change nothing. Each round is
    the reference's ``_mis_round``: undecided eligible local minima of the
    rank win, their undecided neighbours are removed; then each eligible
    non-MIS vertex takes its min-rank MIS neighbour, every other vertex
    itself.
    """
    k, n = ranks.shape
    dev = ranks.device
    own = torch.arange(n, dtype=torch.int32, device=dev).expand(k, n)
    status = torch.where(eligible, UNDECIDED, REMOVED).to(
        torch.int32).expand(k, n).clone()
    rounds = torch.zeros((k,), dtype=torch.int32, device=dev)
    if n == 0:
        return status, own.clone(), rounds
    off = row_offsets.long()
    src = torch.repeat_interleave(torch.arange(n, device=dev),
                                  off[1:n + 1] - off[:n])
    nbr = dst[:src.numel()].long()
    keep = nbr < n
    src, nbr = src[keep].expand(k, -1), nbr[keep]
    rank_at_nbr = ranks[:, nbr]
    inf = torch.full_like(rank_at_nbr, INF_I32)

    def segment_min(mask: torch.Tensor) -> torch.Tensor:
        # Per (sample, vertex): min rank over neighbours with mask set.
        out = torch.full((k, n), INF_I32, dtype=torch.int32, device=dev)
        return out.scatter_reduce_(1, src, torch.where(
            mask[:, nbr], rank_at_nbr, inf), reduce="amin")

    while True:
        und = (status == UNDECIDED) & eligible
        live = (status == UNDECIDED).any(dim=1)
        if not bool(live.any()):
            break
        rounds += live.to(torch.int32)
        winners = und & (ranks < segment_min(und))
        hit = (status == UNDECIDED) & ~winners & (segment_min(winners)
                                                  < INF_I32)
        status = torch.where(winners, IN_MIS, status)
        status = torch.where(hit, REMOVED, status).to(torch.int32)
    in_mis = status == IN_MIS
    wmin = segment_min(in_mis)
    rank_to_v = torch.zeros((k, n), dtype=torch.int32, device=dev).scatter_(
        1, ranks.long(), own)
    pivot = rank_to_v.gather(1, wmin.long().clamp(max=n - 1))
    labels = torch.where(in_mis, own, torch.where(wmin < INF_I32, pivot, own))
    return status, torch.where(eligible, labels, own), rounds


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


__all__ = ["neighbor_min_ref", "label_agree_ref", "mis_pivot_ref",
           "attention_ref", "INF_I32", "NEG_INF"]
