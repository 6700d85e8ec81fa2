"""Plain PyTorch versions of the hand-written kernels.

Each function here defines what its kernel in :mod:`.neighbor_min`,
:mod:`.agreement`, :mod:`.mis_pivot` or :mod:`.flash_attention` must
compute. The wrappers
take these only for tensors on the CPU; the tests hold them against the
reference's oracles, and ``chip_smoke.py`` holds the CUDA kernels against
them on the card.

Every ELL function takes either one graph (``ell`` of shape ``(n, W)``,
state of shape ``(S,)``) or a batch (``ell`` of shape ``(B, R, W)``, state
of shape ``(B, S)``). A neighbour id outside ``[0, S)`` reads as the pad
slot: inactive with rank ``INF``, label ``-1``.
"""

from __future__ import annotations

from typing import Optional

import torch

INF_I32 = 2**31 - 1

# Agreement threshold β = BETA_NUM/BETA_DEN of the precluster method:
# neighbours u, v agree when |N[u] Δ N[v]| < β·max(|N[u]|, |N[v]|) over
# closed neighbourhoods. Kept rational so the device (int32) and host
# (int64) comparisons are the same integer predicate.
BETA_NUM = 2
BETA_DEN = 5

# Peak bytes the plain agreement pass may hold for its (rows, W, W)
# candidate lists at once; it walks the flattened (entry, row) axis in
# chunks that fit. At (R, W) = (2¹⁵, 32) one entry's lists take ~0.4 GiB.
AGREE_BYTES = 256 << 20
# Bytes a (row, w, w') candidate costs in the pass: the int32 candidate,
# two int32 search positions and a bool.
_AGREE_PAIR_BYTES = 13


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


def _csr_edges(row_offsets: torch.Tensor, dst: torch.Tensor, n: int):
    """(src, nbr) int64 of every CSR entry whose neighbour id is below n."""
    off = row_offsets.long()
    src = torch.repeat_interleave(torch.arange(n, device=dst.device),
                                  off[1:n + 1] - off[:n])
    nbr = dst[:src.numel()].long()
    keep = nbr < n
    return src[keep], nbr[keep]


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
    src, nbr = _csr_edges(row_offsets, dst, n)
    src = src.expand(k, -1)
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


def mis_window_ref(row_offsets: torch.Tensor, dst: torch.Tensor,
                   ranks: torch.Tensor, status: torch.Tensor, lo: int,
                   hi: int):
    """Algorithm 1's ``_run_window`` on one graph: from ``status`` (n,)
    int32, the reference's ``_mis_round`` with ``eligible = lo <= rank <
    hi`` while an undecided eligible vertex remains. Returns the new
    ``status`` (n,) int32 and ``rounds`` (1,) int32, the rounds this
    window took. Ineligible undecided vertices do not compete but are
    removed by a winning neighbour.
    """
    n = ranks.shape[0]
    dev = ranks.device
    status = status.to(torch.int32).clone()
    rounds = torch.zeros((1,), dtype=torch.int32, device=dev)
    if n == 0:
        return status, rounds
    src, nbr = _csr_edges(row_offsets, dst, n)
    eligible = (ranks >= lo) & (ranks < hi)
    rank_at_nbr = ranks[nbr]
    inf = torch.full_like(rank_at_nbr, INF_I32)

    def segment_min(mask: torch.Tensor) -> torch.Tensor:
        out = torch.full((n,), INF_I32, dtype=torch.int32, device=dev)
        return out.scatter_reduce_(0, src, torch.where(
            mask[nbr], rank_at_nbr, inf), reduce="amin")

    while True:
        und = (status == UNDECIDED) & eligible
        if not bool(und.any()):
            break
        rounds += 1
        winners = und & (ranks < segment_min(und))
        hit = (status == UNDECIDED) & ~winners & (segment_min(winners)
                                                  < INF_I32)
        status = torch.where(winners, IN_MIS, status)
        status = torch.where(hit, REMOVED, status).to(torch.int32)
    return status, rounds


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


def common_neighbours_ref(ell: torch.Tensor,
                          budget: Optional[int] = None) -> torch.Tensor:
    """(B, R, W) int32: for every ELL slot (u, w) with neighbour v, the
    number of non-pad ids of row v that appear in row u (0 at pads).

    The reference looks each of v's ELL ids up in u's sorted ELL row with
    a left ``searchsorted`` and tests the id found. Here an id is a member
    when its right and left search positions differ, which is the same
    test without a gather. The (rows, W, W) candidate lists are built for
    a chunk of the flattened (entry, row) axis at a time, at most
    ``budget`` bytes (default :data:`AGREE_BYTES`); the counts do not
    depend on the chunking.
    """
    B, R, W = ell.shape
    budget = AGREE_BYTES if budget is None else budget
    dev = ell.device
    ell_sorted = ell.sort(dim=2).values.reshape(B * R, W)
    # Rows of every entry plus a pad row R each, flattened: the row of
    # neighbour id v of entry b is b·(R+1) + v.
    ell_rows = torch.cat(
        [ell, ell.new_full((B, 1, W), R)], dim=1).reshape(B * (R + 1), W)
    base = (torch.arange(B, device=dev, dtype=torch.int64) * (R + 1)
            ).view(B, 1, 1)
    gid = (ell.long() + base).reshape(B * R, W)
    common = torch.empty((B * R, W), dtype=torch.int32, device=dev)
    rows = max(1, budget // (_AGREE_PAIR_BYTES * W * W))
    for r0 in range(0, B * R, rows):
        r1 = min(B * R, r0 + rows)
        cand = ell_rows[gid[r0:r1]].reshape(r1 - r0, W * W)
        srt = ell_sorted[r0:r1]
        lo = torch.searchsorted(srt, cand, out_int32=True)
        hi = torch.searchsorted(srt, cand, right=True, out_int32=True)
        member = (hi != lo) & (cand != R)
        common[r0:r1] = member.view(r1 - r0, W, W).sum(2, dtype=torch.int32)
        del cand, lo, hi, member
    return common.view(B, R, W)


def agreement_ell_ref(ell: torch.Tensor, budget: Optional[int] = None,
                      replicas: int = 1) -> torch.Tensor:
    """The agreement graph's ELL: ``ell`` (B, R, W) with every edge that
    does not agree replaced by the pad id ``R``. The integer predicate
    ``BETA_DEN·(du+dv−2·common−2) < BETA_NUM·(max(du, dv)+1)`` is
    symmetric in (u, v), so the result is undirected. Ids lie in
    ``[0, R]``.

    With ``replicas`` = k the batch is groups of k entries that carry one
    graph (a bucket's best-of-k samples): ``out[b]`` is the agreement ELL
    of ``ell[(b // k)·k]``, each group's first entry computed once and
    repeated. ``B % replicas != 0`` raises.
    """
    B, R, W = ell.shape
    if replicas < 1 or B % replicas:
        raise ValueError(f"agreement_ell_ref: batch of {B} entries is not "
                         f"whole groups of replicas={replicas}")
    if replicas > 1:
        first = agreement_ell_ref(ell[::replicas], budget)
        return first.repeat_interleave(replicas, dim=0)
    real = ell != R
    deg = real.sum(dim=2, dtype=torch.int32)                  # (B, R)
    common = common_neighbours_ref(ell, budget)
    deg_p = torch.cat([deg, deg.new_zeros((B, 1))], dim=1)
    dv = torch.gather(deg_p, 1, ell.reshape(B, R * W).long()).view(B, R, W)
    du = deg.unsqueeze(2)
    sym_diff = du + dv - 2 * common - 2     # closed nbhds: u∈N[v], v∈N[u]
    agree = real & (BETA_DEN * sym_diff
                    < BETA_NUM * (torch.maximum(du, dv) + 1))
    return torch.where(agree, ell, ell.new_full((), R))


__all__ = ["neighbor_min_ref", "label_agree_ref", "mis_pivot_ref",
           "mis_window_ref",
           "attention_ref", "common_neighbours_ref", "agreement_ell_ref",
           "INF_I32", "NEG_INF", "BETA_NUM", "BETA_DEN", "AGREE_BYTES"]
