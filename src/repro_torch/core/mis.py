"""Randomized greedy MIS: sequential oracle and round-parallel simulation.

Greedy MIS with respect to a permutation π (paper footnote 2): iterate the
vertices in π-order and add a vertex iff no earlier neighbour was added.
The parallel simulation repeatedly selects *local minima* of the rank among
undecided vertices; by Fischer–Noever (Theorem 5) the number of rounds is
the longest dependency path, ``O(log n)`` w.h.p., and the resulting set is
identical to the sequential greedy MIS for the same π.

PIVOT's cluster assignment (each removed vertex joins the *first* pivot in
π-order among its neighbours) is "min-rank MIS neighbour", computed in one
post-pass (:func:`assign_to_min_rank_mis_neighbor`).

The per-round hot loop, every undecided vertex taking the min rank over its
undecided neighbours, is :func:`neighbor_min_ranks`. It always goes through
the ELL kernel wrapper :func:`repro_torch.kernels.neighbor_min.
neighbor_min_ell` (kernel B3): the hand-written CUDA kernel for a graph on
the card, its plain version for a graph on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import neighbor_min as _nm
from repro_torch.util import resolve_device

from . import rng as _rng
from .graph import Graph

# Vertex status codes.
UNDECIDED = 0
IN_MIS = 1
REMOVED = 2

INF_RANK = 2**31 - 1


def random_permutation_ranks(n: int, key, device=None) -> torch.Tensor:
    """rank[v] = position of v in the permutation drawn from ``key``."""
    return random_permutation_ranks_batch(n, [key], device=device)[0]


def random_permutation_ranks_batch(n: int, keys: Sequence,
                                   device=None) -> torch.Tensor:
    """``(k, n)`` int32 ranks for the k keys of one graph, in one call.

    Row ``i`` is bit-identical to ``random_permutation_ranks(n, keys[i])``
    and to the reference's ``jax.random.permutation`` ranks.
    """
    dev = resolve_device(device)
    return _rng.ranks_from_permutation(_rng.permutation_batch(keys, n, dev))


# ---------------------------------------------------------------------------
# Sequential oracles (numpy): ground truth for tests.
# ---------------------------------------------------------------------------


def _host_csr(g: Graph):
    return g.dst.cpu().numpy(), g.row_offsets.cpu().numpy()


def greedy_mis_sequential(g: Graph, ranks) -> np.ndarray:
    """Sequential greedy MIS; returns the bool mask of MIS membership."""
    n = g.n
    order = np.argsort(np.asarray(ranks), kind="stable")
    dst, row = _host_csr(g)
    in_mis = np.zeros(n, dtype=bool)
    blocked = np.zeros(n, dtype=bool)
    for v in order:
        if blocked[v]:
            continue
        in_mis[v] = True
        for e in range(row[v], row[v + 1]):
            blocked[dst[e]] = True
    return in_mis


def pivot_sequential(g: Graph, ranks) -> np.ndarray:
    """Sequential PIVOT (Ailon–Charikar–Newman): cluster labels per vertex."""
    n = g.n
    order = np.argsort(np.asarray(ranks), kind="stable")
    dst, row = _host_csr(g)
    labels = np.full(n, -1, dtype=np.int32)
    for v in order:
        if labels[v] >= 0:
            continue
        labels[v] = v
        for e in range(row[v], row[v + 1]):
            u = dst[e]
            if u < n and labels[u] < 0:
                labels[u] = v
    return labels


# ---------------------------------------------------------------------------
# Round-parallel simulation (torch).
# ---------------------------------------------------------------------------


def _masked_segment_min(g: Graph, vals_at_dst: torch.Tensor,
                        mask_at_dst: torch.Tensor) -> torch.Tensor:
    """Segment-min over COO edges: per src vertex, min of vals[dst] | mask[dst]."""
    n = g.n
    dst = g.dst.long()
    dst_ok = dst < n
    dst_idx = dst.clamp(max=max(n - 1, 0))
    vals = torch.where(dst_ok & mask_at_dst[dst_idx], vals_at_dst[dst_idx],
                       torch.full_like(dst, INF_RANK, dtype=torch.int32))
    seg = torch.full((n + 1,), INF_RANK, dtype=torch.int32, device=dst.device)
    seg.scatter_reduce_(0, g.src.long().clamp(max=n), vals, reduce="amin")
    return seg[:n]


def neighbor_min_ranks(g: Graph, ranks: torch.Tensor, active: torch.Tensor,
                       ell: Optional[torch.Tensor] = None) -> torch.Tensor:
    """For every vertex: min rank over *active* neighbours (INF if none).

    ``ell`` is the graph's ELL table (:func:`repro_torch.kernels.
    neighbor_min.ell_from_graph`), built here when not given; the MIS loop
    builds it once, outside the rounds.
    """
    if ell is None:
        ell = _nm.ell_from_graph(g)
    ranks_p, active_p = _nm.pad_state(ranks, active)
    return _nm.neighbor_min_ell(ell, ranks_p, active_p)


class MISState(NamedTuple):
    status: torch.Tensor   # (n,) int32 in {UNDECIDED, IN_MIS, REMOVED}
    rounds: int            # parallel rounds executed


def _mis_round(g: Graph, ranks: torch.Tensor, status: torch.Tensor,
               eligible: torch.Tensor, ell: torch.Tensor) -> torch.Tensor:
    """One parallel round restricted to ``eligible`` vertices.

    Local minima among undecided∩eligible join the MIS; their undecided
    neighbours (eligible or not) are removed. Returns the new status.
    """
    und = (status == UNDECIDED) & eligible
    nmin = neighbor_min_ranks(g, ranks, und, ell=ell)
    winners = und & (ranks < nmin)
    wmin = _masked_segment_min(g, ranks, winners)
    hit = (status == UNDECIDED) & ~winners & (wmin < INF_RANK)
    status = torch.where(winners, torch.full_like(status, IN_MIS), status)
    return torch.where(hit, torch.full_like(status, REMOVED), status)


def greedy_mis_parallel(g: Graph, ranks: torch.Tensor,
                        eligible: Optional[torch.Tensor] = None) -> MISState:
    """Round-parallel greedy MIS, rounds run until no vertex is undecided.

    ``eligible`` restricts the instance to an induced subgraph (the
    Theorem 26 degree cap); ineligible vertices start REMOVED and never
    take part. ``rounds`` is the dependency depth actually realized.
    """
    n = g.n
    dev = g.device
    ranks = ranks.to(device=dev, dtype=torch.int32)
    if eligible is None:
        eligible = torch.ones((n,), dtype=torch.bool, device=dev)
    eligible = eligible.to(device=dev, dtype=torch.bool)
    status = torch.where(eligible, UNDECIDED, REMOVED).to(torch.int32)
    ell = _nm.ell_from_graph(g)        # loop-invariant
    rounds = 0
    while bool((status == UNDECIDED).any()):
        status = _mis_round(g, ranks, status, eligible, ell)
        rounds += 1
    return MISState(status=status, rounds=rounds)


def assign_to_min_rank_mis_neighbor(g: Graph, ranks: torch.Tensor,
                                    in_mis: torch.Tensor) -> torch.Tensor:
    """PIVOT post-pass: label every vertex with its min-rank MIS neighbour.

    MIS vertices label themselves; the others take the MIS neighbour of
    minimum rank (maximality guarantees one exists among eligible ones).
    """
    n = g.n
    dev = g.device
    ranks = ranks.to(device=dev, dtype=torch.int32)
    own = torch.arange(n, dtype=torch.int32, device=dev)
    if n == 0:
        return own
    wmin = _masked_segment_min(g, ranks, in_mis)
    rank_to_v = torch.zeros((n,), dtype=torch.int32, device=dev)
    rank_to_v.scatter_(0, ranks.long(), own)
    pivot = rank_to_v[wmin.long().clamp(max=n - 1)]
    return torch.where(in_mis, own, torch.where(wmin < INF_RANK, pivot, own))


__all__ = [
    "UNDECIDED",
    "IN_MIS",
    "REMOVED",
    "INF_RANK",
    "MISState",
    "random_permutation_ranks",
    "random_permutation_ranks_batch",
    "greedy_mis_sequential",
    "pivot_sequential",
    "greedy_mis_parallel",
    "assign_to_min_rank_mis_neighbor",
    "neighbor_min_ranks",
]
