"""Arboricity bounds via degeneracy peeling.

The degeneracy ``d`` of a graph satisfies ``λ ≤ d ≤ 2λ − 1``
(Nash–Williams), so it is a 2-approximation of arboricity usable in the
Algorithm 4 degree threshold; only the constant in ``O(λ/ε)`` moves.

* :func:`degeneracy_sequential` — exact min-degree peeling with a heap
  (host).
* :func:`degeneracy_parallel` — round-parallel doubling peel on the
  graph's device: strip every vertex of live degree ≤ k, doubling k when a
  round strips nothing; an upper bound ≤ 2d in O(log²) rounds.
"""

from __future__ import annotations

import heapq
from typing import Tuple

import numpy as np
import torch

from .graph import Graph


def degeneracy_sequential(g: Graph) -> int:
    """Exact degeneracy via a min-degree peeling with a heap."""
    n = g.n
    if n == 0:
        return 0
    deg = g.deg.cpu().numpy().copy()
    dst = g.dst.cpu().numpy()
    row = g.row_offsets.cpu().numpy()
    removed = np.zeros(n, dtype=bool)
    heap = [(int(deg[v]), v) for v in range(n)]
    heapq.heapify(heap)
    degeneracy = 0
    seen = 0
    while heap and seen < n:
        d, v = heapq.heappop(heap)
        if removed[v] or d != deg[v]:
            continue
        removed[v] = True
        seen += 1
        degeneracy = max(degeneracy, d)
        for e in range(row[v], row[v + 1]):
            u = int(dst[e])
            if u < n and not removed[u]:
                deg[u] -= 1
                heapq.heappush(heap, (int(deg[u]), u))
    return int(degeneracy)


def _live_degree(g: Graph, alive: torch.Tensor) -> torch.Tensor:
    """Per vertex: its neighbours with ``alive`` set (int32, length n)."""
    n = g.n
    dst = g.dst.long()
    contrib = ((dst < n) & alive[dst.clamp(max=n - 1)]).to(torch.int32)
    deg = torch.zeros((n + 1,), dtype=torch.int32, device=g.device)
    deg.index_add_(0, g.src.long().clamp(max=n), contrib)
    return deg[:n]


def _peel(g: Graph, max_iters: int = 128) -> Tuple[int, int]:
    """Doubling peel: ``(k_bound, rounds)`` with λ ≤ degeneracy ≤ k_bound.

    Each round is a few operations on the device and one blocking read of
    whether a vertex is still alive; k stays on the device.
    """
    n = g.n
    k = torch.ones((), dtype=torch.int32, device=g.device)
    rounds = 0
    alive = torch.ones((n,), dtype=torch.bool, device=g.device)
    more = n > 0
    while more and rounds < max_iters:
        strip = alive & (_live_degree(g, alive) <= k)
        alive = alive & ~strip
        k = torch.where(strip.any(), k, k * 2)
        rounds += 1
        more = bool(alive.any())
    return int(k), rounds


def degeneracy_parallel(g: Graph) -> Tuple[int, int]:
    """(upper bound on degeneracy, peel rounds used)."""
    return _peel(g)


def arboricity_bounds(g: Graph, exact: bool = True) -> Tuple[int, int]:
    """Return (lower, upper) bounds on arboricity λ.

    With ``exact`` degeneracy d: ceil((d+1)/2) ≤ λ ≤ d; otherwise d is the
    doubling peel's bound.
    """
    d = degeneracy_sequential(g) if exact else degeneracy_parallel(g)[0]
    lo = (d + 1 + 1) // 2
    return max(1, lo), max(1, d)


__all__ = ["degeneracy_sequential", "degeneracy_parallel", "arboricity_bounds"]
