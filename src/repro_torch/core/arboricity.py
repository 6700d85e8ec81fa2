"""Arboricity bounds via degeneracy peeling (host).

The degeneracy ``d`` of a graph satisfies ``λ ≤ d ≤ 2λ − 1``
(Nash–Williams), so it is a 2-approximation of arboricity usable in the
Algorithm 4 degree threshold; only the constant in ``O(λ/ε)`` moves.

:func:`degeneracy_sequential` is the exact min-degree peeling with a heap.
The round-parallel doubling peel of the reference (``degeneracy_parallel``)
is not ported yet (ROADMAP A14); callers that know λ pass it.
"""

from __future__ import annotations

import heapq
from typing import Tuple

import numpy as np

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


def arboricity_bounds(g: Graph, exact: bool = True) -> Tuple[int, int]:
    """Return (lower, upper) bounds on arboricity λ.

    With exact degeneracy d: ceil((d+1)/2) ≤ λ ≤ d.
    """
    if not exact:
        raise NotImplementedError(
            "the parallel degeneracy peel is not ported yet (ROADMAP A14); "
            "pass lam or use exact=True")
    d = degeneracy_sequential(g)
    lo = (d + 1 + 1) // 2
    return max(1, lo), max(1, d)


__all__ = ["degeneracy_sequential", "arboricity_bounds"]
