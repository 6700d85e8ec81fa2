"""Theorem 26 / Algorithm 4: the degree-cap reduction.

Vertices with positive degree > ``8(1+ε)/ε · λ`` become singleton clusters;
any α-approximate algorithm A runs on the remaining bounded-degree subgraph
(max degree O(λ/ε)); the union is a ``max{1+ε, α}``-approximation. With
ε = 2 and A = PIVOT this is the paper's headline 3-approximation
(Corollary 28): threshold 12λ.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from .graph import Graph, build_graph
from .pivot import PivotResult, pivot


def degree_threshold(lam: int, eps: float) -> float:
    return 8.0 * (1.0 + eps) / eps * lam


def high_degree(g: Graph, lam: int, eps: float = 2.0):
    """Theorem 26's cut of ``g``: ``(high, threshold)``, where ``high`` is
    the bool mask, on ``g``'s device, of the vertices whose positive degree
    exceeds :func:`degree_threshold`. They stay singletons; PIVOT runs on
    the others."""
    thresh = degree_threshold(lam, eps)
    return g.deg > thresh, thresh


@dataclasses.dataclass
class CappedResult:
    labels: np.ndarray
    high_mask: np.ndarray        # singleton'd high-degree vertices
    threshold: float
    inner: Optional[PivotResult]


def degree_capped_pivot(g: Graph, lam: int, key, eps: float = 2.0,
                        engine: str = "rounds") -> CappedResult:
    """Algorithm 4 with A = PIVOT (Corollary 28), on ``g``'s device.

    ``engine='phased'`` builds the induced low-degree subgraph explicitly,
    so Algorithm 1's prefix sizes see the capped Δ' = O(λ/ε), and draws
    its ranks for the subgraph: its labels differ from ``'rounds'`` on the
    same key.
    """
    if engine == "phased":
        thresh = degree_threshold(lam, eps)
        high = g.deg.cpu().numpy() > thresh
        sub, low_ids = _low_subgraph(g, high)
        res = pivot(sub, key, engine="phased")
        labels = np.arange(g.n, dtype=np.int32)
        labels[low_ids] = low_ids[res.labels]
        in_mis = np.zeros(g.n, dtype=bool)
        in_mis[low_ids] = res.in_mis
        inner = PivotResult(labels=labels, in_mis=in_mis, depth=res.depth,
                            ledger=res.ledger)
        return CappedResult(labels=labels, high_mask=high, threshold=thresh,
                            inner=inner)
    high_t, thresh = high_degree(g, lam, eps)
    res = pivot(g, key, engine=engine, eligible=~high_t)
    return CappedResult(labels=res.labels, high_mask=high_t.cpu().numpy(),
                        threshold=thresh, inner=res)


def _low_subgraph(g: Graph, high: np.ndarray):
    """The subgraph induced by the vertices not in ``high`` (host bool
    mask), on ``g``'s device, and those vertices' ids in ``g``."""
    low_ids = np.flatnonzero(~high)
    remap = np.full(g.n, -1, dtype=np.int64)
    remap[low_ids] = np.arange(len(low_ids))
    und = g.undirected_edges()
    keep = (~high[und[:, 0]]) & (~high[und[:, 1]])
    return build_graph(len(low_ids), remap[und[keep]],
                       device=g.device), low_ids


def degree_capped(g: Graph, lam: int, eps: float,
                  inner_fn: Callable[[Graph, np.ndarray], np.ndarray]
                  ) -> CappedResult:
    """Generic Algorithm 4: ``inner_fn(subgraph, low_ids)`` returns labels in
    subgraph index space; high-degree vertices are singletons."""
    thresh = degree_threshold(lam, eps)
    high = g.deg.cpu().numpy() > thresh
    sub, low_ids = _low_subgraph(g, high)
    sub_labels = np.asarray(inner_fn(sub, low_ids))
    labels = np.arange(g.n, dtype=np.int32)
    labels[low_ids] = low_ids[sub_labels]
    return CappedResult(labels=labels, high_mask=high, threshold=thresh,
                        inner=None)


__all__ = ["degree_threshold", "high_degree", "CappedResult",
           "degree_capped_pivot", "degree_capped"]
