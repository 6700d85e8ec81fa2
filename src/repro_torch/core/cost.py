"""Disagreement cost, the min-max objective, brute-force optimum and the
Lemma 25 transform.

Cost convention (paper §1.3.2): for a clustering C of the complete signed
graph whose positive edges are ``E⁺``,

  cost(C) = |{(u,v) ∈ E⁺ : C(u) != C(v)}|                (positive disagr.)
          + Σ_cluster [ (|C| choose 2) − intra_positive(C) ]  (negative disagr.)

The cost is computed with torch ops on the graph's device. Sums are int64,
so the count is exact for every size (the reference's int32 sums agree
wherever they do not overflow, which the batch engine's ``R ≤ 2¹⁵`` bound
guarantees). :func:`canonicalize`, :func:`brute_force_opt` and
:func:`lemma25_transform` are host numpy, as in the reference.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .graph import Graph


def _cost_parts(g: Graph, labels) -> Tuple[int, int]:
    n = g.n
    if n == 0:
        return 0, 0
    labels = torch.as_tensor(np.asarray(labels), dtype=torch.int64).to(g.device)
    src, dst = g.src.long(), g.dst.long()
    valid = src < n  # mask COO padding
    same = (labels[src.clamp(max=n - 1)] == labels[dst.clamp(max=n - 1)]) & valid
    # COO holds both directions: each undirected edge counted twice.
    intra_pos = same.sum() // 2
    pos_disagree = valid.sum() // 2 - intra_pos
    sizes = torch.zeros((n,), dtype=torch.int64, device=g.device)
    sizes.scatter_add_(0, labels, torch.ones_like(labels))
    neg_disagree = (sizes * (sizes - 1) // 2).sum() - intra_pos
    return int(pos_disagree), int(neg_disagree)


def clustering_cost(g: Graph, labels) -> int:
    """Total disagreements of ``labels`` (any integer cluster ids in [0, n))."""
    pos, neg = _cost_parts(g, labels)
    return pos + neg


def clustering_cost_split(g: Graph, labels) -> Tuple[int, int]:
    """(positive, negative) disagreements of ``labels``."""
    return _cost_parts(g, labels)


def minmax_cost(g: Graph, labels) -> int:
    """Worst-vertex disagreement (min-max objective, arXiv 2502.12519).

    Per vertex v: its cut positive edges plus its missing intra-cluster
    positive edges; the clustering is scored by the *maximum* over
    vertices instead of the sum. Numpy host oracle over the full graph,
    the full-graph counterpart of the device cost pass in
    :mod:`repro_torch.core.programs` (which scores the eligible-induced
    capped subgraph; the two agree when the degree cap drops nothing).
    """
    from .programs import minmax_cost_host

    return minmax_cost_host(g.n, g.undirected_edges(), labels)


def canonicalize(labels) -> np.ndarray:
    """Relabel clusters as first-occurrence indices (for comparisons)."""
    labels = np.asarray(labels)
    _, inv = np.unique(labels, return_inverse=True)
    return inv.astype(np.int32)


# ---------------------------------------------------------------------------
# Brute-force optimum (tiny n): enumerate set partitions via restricted
# growth strings (recursive).
# ---------------------------------------------------------------------------


def brute_force_opt(g: Graph, max_n: int = 10) -> Tuple[int, np.ndarray]:
    """Exact minimum-disagreement clustering by exhaustive enumeration."""
    n = g.n
    if n > max_n:
        raise ValueError(f"brute force limited to n <= {max_n}, got {n}")
    und = g.undirected_edges()
    adj = np.zeros((n, n), dtype=bool)
    for u, v in und:
        adj[u, v] = adj[v, u] = True

    best_cost, best = None, None
    a = np.zeros(n, dtype=np.int32)

    def rec(i: int, kmax: int):
        nonlocal best_cost, best
        if i == n:
            cost = 0
            for u in range(n):
                for v in range(u + 1, n):
                    same = a[u] == a[v]
                    if adj[u, v] and not same:
                        cost += 1
                    elif (not adj[u, v]) and same:
                        cost += 1
            if best_cost is None or cost < best_cost:
                best_cost, best = cost, a.copy()
            return
        for c in range(kmax + 1):
            a[i] = c
            rec(i + 1, max(kmax, c + 1))

    rec(0, 0)
    return int(best_cost), best


# ---------------------------------------------------------------------------
# Lemma 25: local-update transform. Repeatedly eject a vertex v* with
# d_C⁺(v*) ≤ 2λ−1 from any cluster of size ≥ 4λ−1; cost never increases.
# ---------------------------------------------------------------------------


def lemma25_transform(g: Graph, labels, lam: int) -> np.ndarray:
    """Apply the Lemma 25 local updates until all clusters have ≤ 4λ−2
    vertices. Returns new labels; asserts the invariant the lemma proves,
    that a cluster above that size holds a vertex of inner degree ≤ 2λ−1.
    """
    n = g.n
    labels = canonicalize(np.asarray(labels).copy())
    und = g.undirected_edges()
    adj: list[set[int]] = [set() for _ in range(n)]
    for u, v in und:
        adj[u].add(int(v))
        adj[v].add(int(u))

    next_label = int(labels.max()) + 1 if n else 0
    changed = True
    while changed:
        changed = False
        members: dict[int, list[int]] = {}
        for v in range(n):
            members.setdefault(int(labels[v]), []).append(v)
        for c, vs in members.items():
            if len(vs) <= 4 * lam - 2:
                continue
            cset = set(vs)
            vstar = None
            for v in vs:
                if len(adj[v] & cset) <= 2 * lam - 1:
                    vstar = v
                    break
            assert vstar is not None, (
                "Lemma 25 guarantees a low-internal-degree vertex in any "
                f"cluster of size {len(vs)} > 4λ−2 (λ={lam})"
            )
            labels[vstar] = next_label
            next_label += 1
            changed = True
            break
    return canonicalize(labels)


__all__ = ["clustering_cost", "clustering_cost_split", "minmax_cost",
           "canonicalize", "brute_force_opt", "lemma25_transform"]
