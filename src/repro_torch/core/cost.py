"""Disagreement cost of a clustering, and the min-max objective.

Cost convention (paper §1.3.2): for a clustering C of the complete signed
graph whose positive edges are ``E⁺``,

  cost(C) = |{(u,v) ∈ E⁺ : C(u) != C(v)}|                (positive disagr.)
          + Σ_cluster [ (|C| choose 2) − intra_positive(C) ]  (negative disagr.)

Computed with torch ops on the graph's device. Sums are int64, so the count
is exact for every size (the reference's int32 sums agree wherever they do
not overflow, which the batch engine's ``R ≤ 2¹⁵`` bound guarantees).
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


__all__ = ["clustering_cost", "clustering_cost_split", "minmax_cost"]
