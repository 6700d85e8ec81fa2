"""Theorem 26 / Algorithm 4: the degree-cap reduction.

Vertices with positive degree > ``8(1+ε)/ε · λ`` become singleton clusters;
PIVOT runs on the remaining bounded-degree subgraph (max degree O(λ/ε));
the union is a ``max{1+ε, 3}``-approximation. With ε = 2 this is the
paper's headline 3-approximation (Corollary 28): threshold 12λ.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .graph import Graph
from .pivot import PivotResult, pivot


def degree_threshold(lam: int, eps: float) -> float:
    return 8.0 * (1.0 + eps) / eps * lam


@dataclasses.dataclass
class CappedResult:
    labels: np.ndarray
    high_mask: np.ndarray        # singleton'd high-degree vertices
    threshold: float
    inner: Optional[PivotResult]


def degree_capped_pivot(g: Graph, lam: int, key, eps: float = 2.0,
                        engine: str = "rounds") -> CappedResult:
    """Algorithm 4 with A = PIVOT (Corollary 28), on ``g``'s device."""
    if engine == "phased":
        raise NotImplementedError(
            "engine='phased' (Algorithm 1) is not ported yet: ROADMAP A14")
    thresh = degree_threshold(lam, eps)
    high_t = g.deg > thresh
    res = pivot(g, key, engine=engine, eligible=~high_t)
    return CappedResult(labels=res.labels, high_mask=high_t.cpu().numpy(),
                        threshold=thresh, inner=res)


__all__ = ["degree_threshold", "CappedResult", "degree_capped_pivot"]
