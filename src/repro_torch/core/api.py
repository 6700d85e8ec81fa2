"""Public correlation-clustering API: the paper's algorithms, composed.

``correlation_cluster`` is the per-graph entry point and the oracle of the
batch engine. Ported methods:

* ``pivot``     — Corollary 28: degree cap (Thm 26, ε) + PIVOT (3-approx in
                  expectation). The paper's headline algorithm.
* ``pivot_raw`` — PIVOT without the degree cap (baseline comparator).

The other methods of the reference raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.util import DeviceLike, resolve_device

from . import rng as _rng
from .arboricity import arboricity_bounds
from .cost import clustering_cost
from .degree_cap import degree_capped_pivot
from .graph import Graph, build_graph
from .pivot import pivot

# Reference methods not ported yet, and the ROADMAP item that ports them.
NOT_PORTED = {
    "pivot_phased": "A14",
    "precluster": "A10",
    "forest_exact": "A15",
    "forest_approx": "A15",
    "cliques": "A15",
}


@dataclasses.dataclass
class ClusterResult:
    labels: np.ndarray
    cost: int
    method: str
    info: dict


def sample_keys(key, num_samples: int) -> list:
    """Best-of-k key schedule shared by the single and batch engines.

    ``num_samples <= 1`` uses the caller's key untouched; otherwise each
    sample folds its index in.
    """
    if num_samples <= 1:
        return [key]
    return [_rng.fold_in(key, i) for i in range(num_samples)]


def _on_device(g: Graph, device: DeviceLike) -> Graph:
    return g.to(resolve_device(device))


def correlation_cluster(
    g: Graph | np.ndarray,
    n: Optional[int] = None,
    method: str = "pivot",
    eps: float = 2.0,
    lam: Optional[int] = None,
    key=None,
    num_samples: int = 1,
    device: DeviceLike = None,
) -> ClusterResult:
    """Cluster a complete signed graph given its positive edges.

    Args:
      g: a :class:`Graph` or an (m, 2) positive edge array (then pass ``n``).
      lam: arboricity of E⁺; estimated via degeneracy if omitted.
      eps: Theorem 26 ε (ε=2 reproduces the paper's 3-approx threshold 12λ).
      key: a key of two 32-bit words (:func:`repro_torch.core.rng.PRNGKey`);
        defaults to ``PRNGKey(0)``.
      num_samples: best-of-k — run ``k`` permutations (keys
        ``fold_in(key, i)``) and keep the lowest-cost clustering; the first
        minimum wins.
      device: where the work runs; ``None`` means CUDA (see
        :func:`repro_torch.util.resolve_device`).
    """
    if method in NOT_PORTED:
        raise NotImplementedError(
            f"method {method!r} is not ported yet: ROADMAP "
            f"{NOT_PORTED[method]}")
    if method not in ("pivot", "pivot_raw"):
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{tuple(sorted(('pivot', 'pivot_raw', *NOT_PORTED)))}")
    if isinstance(g, Graph):
        g = _on_device(g, device)
    else:
        if n is None:
            raise ValueError("pass n with a raw edge array")
        g = build_graph(n, g, device=device)
    key = key if key is not None else _rng.PRNGKey(0)
    info: dict = {}

    if lam is None and method == "pivot":
        lo, hi = arboricity_bounds(g, exact=g.n <= 200_000)
        lam = hi  # degeneracy upper bound; only moves the O(λ/ε) constant
        info["lambda_estimate"] = (lo, hi)

    def run_once(k):
        if method == "pivot_raw":
            res = pivot(g, k, engine="rounds")
            return res.labels, {"depth": res.depth}
        res = degree_capped_pivot(g, lam=lam, key=k, eps=eps)
        return res.labels, {
            "threshold": res.threshold,
            "high_degree": int(res.high_mask.sum()),
            "depth": res.inner.depth,
        }

    best = None
    for i, k in enumerate(sample_keys(key, num_samples)):
        labels_i, info_i = run_once(k)
        cost_i = clustering_cost(g, labels_i)
        if best is None or cost_i < best[0]:
            best = (cost_i, labels_i, info_i, i)
    cost, labels, run_info, picked = best
    info.update(run_info)
    if num_samples > 1:
        info.update(num_samples=num_samples, picked_sample=picked)
    return ClusterResult(labels=np.asarray(labels), cost=cost, method=method,
                         info=info)


# Batched multi-graph engine (see core/batch.py). Imported at the bottom:
# batch.py pulls ClusterResult from this module.
from .batch import correlation_cluster_batch  # noqa: E402

__all__ = ["ClusterResult", "correlation_cluster",
           "correlation_cluster_batch", "sample_keys"]
