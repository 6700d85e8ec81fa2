"""Public correlation-clustering API: the paper's algorithms, composed.

``correlation_cluster`` is the per-graph entry point and the oracle of the
batch engine. Ported methods:

* ``pivot``     — Corollary 28: degree cap (Thm 26, ε) + PIVOT (3-approx in
                  expectation). The paper's headline algorithm.
* ``pivot_raw`` — PIVOT without the degree cap (baseline comparator).
* ``precluster`` — constant-round neighbourhood-agreement pre-clustering
                  (arXiv 2106.08448); the per-graph counterpart of the
                  batch engine's ``'precluster'`` bucket program.

The other methods of the reference raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.util import DeviceLike, resolve_device

from . import rng as _rng
from .arboricity import arboricity_bounds
from .cost import clustering_cost
from .degree_cap import high_degree
from .graph import Graph, build_graph
from .pivot import _pivot_samples

PORTED = ("pivot", "pivot_raw", "precluster")
# Reference methods not ported yet, and the ROADMAP item that ports them.
NOT_PORTED = {
    "pivot_phased": "A14",
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
    if method not in PORTED:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{tuple(sorted((*PORTED, *NOT_PORTED)))}")
    if isinstance(g, Graph):
        g = _on_device(g, device)
    else:
        if n is None:
            raise ValueError("pass n with a raw edge array")
        g = build_graph(n, g, device=device)
    key = key if key is not None else _rng.PRNGKey(0)
    info: dict = {}

    if lam is None and method in ("pivot", "precluster"):
        lo, hi = arboricity_bounds(g, exact=g.n <= 200_000)
        lam = hi  # degeneracy upper bound; only moves the O(λ/ε) constant
        info["lambda_estimate"] = (lo, hi)

    if method == "precluster":
        return _precluster(g, key, num_samples, eps, lam, info)

    # Every sample's PIVOT in one batched rank draw and one kernel launch.
    keys = sample_keys(key, num_samples)
    if method == "pivot_raw":
        labels_k, _, depth = _pivot_samples(g, keys)
        run_info = {}
    else:   # Theorem 26: vertices above the degree threshold stay alone
        high, thresh = high_degree(g, lam, eps)
        labels_k, _, depth = _pivot_samples(g, keys, eligible=~high)
        run_info = {"threshold": thresh, "high_degree": int(high.sum())}

    costs = [clustering_cost(g, labels_i) for labels_i in labels_k]
    picked = costs.index(min(costs))        # the first minimum wins
    info.update(run_info, depth=int(depth[picked]))
    if num_samples > 1:
        info.update(num_samples=num_samples, picked_sample=picked)
    return ClusterResult(labels=np.asarray(labels_k[picked]),
                         cost=costs[picked], method=method, info=info)


def _precluster(g: Graph, key, num_samples: int, eps: float, lam: int,
                info: dict) -> ClusterResult:
    """``method='precluster'``: the registered bucket program on the
    graph's device, one batch entry per sample (so B1 runs on the card),
    the sample picked by the full-graph disagreement cost, first minimum.

    The reference runs the host oracle ``precluster_host`` per sample on
    the same plan and ranks; labels, cost and info equal its.
    """
    from .plan import build_packed_rows, plan_graph
    from .programs import _precluster_rounds_body

    plan = plan_graph(g, method="precluster", eps=eps, lam=lam)
    keys = sample_keys(key, num_samples)
    rows = build_packed_rows(plan, keys)
    k, dev = len(keys), g.device
    ell = torch.from_numpy(rows.ell).to(dev).expand(k, -1, -1).contiguous()
    elig = torch.from_numpy(rows.elig).to(dev).expand(k, -1).contiguous()
    ranks = torch.from_numpy(rows.ranks).to(dev)
    labels_k, rounds_k = _precluster_rounds_body(ell, ranks, elig,
                                                 replicas=k)
    labels_k = labels_k[:, : g.n].cpu().numpy()
    rounds_k = rounds_k.cpu().tolist()
    costs = [clustering_cost(g, labels_i) for labels_i in labels_k]
    picked = costs.index(min(costs))        # the first minimum wins
    info.update(depth=rounds_k[picked], threshold=plan.threshold,
                high_degree=int((~plan.eligible).sum()))
    if num_samples > 1:
        info.update(num_samples=num_samples, picked_sample=picked)
    return ClusterResult(labels=labels_k[picked], cost=costs[picked],
                         method="precluster", info=info)


# Batched multi-graph engine (see core/batch.py). Imported at the bottom:
# batch.py pulls ClusterResult from this module.
from .batch import correlation_cluster_batch  # noqa: E402

__all__ = ["ClusterResult", "correlation_cluster",
           "correlation_cluster_batch", "sample_keys"]
