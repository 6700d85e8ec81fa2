"""Public correlation-clustering API: the paper's algorithms, composed.

``correlation_cluster`` is the per-graph entry point and the oracle of the
batch engine. Methods:

* ``pivot``         — Corollary 28: degree cap (Thm 26, ε) + PIVOT
                      (3-approx in expectation). The paper's headline
                      algorithm.
* ``pivot_phased``  — the same, inner engine Algorithm 1 (phase/chunk
                      scheduling with the MPC round ledger).
* ``pivot_raw``     — PIVOT without the degree cap (baseline comparator).
* ``precluster``    — constant-round neighbourhood-agreement
                      pre-clustering (arXiv 2106.08448); the per-graph
                      counterpart of the batch engine's ``'precluster'``
                      bucket program.
* ``forest_exact``  — Corollary 27/31(1): maximum matching (λ=1 inputs).
* ``forest_approx`` — Lemma 29/Cor 31(2,3): maximal matching + length-3
                      augmentation passes.
* ``cliques``       — Corollary 32: deterministic O(λ²), O(1) rounds.

``distributed=True`` runs the PIVOT methods on the edge-sharded engine of
:mod:`repro_torch.core.dist` over a ``torch.distributed`` group.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.util import DeviceLike, resolve_device

from . import forest as forest_mod
from . import rng as _rng
from .arboricity import arboricity_bounds
from .cliques import clique_clustering
from .cost import clustering_cost
from .degree_cap import degree_capped_pivot, degree_threshold, high_degree
from .dist import distributed_pivot
from .graph import Graph, build_graph
from .mis import random_permutation_ranks
from .pivot import _pivot_samples

PORTED = ("pivot", "pivot_phased", "pivot_raw", "precluster",
          "forest_exact", "forest_approx", "cliques")
# Reference methods not ported yet, and the ROADMAP item that ports them.
NOT_PORTED: dict = {}


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
    distributed: bool = False,
    group=None,
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
      distributed: run the PIVOT methods on the edge-sharded engine
        (:func:`repro_torch.core.dist.distributed_pivot`) over ``group``;
        every rank of the group makes the same call. ``pivot_phased``
        then runs as ``pivot``, as in the reference.
    """
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

    if lam is None and method in ("pivot", "pivot_phased", "cliques",
                                  "precluster"):
        lo, hi = arboricity_bounds(g, exact=g.n <= 200_000)
        lam = hi  # degeneracy upper bound; only moves the O(λ/ε) constant
        info["lambda_estimate"] = (lo, hi)

    if method == "precluster":
        return _precluster(g, key, num_samples, eps, lam, info)
    if method in ("pivot", "pivot_phased", "pivot_raw"):
        return _pivot_method(g, method, key, num_samples, eps, lam, info,
                             distributed, group)

    if method == "forest_exact":
        partner = forest_mod.max_matching_forest(g)
        labels = forest_mod.clustering_from_matching(partner)
        info["matching_size"] = forest_mod.matching_size(partner)
    elif method == "forest_approx":
        partner, rounds = forest_mod.augmenting_matching_parallel(g, key)
        labels = forest_mod.clustering_from_matching(partner)
        info.update(matching_size=forest_mod.matching_size(partner),
                    rounds=rounds)
    else:   # cliques
        labels = clique_clustering(g).cpu().numpy()
    return ClusterResult(labels=np.asarray(labels),
                         cost=clustering_cost(g, labels), method=method,
                         info=info)


def _pivot_method(g: Graph, method: str, key, num_samples: int, eps: float,
                  lam: Optional[int], info: dict, distributed: bool,
                  group) -> ClusterResult:
    """The PIVOT methods, best-of-k with the first minimum winning.

    ``pivot`` and ``pivot_raw`` on one device draw every sample's ranks in
    one batched call and run them in one launch of kernel B3; the phased
    and distributed engines run one sample at a time, as the reference
    does.
    """
    keys = sample_keys(key, num_samples)
    if not distributed and method in ("pivot", "pivot_raw"):
        if method == "pivot_raw":
            labels_k, _, depth = _pivot_samples(g, keys)
            run_info = {}
        else:   # Theorem 26: vertices above the degree threshold stay alone
            high, thresh = high_degree(g, lam, eps)
            labels_k, _, depth = _pivot_samples(g, keys, eligible=~high)
            run_info = {"threshold": thresh, "high_degree": int(high.sum())}
        runs = [(labels_i, dict(run_info, depth=int(d)))
                for labels_i, d in zip(labels_k, depth)]
    else:
        runs = [_pivot_once(g, method, k, eps, lam, distributed, group)
                for k in keys]
    costs = [clustering_cost(g, labels_i) for labels_i, _ in runs]
    picked = costs.index(min(costs))        # the first minimum wins
    labels, run_info = runs[picked]
    info.update(run_info)
    if num_samples > 1:
        info.update(num_samples=num_samples, picked_sample=picked)
    return ClusterResult(labels=np.asarray(labels), cost=costs[picked],
                         method=method, info=info)


def _pivot_once(g: Graph, method: str, key, eps: float, lam: Optional[int],
                distributed: bool, group):
    """One sample of the distributed or the phased engine: (labels,
    run_info) with the reference's info keys."""
    if distributed:
        ranks = random_permutation_ranks(g.n, key, device=g.device)
        if method == "pivot_raw":
            labels, _, rounds = distributed_pivot(g, ranks, group=group)
            return labels, {"depth": rounds}
        thresh = degree_threshold(lam, eps)
        high = g.deg.cpu().numpy() > thresh
        labels, _, rounds = _distributed_capped(g, ranks, high, group=group)
        return labels, {"depth": rounds, "threshold": thresh,
                        "high_degree": int(high.sum())}
    res = degree_capped_pivot(g, lam=lam, key=key, eps=eps, engine="phased")
    ledger = res.inner.ledger
    return res.labels, {"threshold": res.threshold,
                        "high_degree": int(res.high_mask.sum()),
                        "depth": res.inner.depth,
                        "mpc_rounds": ledger.total_rounds,
                        "ledger": ledger.summary()}


def _distributed_capped(g: Graph, ranks, high: np.ndarray, group=None,
                        packed: bool = False):
    """Degree-capped PIVOT on the distributed engine: drop the edges
    incident to high-degree vertices on the device (the original
    ``row_offsets`` and ``deg`` stay), then run; high vertices are
    singletons."""
    n = g.n
    high_t = torch.from_numpy(high).to(g.device)
    src, dst = g.src.long(), g.dst.long()
    keep = (src < n) & ~high_t[src.clamp(max=n - 1)] \
        & ~high_t[dst.clamp(max=n - 1)]
    pad = torch.full_like(g.src, n)
    g2 = dataclasses.replace(g, src=torch.where(keep, g.src, pad),
                             dst=torch.where(keep, g.dst, pad))
    labels, in_mis, rounds = distributed_pivot(g2, ranks, group=group,
                                               packed=packed)
    labels = np.where(high, np.arange(n, dtype=np.int32), labels)
    return labels, in_mis, rounds


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
