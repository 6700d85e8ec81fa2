"""Batched multi-graph PIVOT engine — the public entry point.

The batch engine packs many small graphs into **shape buckets** and runs
each bucket through one device program, so a bucket of hundreds of graphs
costs one MIS rounds loop instead of hundreds.

* :mod:`repro_torch.core.plan` — host side: ``plan_graph`` bucketing and
  the ``pack_bucket`` ELL packer with ``PackStats`` accounting.
* :mod:`repro_torch.core.executor` — device side: the bucket program
  (rounds body × cost pass × best-of-k) and the ``SyncExecutor``.

Bit-exactness contract: for the same per-graph key,
``correlation_cluster_batch`` returns labels, costs, picked sample indices
and rounds **bit-identical** to per-graph ``correlation_cluster``, and to
the reference engine.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.util import DeviceLike, resolve_device

from .executor import InFlightBucket, make_executor, pack_and_submit
from .graph import Graph
from .plan import PackStats, plan_graph, result_for_plan


def _cost_host(g: Graph, labels: np.ndarray) -> int:
    """Disagreement cost, integer-exact numpy (the oracle of the device pass)."""
    und = g.undirected_edges()
    intra_pos = int((labels[und[:, 0]] == labels[und[:, 1]]).sum()) \
        if len(und) else 0
    pos_disagree = g.m - intra_pos
    sizes = np.bincount(labels, minlength=g.n)
    intra_pairs = int((sizes.astype(np.int64) * (sizes - 1) // 2).sum())
    return pos_disagree + (intra_pairs - intra_pos)


def correlation_cluster_batch(
    graphs: Sequence[Graph],
    keys: Optional[Sequence] = None,
    method: str = "pivot",
    eps: float = 2.0,
    lams: Optional[Sequence[Optional[int]]] = None,
    num_samples: int = 1,
    with_stats: bool = False,
    executor=None,
    objective: str = "disagree",
    device: DeviceLike = None,
):
    """Cluster many graphs through the shape-bucketed batch engine.

    Args:
      graphs: the positive-edge graphs (``Graph`` instances); a graph on
        another device than ``device`` is moved there.
      keys: per-graph keys (a single key is broadcast to all; defaults to
        ``PRNGKey(0)`` like the per-graph api).
      method: ``'pivot'`` (degree-capped, Corollary 28) or ``'pivot_raw'``.
      objective: ``'disagree'``, the total disagreement count.
      lams: optional per-graph arboricity bounds (estimated when omitted).
      num_samples: best-of-k — each graph is clustered under ``k`` folded
        keys in the same bucket and the lowest-cost replica is selected on
        the device, matching ``correlation_cluster(num_samples=k)``
        bit-exactly (including the picked sample index).
      with_stats: also return the packer's :class:`PackStats`.
      executor: ``'sync'``, a :class:`SyncExecutor`, or None (sync).
      device: where the work runs; ``None`` means CUDA.

    Returns one :class:`repro_torch.core.api.ClusterResult` per graph.
    """
    from .api import _on_device, sample_keys  # deferred: api imports us
    from .programs import objective_spec
    from . import rng as _rng

    objective_spec(objective)
    if num_samples < 1:
        raise ValueError(
            f"num_samples must be >= 1, got {num_samples} (use 1 for a "
            "single PIVOT draw)")
    dev = resolve_device(device)
    graphs = [_on_device(g, dev) for g in graphs]
    n_graphs = len(graphs)
    stats = PackStats()
    if n_graphs == 0:
        return ([], stats) if with_stats else []
    if keys is None:
        keys = [_rng.PRNGKey(0)] * n_graphs
    elif np.ndim(keys) == 1:
        keys = [keys] * n_graphs      # one key broadcast to all graphs
    else:
        keys = list(keys)
    if len(keys) != n_graphs:
        raise ValueError(f"{len(keys)} keys for {n_graphs} graphs")
    if lams is None:
        lams = [None] * n_graphs

    k = num_samples
    ex = make_executor(executor, device=dev)
    plans = [plan_graph(g, method=method, eps=eps, lam=lam)
             for g, lam in zip(graphs, lams)]

    buckets: dict = {}
    for gi, plan in enumerate(plans):
        buckets.setdefault(plan.bucket, []).append(gi)

    handles: List[InFlightBucket] = []
    for members in buckets.values():
        bplans = [plans[gi] for gi in members]
        bkeys = [sample_keys(keys[gi], k) for gi in members]
        handle, bucket_stats = pack_and_submit(
            bplans, bkeys, k, ex, payload=(members, bplans),
            objective=objective)
        handles.append(handle)
        stats.merge(bucket_stats)

    results_by_graph: dict = {}
    for handle in handles:
        labels, costs, picked, rounds = handle.result()
        members, bplans = handle.payload
        for slot, (gi, plan) in enumerate(zip(members, bplans)):
            results_by_graph[gi] = result_for_plan(
                plan, labels[slot], int(costs[slot]), int(picked[slot]),
                int(rounds[slot]), k, method)

    results = [results_by_graph[gi] for gi in range(n_graphs)]
    return (results, stats) if with_stats else results


__all__ = ["correlation_cluster_batch"]
