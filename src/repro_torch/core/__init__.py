"""Core library: the paper's correlation-clustering algorithms in PyTorch.

Layout (each module mirrors its namesake in ``repro.core``):
  graph.py       — containers + generators (COO/CSR, padded)
  rng.py         — threefry keys and permutations, bit-identical to jax
  mis.py         — randomized greedy MIS (oracle, round-parallel, capture)
  pivot.py       — PIVOT clustering engines
  degree_cap.py  — Theorem 26 / Algorithm 4 reduction
  arboricity.py  — degeneracy peeling bounds on λ
  cost.py        — disagreement cost
  plan.py        — batch-engine host side: bucketing, ELL packing
  programs.py    — bucket programs: rounds body, cost pass, argmin
  executor.py    — batch-engine device side: the sync executor
  batch.py       — `correlation_cluster_batch` entry point
  api.py         — `correlation_cluster` public entry point
"""

from .api import ClusterResult, correlation_cluster, correlation_cluster_batch
from .arboricity import arboricity_bounds, degeneracy_sequential
from .cost import clustering_cost, clustering_cost_split
from .degree_cap import degree_capped_pivot, degree_threshold
from .executor import InFlightBucket, SyncExecutor, make_executor
from .graph import Graph, build_graph
from .mis import greedy_mis_parallel, random_permutation_ranks
from .pivot import pivot
from .plan import (
    GraphPlan,
    PackedRows,
    PackStats,
    build_packed_rows,
    estimate_pack_stats,
    pack_bucket,
    plan_graph,
    promote_plan,
)
from .rng import PRNGKey, fold_in

__all__ = [
    "ClusterResult",
    "correlation_cluster",
    "correlation_cluster_batch",
    "arboricity_bounds",
    "degeneracy_sequential",
    "clustering_cost",
    "clustering_cost_split",
    "degree_capped_pivot",
    "degree_threshold",
    "InFlightBucket",
    "SyncExecutor",
    "make_executor",
    "Graph",
    "build_graph",
    "greedy_mis_parallel",
    "random_permutation_ranks",
    "pivot",
    "GraphPlan",
    "PackedRows",
    "PackStats",
    "build_packed_rows",
    "estimate_pack_stats",
    "pack_bucket",
    "plan_graph",
    "promote_plan",
    "PRNGKey",
    "fold_in",
]
