"""Core library: the paper's correlation-clustering algorithms in PyTorch.

Layout (each module mirrors its namesake in ``repro.core``):
  graph.py       — containers + generators (COO/CSR, padded)
  rng.py         — threefry keys and permutations, bit-identical to jax
  mis.py         — randomized greedy MIS (oracle, round-parallel, capture)
  pivot.py       — PIVOT clustering engines
  degree_cap.py  — Theorem 26 / Algorithm 4 reduction
  arboricity.py  — degeneracy peeling bounds on λ
  cost.py        — disagreement cost, min-max objective
  plan.py        — batch-engine host side: bucketing, ELL packing,
                   fingerprints, staging leases
  programs.py    — bucket programs: rounds bodies, cost passes, argmin
  executor.py    — batch-engine device side: program registry,
                   sync/async/sharded bucket executors
  batch.py       — `correlation_cluster_batch` entry point
  api.py         — `correlation_cluster` public entry point
"""

from .api import ClusterResult, correlation_cluster, correlation_cluster_batch
from .arboricity import arboricity_bounds, degeneracy_sequential
from .cost import clustering_cost, clustering_cost_split, minmax_cost
from .degree_cap import degree_capped_pivot, degree_threshold
from .executor import (
    AsyncExecutor,
    BucketExecutor,
    InFlightBucket,
    ShardedExecutor,
    SyncExecutor,
    make_executor,
    program_cache_contains,
    program_cache_info,
    program_cache_pin,
    program_cache_size,
    program_cache_touch,
    program_cache_unpin,
    set_program_cache_capacity,
)
from .graph import Graph, build_graph
from .mis import greedy_mis_parallel, random_permutation_ranks
from .pivot import pivot
from .plan import (
    BucketBufferPool,
    GraphFingerprint,
    GraphPlan,
    PackedRows,
    PackStats,
    build_packed_rows,
    estimate_pack_stats,
    graph_fingerprint,
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
    "minmax_cost",
    "degree_capped_pivot",
    "degree_threshold",
    "AsyncExecutor",
    "BucketExecutor",
    "InFlightBucket",
    "ShardedExecutor",
    "SyncExecutor",
    "make_executor",
    "program_cache_contains",
    "program_cache_info",
    "program_cache_pin",
    "program_cache_size",
    "program_cache_touch",
    "program_cache_unpin",
    "set_program_cache_capacity",
    "Graph",
    "build_graph",
    "greedy_mis_parallel",
    "random_permutation_ranks",
    "pivot",
    "BucketBufferPool",
    "GraphFingerprint",
    "GraphPlan",
    "PackedRows",
    "PackStats",
    "build_packed_rows",
    "estimate_pack_stats",
    "graph_fingerprint",
    "pack_bucket",
    "plan_graph",
    "promote_plan",
    "PRNGKey",
    "fold_in",
]
