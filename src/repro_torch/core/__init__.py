"""Core library: the paper's correlation-clustering algorithms in PyTorch.

Layout (each module mirrors its namesake in ``repro.core``):
  graph.py       — containers + generators (COO/CSR, padded)
  rng.py         — threefry keys and permutations, bit-identical to jax
  mis.py         — randomized greedy MIS (oracle, round-parallel, capture)
  phases.py      — Algorithm 1/2/3 scheduling + MPC round ledger
  pivot.py       — PIVOT clustering engines
  degree_cap.py  — Theorem 26 / Algorithm 4 reduction
  forest.py      — λ=1 matching suite (Cor 27/31, Lemma 29)
  cliques.py     — Corollary 32 O(λ²)-approx + connected components
  arboricity.py  — degeneracy peeling bounds on λ
  cost.py        — disagreement cost, min-max objective, brute-force OPT,
                   Lemma 25 transform
  dist.py        — edge-sharded engine over torch.distributed (MPC ⇒
                   process group)
  plan.py        — batch-engine host side: bucketing, ELL packing,
                   fingerprints, staging leases
  programs.py    — bucket programs: rounds bodies, cost passes, argmin
  executor.py    — batch-engine device side: program registry,
                   sync/async/sharded bucket executors
  batch.py       — `correlation_cluster_batch` entry point
  api.py         — `correlation_cluster` public entry point
"""

from .api import ClusterResult, correlation_cluster, correlation_cluster_batch
from .arboricity import (
    arboricity_bounds,
    degeneracy_parallel,
    degeneracy_sequential,
)
from .cliques import clique_clustering, connected_components
from .cost import (
    brute_force_opt,
    clustering_cost,
    clustering_cost_split,
    lemma25_transform,
    minmax_cost,
)
from .degree_cap import degree_capped, degree_capped_pivot, degree_threshold
from .dist import distributed_pivot, edge_shard_mesh, pow2_device_mesh
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
from .forest import (
    augmenting_matching_parallel,
    clustering_from_matching,
    matching_size,
    max_matching_forest,
    maximal_matching_parallel,
)
from .graph import Graph, build_graph
from .mis import (
    dependency_depth,
    greedy_mis_parallel,
    greedy_mis_sequential,
    pivot_sequential,
    random_permutation_ranks,
    random_permutation_ranks_batch,
)
from .phases import RoundLedger, algorithm1, remaining_max_degree_after_prefix
from .pivot import PivotResult, pivot
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
    "degeneracy_parallel",
    "degeneracy_sequential",
    "clique_clustering",
    "connected_components",
    "brute_force_opt",
    "clustering_cost",
    "clustering_cost_split",
    "lemma25_transform",
    "minmax_cost",
    "degree_capped",
    "degree_capped_pivot",
    "degree_threshold",
    "distributed_pivot",
    "edge_shard_mesh",
    "pow2_device_mesh",
    "augmenting_matching_parallel",
    "clustering_from_matching",
    "max_matching_forest",
    "maximal_matching_parallel",
    "matching_size",
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
    "dependency_depth",
    "greedy_mis_parallel",
    "greedy_mis_sequential",
    "pivot_sequential",
    "random_permutation_ranks",
    "random_permutation_ranks_batch",
    "RoundLedger",
    "algorithm1",
    "remaining_max_degree_after_prefix",
    "PivotResult",
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
