"""Method registry of bucket programs + cost objectives, in torch ops.

Every clustering *method* the batch engine can run is a
:class:`BucketProgramSpec`; every *objective* it can optimise is an
:class:`ObjectiveSpec`. :func:`bucket_impl` composes ``rounds_body ×
cost_pass`` with the shared best-of-k argmin, and the executor runs it
without knowing what the method computes.

A method provides one function over the packed tensors of a bucket::

    rounds_body(ell, ranks_p, elig_p, replicas=1, nm_plan=None)
        -> (labels (B, R) int32, rounds (B,) int32)

``ell`` is the (B, R, W) int32 ELL adjacency (pad id ``R``), ``ranks_p``
the (B, R+1) int32 rank rows (slot R = INF), ``elig_p`` the (B, R+1) bool
eligibility rows (slot R False). Ineligible and padded vertices are
labelled with their own index (singletons). ``replicas`` = k says the
batch is groups of k entries with one ELL each (a bucket's best-of-k
samples, which differ only in their ranks); a body may compute what
depends on the ELL alone once a group.

An objective provides::

    cost_pass(ell, labels, m_edges, la_plan=None) -> costs (B,) int32

scored per batch entry before best-of-k selection. ``nm_plan`` and
``la_plan`` are the launch plans of B1 and B2 at the bucket's ``(B, R,
W)``, the autotuner's winners (:mod:`repro_torch.kernels.autotune`); None
lets ``launch_plan`` pick, and the CPU's plain versions ignore them.

Both neighbourhood reductions go through the kernel wrappers of
:mod:`repro_torch.kernels.neighbor_min`: the hand-written CUDA kernels for
tensors on the card, their plain versions for tensors on the CPU.

Registered methods:

* ``'pivot'`` / ``'pivot_raw'`` — the paper's MIS+PIVOT rounds loop (one
  program family: they differ only in host-side eligibility planning).
* ``'precluster'`` — constant-round pre-clustering by neighbourhood
  agreement (Cohen-Addad et al., arXiv 2106.08448): neighbours whose
  closed neighbourhoods differ by less than a constant fraction agree (one
  launch of the agreement kernel), and labels are the minimum rank reached
  over :data:`PRECLUSTER_ROUNDS` static hops of the agreement graph, each
  hop one B1 launch.

Registered objectives:

* ``'disagree'`` — total disagreement count (the paper's objective).
* ``'minmax'`` — worst-vertex disagreement (min-max correlation clustering,
  arXiv 2502.12519), scored on the *eligible-induced* (degree-capped)
  subgraph the packed tensors carry: a cap-dropped edge's disagreement is
  not attributed to its endpoints. The host oracle
  :func:`minmax_cost_host` scores whatever edge list it is given.

The numpy host oracles :func:`precluster_host` and :func:`minmax_cost_host`
are copies of the reference's: integer-only agreement math, no float
thresholds.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.kernels import agreement as _ag
from repro_torch.kernels import autotune as _autotune
from repro_torch.kernels import neighbor_min as _nm
from repro_torch.kernels.ref import BETA_DEN, BETA_NUM

from .mis import IN_MIS, INF_RANK, REMOVED, UNDECIDED

# Constant round budget of the precluster min-rank propagation.
PRECLUSTER_ROUNDS = 3


# ---------------------------------------------------------------------------
# Rounds body.
# ---------------------------------------------------------------------------


def _pivot_rounds_body(ell: torch.Tensor, ranks_p: torch.Tensor,
                       elig_p: torch.Tensor, replicas: int = 1,
                       nm_plan=None):
    """MIS rounds until no vertex is undecided, then the PIVOT capture.
    (Every step reads the ranks, so ``replicas`` changes nothing.)

    The reference's ``lax.while_loop`` is a Python loop that tests for an
    undecided vertex after every round. An entry's ``rounds`` grows only
    while it still has undecided vertices, so rounds run after an entry
    converged change nothing of it.
    """
    B, R, W = ell.shape
    dev = ell.device
    ranks = ranks_p[:, :R]
    elig = elig_p[:, :R]
    pad = torch.zeros((B, 1), dtype=torch.bool, device=dev)

    def nbr_min(active: torch.Tensor) -> torch.Tensor:
        active_p = torch.cat([active, pad], dim=1)
        return _nm.neighbor_min_ell_batch(ell, ranks_p, active_p,
                                          plan=nm_plan)

    status = torch.where(elig, UNDECIDED, REMOVED).to(torch.int32)
    rounds = torch.zeros((B,), dtype=torch.int32, device=dev)
    in_mis_code = torch.tensor(IN_MIS, dtype=torch.int32, device=dev)
    removed_code = torch.tensor(REMOVED, dtype=torch.int32, device=dev)
    und = status == UNDECIDED                # UNDECIDED ⊆ eligible
    while bool(und.any()):
        nmin = nbr_min(und)
        winners = und & (ranks < nmin)
        wmin = nbr_min(winners)
        hit = und & ~winners & (wmin < INF_RANK)
        status = torch.where(winners, in_mis_code, status)
        status = torch.where(hit, removed_code, status)
        # Per-entry done mask: finished entries stop accumulating rounds.
        rounds += und.any(dim=1).to(torch.int32)
        und = status == UNDECIDED

    # PIVOT capture: min-rank MIS neighbour, one batched convergecast.
    in_mis = status == IN_MIS
    wmin = nbr_min(in_mis)
    labels = _rank_capture(ranks, wmin, (wmin < INF_RANK) & ~in_mis, elig)
    return labels, rounds


def _rank_capture(ranks: torch.Tensor, reached: torch.Tensor,
                  mask: torch.Tensor, elig: torch.Tensor) -> torch.Tensor:
    """Labels from reached ranks: where ``mask`` holds, the vertex whose
    rank is ``reached``; elsewhere, and at ineligible vertices, the
    vertex's own index."""
    B, R = ranks.shape
    arange_r = torch.arange(R, dtype=torch.int32,
                            device=ranks.device).expand(B, R)
    # Padded rows (rank INF) all clip to slot R. Duplicate writes land only
    # there, and slot R is read only where ``reached`` is INF and then
    # discarded, so the scatter's write order cannot matter.
    rank_to_v = torch.zeros((B, R + 1), dtype=torch.int32,
                            device=ranks.device)
    rank_to_v.scatter_(1, ranks.clamp(0, R).long(), arange_r)
    lab = torch.gather(rank_to_v, 1, reached.clamp(max=R).long())
    labels = torch.where(mask, lab, arange_r)
    return torch.where(elig, labels, arange_r)


def _precluster_rounds_body(ell: torch.Tensor, ranks_p: torch.Tensor,
                            elig_p: torch.Tensor, replicas: int = 1,
                            nm_plan=None):
    """Constant-round pre-clustering by neighbourhood agreement.

    Three straight-line stages, no data-dependent loop:

    1. **Agreement pass** — common-neighbour counts of every kept edge,
       then the integer agreement predicate
       (:func:`repro_torch.kernels.agreement.agreement_ell_batch`: its
       kernel on the card, the plain version's sorted-row membership tests
       on the CPU). It depends on the ELL alone, so it runs once a group
       of ``replicas`` entries; ``B % replicas != 0`` raises.
    2. **Min-rank propagation** — :data:`PRECLUSTER_ROUNDS` static hops of
       per-vertex min over the agreement neighbourhood (kernel B1, the
       state row as its ranks, the eligibility row as its active mask),
       seeded with each vertex's own rank.
    3. **Label capture** — the reached minimum rank maps back to its
       vertex through the rank→vertex table PIVOT's capture uses.

    ``rounds`` counts the static hops that still changed some vertex.
    """
    B, R, W = ell.shape
    dev = ell.device
    ranks = ranks_p[:, :R]
    elig = elig_p[:, :R]
    agree_ell = _ag.agreement_ell_batch(ell, replicas=replicas)
    inf_col = torch.full((B, 1), INF_RANK, dtype=torch.int32, device=dev)
    state = torch.where(elig, ranks, inf_col)
    rounds = torch.zeros((B,), dtype=torch.int32, device=dev)
    for _ in range(PRECLUSTER_ROUNDS):
        state_p = torch.cat([state, inf_col], dim=1)
        nxt = torch.minimum(
            state, _nm.neighbor_min_ell_batch(agree_ell, state_p, elig_p,
                                              plan=nm_plan))
        rounds += (nxt != state).any(dim=1).to(torch.int32)
        state = nxt
    labels = _rank_capture(ranks, state, state < INF_RANK, elig)
    return labels, rounds


# ---------------------------------------------------------------------------
# Cost passes.
# ---------------------------------------------------------------------------


def _label_agree_counts(ell: torch.Tensor, labels: torch.Tensor,
                        la_plan=None) -> torch.Tensor:
    """(B, R) per-vertex same-label neighbour counts over the packed ELL."""
    B = ell.shape[0]
    labels_p = torch.cat(
        [labels, labels.new_full((B, 1), -1)], dim=1).contiguous()
    return _nm.label_agree_ell_batch(ell, labels_p, plan=la_plan)


def _cluster_sizes(labels: torch.Tensor) -> torch.Tensor:
    """(B, R) int32 cluster sizes by label (an integer scatter-add)."""
    sizes = torch.zeros_like(labels)
    return sizes.scatter_add_(1, labels.long(), torch.ones_like(labels))


def _disagree_cost_pass(ell: torch.Tensor, labels: torch.Tensor,
                        m_edges: torch.Tensor, la_plan=None) -> torch.Tensor:
    """Total disagreement count — the paper's objective.

    Every kept (eligible-induced) undirected edge appears twice in the ELL,
    so the same-label neighbour count sums to 2·intra_pos; cap-dropped
    edges are always cut (their ineligible endpoint is a singleton), so
    m_edges accounts for them exactly:
      cost = (m − intra_pos) + (intra_pairs − intra_pos).
    ``R ≤ 2¹⁵`` keeps ``sizes·(sizes−1)/2`` and every sum inside int32.
    """
    agree = _label_agree_counts(ell, labels, la_plan)
    intra_pos2 = agree.sum(dim=1, dtype=torch.int32)
    sizes = _cluster_sizes(labels)
    intra_pairs = (sizes * (sizes - 1) // 2).sum(dim=1, dtype=torch.int32)
    return m_edges - intra_pos2 + intra_pairs


def _minmax_cost_pass(ell: torch.Tensor, labels: torch.Tensor,
                      m_edges: torch.Tensor, la_plan=None) -> torch.Tensor:
    """Worst-vertex disagreement (min-max objective, arXiv 2502.12519).

    Per vertex v: cut positive edges (deg(v) − samelabel(v)) plus missing
    intra-cluster edges (|C(v)| − 1 − samelabel(v)); the entry's cost is
    the maximum over its vertices, on the eligible-induced subgraph the
    packed tensors carry (module docstring).
    """
    R = ell.shape[1]
    agree = _label_agree_counts(ell, labels, la_plan)
    deg = (ell != R).sum(dim=2, dtype=torch.int32)
    sizes = _cluster_sizes(labels)
    size_of = torch.gather(sizes, 1, labels.long())
    per_vertex = (deg - agree) + (size_of - 1 - agree)
    return per_vertex.max(dim=1).values


# ---------------------------------------------------------------------------
# Registries.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BucketProgramSpec:
    """One registered clustering method of the batch engine.

    ``program`` is the *program family*: methods that run the same device
    computation and differ only in host-side planning share one.
    ``degree_cap`` drives planning (Theorem 26 eligibility or all
    eligible).
    """

    method: str
    program: str
    rounds_body: Callable
    degree_cap: bool


@dataclasses.dataclass(frozen=True)
class ObjectiveSpec:
    """One registered cost objective, selectable orthogonally to method."""

    objective: str
    cost_pass: Callable


_METHODS: Dict[str, BucketProgramSpec] = {}
_OBJECTIVES: Dict[str, ObjectiveSpec] = {}


def register_method(spec: BucketProgramSpec) -> BucketProgramSpec:
    if spec.method in _METHODS:
        raise ValueError(f"method {spec.method!r} already registered")
    _METHODS[spec.method] = spec
    return spec


def register_objective(spec: ObjectiveSpec) -> ObjectiveSpec:
    if spec.objective in _OBJECTIVES:
        raise ValueError(f"objective {spec.objective!r} already registered")
    _OBJECTIVES[spec.objective] = spec
    return spec


def registered_methods() -> Tuple[str, ...]:
    return tuple(sorted(_METHODS))


def registered_objectives() -> Tuple[str, ...]:
    return tuple(sorted(_OBJECTIVES))


def method_spec(method: str) -> BucketProgramSpec:
    try:
        return _METHODS[method]
    except KeyError:
        raise ValueError(
            f"batch engine supports methods {registered_methods()}, "
            f"got {method!r}") from None


def objective_spec(objective: str) -> ObjectiveSpec:
    try:
        return _OBJECTIVES[objective]
    except KeyError:
        raise ValueError(
            f"batch engine supports objectives {registered_objectives()}, "
            f"got {objective!r}") from None


# Degree-capped MIS+PIVOT (Corollary 28, the paper's headline algorithm)
# and PIVOT without the cap (baseline comparator): one program family.
register_method(BucketProgramSpec(
    method="pivot", program="pivot", rounds_body=_pivot_rounds_body,
    degree_cap=True))
register_method(BucketProgramSpec(
    method="pivot_raw", program="pivot", rounds_body=_pivot_rounds_body,
    degree_cap=False))
# Constant-round neighbourhood-agreement pre-clustering (arXiv
# 2106.08448), degree-capped like pivot.
register_method(BucketProgramSpec(
    method="precluster", program="precluster",
    rounds_body=_precluster_rounds_body, degree_cap=True))
# Total disagreement count, the paper's objective; worst-vertex
# disagreement (arXiv 2502.12519, on the eligible-induced subgraph).
register_objective(ObjectiveSpec(
    objective="disagree", cost_pass=_disagree_cost_pass))
register_objective(ObjectiveSpec(
    objective="minmax", cost_pass=_minmax_cost_pass))


# ---------------------------------------------------------------------------
# Composed bucket implementation.
# ---------------------------------------------------------------------------


def bucket_impl(ell: torch.Tensor, ranks_p: torch.Tensor,
                elig_p: torch.Tensor, m_edges: torch.Tensor, k: int,
                program: str = "pivot", objective: str = "disagree",
                plans=None):
    """Cluster + cost + select every graph of one shape bucket.

    Returns ``(labels (G, R), costs (G,), picked (G,), rounds (G,))``, all
    int32, for the ``G = B / k`` groups, whose k entries carry one ELL
    each (``pack_bucket``'s layout; the rounds body gets ``replicas=k``).
    The first cost minimum wins
    (``torch.argmin`` returns the first occurrence), the same rule as the
    per-graph loop's strict ``<``.

    ``plans`` is the tuned ``(neighbor_min, label_agree)`` pair of
    :class:`~repro_torch.kernels.autotune.PlanChoice` (None: untuned). Each
    is built into a launch plan at this call's ``(B, R, W)``: the B1 plan
    serves the rounds body (the pivot MIS loop and capture, and the
    precluster propagation over the agreement ELL of the same shape), the
    B2 plan the cost pass.
    """
    spec = _METHODS[program]
    obj = _OBJECTIVES[objective]
    B, R, W = ell.shape
    nm_choice, la_choice = plans if plans is not None else (None, None)
    labels, rounds = spec.rounds_body(
        ell, ranks_p, elig_p, replicas=k,
        nm_plan=_autotune.plan_of(nm_choice, B, R, W))
    costs = obj.cost_pass(ell, labels, m_edges,
                          la_plan=_autotune.plan_of(la_choice, B, R, W))
    G = B // k
    cost_g = costs.reshape(G, k)
    picked = torch.argmin(cost_g, dim=1)
    idx = picked.unsqueeze(1)
    labels_win = torch.gather(
        labels.reshape(G, k, R), 1, idx.unsqueeze(2).expand(G, 1, R))[:, 0]
    costs_win = torch.gather(cost_g, 1, idx)[:, 0]
    rounds_win = torch.gather(rounds.reshape(G, k), 1, idx)[:, 0]
    return labels_win, costs_win, picked.to(torch.int32), rounds_win


# ---------------------------------------------------------------------------
# Numpy host oracles (copies of the reference's).
# ---------------------------------------------------------------------------

_INT32_INF = np.int32(2**31 - 1)


def _host_adjacency(n: int, edges: np.ndarray):
    adj = [[] for _ in range(n)]
    for u, v in np.asarray(edges, dtype=np.int64):
        adj[int(u)].append(int(v))
        adj[int(v)].append(int(u))
    return [sorted(a) for a in adj]


def precluster_host(n: int, edges: np.ndarray, eligible: np.ndarray,
                    ranks: np.ndarray):
    """Numpy reference of the precluster device program for one graph.

    ``edges`` is the *eligible-induced* kept undirected edge list (what
    the ELL pack carries), ``ranks`` the full permutation ranks. Returns
    ``(labels (n,) int32, rounds int)`` bit-identical to the device
    program's per-entry outputs — same integer agreement predicate, same
    synchronous min-rank propagation over :data:`PRECLUSTER_ROUNDS` hops,
    same rank→vertex capture.
    """
    eligible = np.asarray(eligible, dtype=bool)
    ranks = np.asarray(ranks, dtype=np.int64)
    adj = _host_adjacency(n, edges)
    deg = np.array([len(a) for a in adj], dtype=np.int64)
    sets = [set(a) for a in adj]

    agree_adj = [[] for _ in range(n)]
    for u, v in np.asarray(edges, dtype=np.int64):
        u, v = int(u), int(v)
        common = len(sets[u] & sets[v])
        sym_diff = deg[u] + deg[v] - 2 * common - 2
        if BETA_DEN * sym_diff < BETA_NUM * (max(deg[u], deg[v]) + 1):
            agree_adj[u].append(v)
            agree_adj[v].append(u)

    state = np.where(eligible, ranks, np.int64(_INT32_INF))
    rounds = 0
    for _ in range(PRECLUSTER_ROUNDS):
        nxt = state.copy()
        for u in range(n):
            for v in agree_adj[u]:
                if state[v] < nxt[u]:
                    nxt[u] = state[v]
        if np.any(nxt != state):
            rounds += 1
        state = nxt

    v_of_rank = np.empty(n, dtype=np.int64)
    v_of_rank[ranks] = np.arange(n)
    own = np.arange(n, dtype=np.int64)
    labels = np.where(state < _INT32_INF, v_of_rank[np.minimum(state, n - 1)],
                      own)
    labels = np.where(eligible, labels, own)
    return labels.astype(np.int32), rounds


def minmax_cost_host(n: int, edges: np.ndarray,
                     labels: np.ndarray) -> int:
    """Numpy min-max oracle: worst-vertex disagreement over ``edges``.

    Pass the full undirected positive edge list for the true objective, or
    the eligible-induced kept list to mirror the device cost pass exactly.
    """
    labels = np.asarray(labels, dtype=np.int64)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    deg = np.zeros(n, dtype=np.int64)
    same = np.zeros(n, dtype=np.int64)
    if len(edges):
        np.add.at(deg, edges[:, 0], 1)
        np.add.at(deg, edges[:, 1], 1)
        agree = labels[edges[:, 0]] == labels[edges[:, 1]]
        np.add.at(same, edges[agree][:, 0], 1)
        np.add.at(same, edges[agree][:, 1], 1)
    sizes = np.bincount(labels, minlength=n if n else 1)
    size_of = sizes[labels] if n else np.zeros(0, dtype=np.int64)
    per_vertex = (deg - same) + (size_of - 1 - same)
    return int(per_vertex.max(initial=0))


__all__ = [
    "UNDECIDED",
    "IN_MIS",
    "REMOVED",
    "PRECLUSTER_ROUNDS",
    "BETA_NUM",
    "BETA_DEN",
    "precluster_host",
    "minmax_cost_host",
    "BucketProgramSpec",
    "ObjectiveSpec",
    "register_method",
    "register_objective",
    "registered_methods",
    "registered_objectives",
    "method_spec",
    "objective_spec",
    "bucket_impl",
]
