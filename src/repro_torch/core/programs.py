"""Method registry of bucket programs + cost objectives, in torch ops.

Every clustering *method* the batch engine can run is a
:class:`BucketProgramSpec`; every *objective* it can optimise is an
:class:`ObjectiveSpec`. :func:`bucket_impl` composes ``rounds_body ×
cost_pass`` with the shared best-of-k argmin, and the executor runs it
without knowing what the method computes.

A method provides one function over the packed tensors of a bucket::

    rounds_body(ell, ranks_p, elig_p) -> (labels (B, R) int32, rounds (B,) int32)

``ell`` is the (B, R, W) int32 ELL adjacency (pad id ``R``), ``ranks_p``
the (B, R+1) int32 rank rows (slot R = INF), ``elig_p`` the (B, R+1) bool
eligibility rows (slot R False). Ineligible and padded vertices are
labelled with their own index (singletons).

An objective provides::

    cost_pass(ell, labels, m_edges) -> costs (B,) int32

scored per batch entry before best-of-k selection.

Both neighbourhood reductions go through the kernel wrappers of
:mod:`repro_torch.kernels.neighbor_min`: the hand-written CUDA kernels for
tensors on the card, their plain versions for tensors on the CPU.

Registered: methods ``'pivot'`` / ``'pivot_raw'`` (one program family, they
differ only in host-side eligibility planning) and objective
``'disagree'``. Not ported yet: method ``'precluster'`` and objective
``'minmax'`` (ROADMAP A10).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from repro_torch.kernels import neighbor_min as _nm

from .mis import IN_MIS, INF_RANK, REMOVED, UNDECIDED

# Reference registry entries that wait for a later slice.
NOT_PORTED_METHODS = {"precluster": "A10"}
NOT_PORTED_OBJECTIVES = {"minmax": "A10"}


# ---------------------------------------------------------------------------
# Rounds body.
# ---------------------------------------------------------------------------


def _pivot_rounds_body(ell: torch.Tensor, ranks_p: torch.Tensor,
                       elig_p: torch.Tensor):
    """MIS rounds until no vertex is undecided, then the PIVOT capture.

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
        return _nm.neighbor_min_ell_batch(ell, ranks_p, active_p)

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
    arange_r = torch.arange(R, dtype=torch.int32, device=dev).expand(B, R)
    # Padded rows (rank INF) all clip to slot R. Duplicate writes land only
    # there, and slot R is read only where wmin == INF and then discarded,
    # so the scatter's write order cannot matter.
    rank_to_v = torch.zeros((B, R + 1), dtype=torch.int32, device=dev)
    rank_to_v.scatter_(1, ranks.clamp(0, R).long(), arange_r)
    piv = torch.gather(rank_to_v, 1, wmin.clamp(max=R).long())
    labels = torch.where(in_mis, arange_r,
                         torch.where(wmin < INF_RANK, piv, arange_r))
    labels = torch.where(elig, labels, arange_r)
    return labels, rounds


# ---------------------------------------------------------------------------
# Cost pass.
# ---------------------------------------------------------------------------


def _label_agree_counts(ell: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """(B, R) per-vertex same-label neighbour counts over the packed ELL."""
    B = ell.shape[0]
    labels_p = torch.cat(
        [labels, labels.new_full((B, 1), -1)], dim=1).contiguous()
    return _nm.label_agree_ell_batch(ell, labels_p)


def _cluster_sizes(labels: torch.Tensor) -> torch.Tensor:
    """(B, R) int32 cluster sizes by label (an integer scatter-add)."""
    sizes = torch.zeros_like(labels)
    return sizes.scatter_add_(1, labels.long(), torch.ones_like(labels))


def _disagree_cost_pass(ell: torch.Tensor, labels: torch.Tensor,
                        m_edges: torch.Tensor) -> torch.Tensor:
    """Total disagreement count — the paper's objective.

    Every kept (eligible-induced) undirected edge appears twice in the ELL,
    so the same-label neighbour count sums to 2·intra_pos; cap-dropped
    edges are always cut (their ineligible endpoint is a singleton), so
    m_edges accounts for them exactly:
      cost = (m − intra_pos) + (intra_pairs − intra_pos).
    ``R ≤ 2¹⁵`` keeps ``sizes·(sizes−1)/2`` and every sum inside int32.
    """
    agree = _label_agree_counts(ell, labels)
    intra_pos2 = agree.sum(dim=1, dtype=torch.int32)
    sizes = _cluster_sizes(labels)
    intra_pairs = (sizes * (sizes - 1) // 2).sum(dim=1, dtype=torch.int32)
    return m_edges - intra_pos2 + intra_pairs


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
    if method in NOT_PORTED_METHODS:
        raise NotImplementedError(
            f"batch method {method!r} is not ported yet: ROADMAP "
            f"{NOT_PORTED_METHODS[method]}")
    try:
        return _METHODS[method]
    except KeyError:
        raise ValueError(
            f"batch engine supports methods {registered_methods()}, "
            f"got {method!r}") from None


def objective_spec(objective: str) -> ObjectiveSpec:
    if objective in NOT_PORTED_OBJECTIVES:
        raise NotImplementedError(
            f"objective {objective!r} is not ported yet: ROADMAP "
            f"{NOT_PORTED_OBJECTIVES[objective]}")
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
# Total disagreement count, the paper's objective.
register_objective(ObjectiveSpec(
    objective="disagree", cost_pass=_disagree_cost_pass))


# ---------------------------------------------------------------------------
# Composed bucket implementation.
# ---------------------------------------------------------------------------


def bucket_impl(ell: torch.Tensor, ranks_p: torch.Tensor,
                elig_p: torch.Tensor, m_edges: torch.Tensor, k: int,
                program: str = "pivot", objective: str = "disagree"):
    """Cluster + cost + select every graph of one shape bucket.

    Returns ``(labels (G, R), costs (G,), picked (G,), rounds (G,))``, all
    int32, for the ``G = B / k`` groups. The first cost minimum wins
    (``torch.argmin`` returns the first occurrence), the same rule as the
    per-graph loop's strict ``<``.
    """
    spec = _METHODS[program]
    obj = _OBJECTIVES[objective]
    B, R, W = ell.shape
    labels, rounds = spec.rounds_body(ell, ranks_p, elig_p)
    costs = obj.cost_pass(ell, labels, m_edges)
    G = B // k
    cost_g = costs.reshape(G, k)
    picked = torch.argmin(cost_g, dim=1)
    idx = picked.unsqueeze(1)
    labels_win = torch.gather(
        labels.reshape(G, k, R), 1, idx.unsqueeze(2).expand(G, 1, R))[:, 0]
    costs_win = torch.gather(cost_g, 1, idx)[:, 0]
    rounds_win = torch.gather(rounds.reshape(G, k), 1, idx)[:, 0]
    return labels_win, costs_win, picked.to(torch.int32), rounds_win


__all__ = [
    "UNDECIDED",
    "IN_MIS",
    "REMOVED",
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
