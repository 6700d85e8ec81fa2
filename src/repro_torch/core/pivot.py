"""PIVOT correlation clustering (Ailon–Charikar–Newman) via greedy MIS.

PIVOT = greedy MIS with respect to a uniform random permutation, where
each MIS vertex (pivot) captures its surviving positive neighbours; a
3-approximation in expectation. Engines:

* ``engine='rounds'``     — round-parallel MIS (O(log n) depth w.h.p.);
* ``engine='sequential'`` — host oracle (tests, tiny inputs).

``engine='phased'`` (Algorithm 1) is not ported yet (ROADMAP A14).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .graph import Graph
from .mis import (
    IN_MIS,
    assign_to_min_rank_mis_neighbor,
    greedy_mis_parallel,
    pivot_sequential,
    random_permutation_ranks,
)


@dataclasses.dataclass
class PivotResult:
    labels: np.ndarray           # (n,) cluster ids (pivot vertex ids)
    in_mis: np.ndarray           # (n,) bool pivot mask
    depth: int                   # realized parallel dependency depth


def pivot(g: Graph, key, engine: str = "rounds",
          eligible: Optional[torch.Tensor] = None) -> PivotResult:
    """Run PIVOT on the positive graph ``g``, on ``g``'s device.

    ``eligible`` restricts to an induced subgraph (Theorem 26 degree cap);
    ineligible vertices come back as singletons labelled by their own id.
    """
    n = g.n
    ranks = random_permutation_ranks(n, key, device=g.device)

    if engine == "sequential":
        if eligible is not None:
            raise ValueError("sequential engine does not support eligible mask")
        labels = pivot_sequential(g, ranks.cpu().numpy())
        in_mis = labels == np.arange(n)
        return PivotResult(labels=labels, in_mis=in_mis, depth=-1)

    if engine == "phased":
        raise NotImplementedError(
            "engine='phased' (Algorithm 1) is not ported yet: ROADMAP A14")
    if engine != "rounds":
        raise ValueError(f"unknown engine {engine!r}")

    state = greedy_mis_parallel(g, ranks, eligible=eligible)
    in_mis = state.status == IN_MIS
    labels = assign_to_min_rank_mis_neighbor(g, ranks, in_mis)
    if eligible is not None:
        own = torch.arange(n, dtype=torch.int32, device=g.device)
        labels = torch.where(eligible.to(g.device), labels, own)
    return PivotResult(labels=labels.cpu().numpy(),
                       in_mis=in_mis.cpu().numpy(), depth=state.rounds)


__all__ = ["PivotResult", "pivot"]
