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
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.mis_pivot import mis_pivot_csr

from .graph import Graph
from .mis import (
    IN_MIS,
    _eligible,
    pivot_sequential,
    random_permutation_ranks,
    random_permutation_ranks_batch,
)


@dataclasses.dataclass
class PivotResult:
    labels: np.ndarray           # (n,) cluster ids (pivot vertex ids)
    in_mis: np.ndarray           # (n,) bool pivot mask
    depth: int                   # realized parallel dependency depth


def _pivot_samples(g: Graph, keys: Sequence,
                   eligible: Optional[torch.Tensor] = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """PIVOT of one graph under each of ``keys``, on ``g``'s device:
    ``(labels (k, n), in_mis (k, n), depth (k,))`` as host arrays.

    The k rank rows come from one batched draw, every MIS round and the
    capture of all k samples from one call of kernel B3, and the results
    from one copy to the host.
    """
    n, k = g.n, len(keys)
    ranks = random_permutation_ranks_batch(n, keys, device=g.device)
    status, labels, rounds = mis_pivot_csr(g.row_offsets, g.dst, ranks,
                                           _eligible(g, eligible))
    host = torch.cat([labels.reshape(-1), status.reshape(-1),
                      rounds]).cpu().numpy()
    return (host[:k * n].reshape(k, n),
            host[k * n:2 * k * n].reshape(k, n) == IN_MIS,
            host[2 * k * n:])


def pivot(g: Graph, key, engine: str = "rounds",
          eligible: Optional[torch.Tensor] = None) -> PivotResult:
    """Run PIVOT on the positive graph ``g``, on ``g``'s device.

    ``eligible`` restricts to an induced subgraph (Theorem 26 degree cap);
    ineligible vertices come back as singletons labelled by their own id.
    """
    n = g.n
    if engine == "sequential":
        if eligible is not None:
            raise ValueError("sequential engine does not support eligible mask")
        ranks = random_permutation_ranks(n, key, device=g.device)
        labels = pivot_sequential(g, ranks.cpu().numpy())
        in_mis = labels == np.arange(n)
        return PivotResult(labels=labels, in_mis=in_mis, depth=-1)

    if engine == "phased":
        raise NotImplementedError(
            "engine='phased' (Algorithm 1) is not ported yet: ROADMAP A14")
    if engine != "rounds":
        raise ValueError(f"unknown engine {engine!r}")

    labels, in_mis, depth = _pivot_samples(g, [key], eligible)
    return PivotResult(labels=labels[0], in_mis=in_mis[0],
                       depth=int(depth[0]))


__all__ = ["PivotResult", "pivot"]
