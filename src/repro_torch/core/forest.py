"""Forest (λ = 1) specialization: matchings ⇒ correlation clustering.

Corollary 27: a *maximum* matching on E⁺ yields an optimum clustering.
Lemma 29: an α-approximate matching yields an α-approximate clustering.

* :func:`max_matching_forest` — exact maximum matching by leaf-peeling
  (host oracle; greedy leaf-matching is optimal on forests).
* :func:`maximal_matching_parallel` — round-parallel random-priority
  maximal matching (local-minimum edges), O(log n) rounds w.h.p., on the
  graph's device; a 2-approximation, so a 2-approximate clustering.
* :func:`augmenting_matching_parallel` — improves a matching by flipping
  vertex-disjoint length-3 augmenting paths in parallel passes (host
  numpy, as in the reference); each pass is O(1) MPC rounds on a
  bounded-degree forest.
* :func:`clustering_from_matching` — matched pairs = clusters of 2, rest
  singletons.

Edge priorities are the reference's uint32 permutation values held as
int64 (torch has no uint32 scatter-min): the same order, with ``UINT_BIG``
= 2³² − 1 on the pads.
"""

from __future__ import annotations

from collections import deque
from typing import Tuple

import numpy as np
import torch

from . import rng as _rng
from .graph import Graph

UINT_BIG = 0xFFFFFFFF
MAX_ROUNDS = 10_000


# ---------------------------------------------------------------------------
# Exact maximum matching on forests (host oracle).
# ---------------------------------------------------------------------------


def max_matching_forest(g: Graph) -> np.ndarray:
    """partner[v] = matched neighbour or -1. Leaf-peeling is optimal on
    forests (standard exchange argument)."""
    n = g.n
    dst = g.dst.cpu().numpy()
    row = g.row_offsets.cpu().numpy()
    deg = g.deg.cpu().numpy().copy()
    alive = np.ones(n, dtype=bool)
    partner = np.full(n, -1, dtype=np.int32)

    leaves = deque(v for v in range(n) if deg[v] == 1)

    def neighbors(v):
        for e in range(row[v], row[v + 1]):
            u = int(dst[e])
            if u < n and alive[u]:
                yield u

    while leaves:
        v = leaves.popleft()
        if not alive[v] or deg[v] != 1:
            continue
        us = [u for u in neighbors(v)]
        if not us:
            alive[v] = False
            continue
        u = us[0]
        partner[v], partner[u] = u, v
        alive[v] = alive[u] = False
        for x in range(row[u], row[u + 1]):
            w = int(dst[x])
            if w < n and alive[w]:
                deg[w] -= 1
                if deg[w] == 1:
                    leaves.append(w)
        for x in range(row[v], row[v + 1]):
            w = int(dst[x])
            if w < n and alive[w]:
                deg[w] -= 1
                if deg[w] == 1:
                    leaves.append(w)
    return partner


def matching_size(partner) -> int:
    return int((np.asarray(partner) >= 0).sum()) // 2


# ---------------------------------------------------------------------------
# Parallel maximal matching (local-minimum edges).
# ---------------------------------------------------------------------------


def _edge_priorities(g: Graph, key) -> torch.Tensor:
    """Symmetric random priority per *directed* COO slot, int64: a random
    permutation of undirected edge ids (unique, so tie-free), shared by
    both directions via ``g.eid``. Padding slots get ``UINT_BIG``."""
    perm = _rng.permutation(key, g.m, g.device) if g.m else torch.zeros(
        (0,), dtype=torch.int64, device=g.device)
    perm_pad = torch.cat([perm, perm.new_full((1,), UINT_BIG)])
    return perm_pad[g.eid.long().clamp(max=g.m)]


def maximal_matching_parallel(g: Graph, key) -> Tuple[torch.Tensor, int]:
    """Random-priority maximal matching on ``g``'s device. Returns
    (partner int32 (n,), rounds), at most ``MAX_ROUNDS`` rounds; one
    blocking read a round tests for a live edge."""
    n = g.n
    dev = g.device
    partner = torch.full((n,), -1, dtype=torch.int32, device=dev)
    if n == 0:
        return partner, 0
    pri = _edge_priorities(g, key)
    src, dst = g.src.long(), g.dst.long()
    src_ok = src < n
    src_i, dst_i = src.clamp(max=n - 1), dst.clamp(max=n - 1)
    seg = src.clamp(max=n)
    big = torch.full_like(pri, UINT_BIG)

    def live_edges(partner):
        free = partner < 0
        return src_ok & free[src_i] & free[dst_i]

    rounds = 0
    live = live_edges(partner)
    while rounds < MAX_ROUNDS and bool(live.any()):
        vals = torch.where(live, pri, big)
        vmin = torch.full((n + 1,), UINT_BIG, dtype=torch.int64, device=dev)
        vmin.scatter_reduce_(0, seg, vals, reduce="amin")
        is_min = (live & (vals == vmin[src_i]) & (vals == vmin[dst_i])
                  & (vals < UINT_BIG))
        # A vertex adopts its unique local-minimum edge (a scatter-max).
        new_partner = torch.full((n + 1,), -1, dtype=torch.int32, device=dev)
        new_partner.scatter_reduce_(
            0, torch.where(is_min, src, torch.full_like(src, n)),
            torch.where(is_min, g.dst, torch.full_like(g.dst, -1)),
            reduce="amax")
        adopt = (partner < 0) & (new_partner[:n] >= 0)
        partner = torch.where(adopt, new_partner[:n], partner)
        rounds += 1
        live = live_edges(partner)
    return partner, rounds


# ---------------------------------------------------------------------------
# Length-3 augmenting-path improvement passes (host numpy).
# ---------------------------------------------------------------------------


def augmenting_matching_parallel(g: Graph, key,
                                 passes: int = 4) -> Tuple[np.ndarray, int]:
    """Maximal matching + parallel length-3 augmentation passes.

    Each pass finds a set of vertex-disjoint augmenting paths
    ``u (free) — v = w (matched) — x (free)`` and flips them, strictly
    increasing |M|. The passes' proposal order comes from a numpy
    generator seeded with ``randint(key, 0, 2**31 - 1)``, as in the
    reference. Returns (partner, rounds_used).
    """
    n = g.n
    partner, rounds = maximal_matching_parallel(g, key)
    partner = partner.cpu().numpy().copy()    # writable host copy
    total_rounds = rounds
    dst = g.dst.cpu().numpy()
    row = g.row_offsets.cpu().numpy()
    rng = np.random.default_rng(_rng.randint(key, 0, 2**31 - 1))

    for _ in range(passes):
        free = partner < 0
        # Each free vertex proposes to a matched neighbour (min id).
        prop = np.full(n, -1, dtype=np.int64)
        for v in np.flatnonzero(free):
            for e in range(row[v], row[v + 1]):
                u = int(dst[e])
                if u < n and partner[u] >= 0:
                    prop[v] = u
                    break
        # Matched edge (v, w) with free proposers on both sides → augment.
        # Conflict resolution: each matched vertex accepts min proposer.
        accept = np.full(n, -1, dtype=np.int64)
        order = rng.permutation(np.flatnonzero(prop >= 0))
        for u in order:
            t = prop[u]
            if accept[t] < 0:
                accept[t] = u
        flipped = 0
        done = np.zeros(n, dtype=bool)
        for v in range(n):
            w = partner[v]
            if w < 0 or w < v or done[v] or done[w]:
                continue
            a, b = accept[v], accept[w]
            if a >= 0 and b >= 0 and a != b and partner[a] < 0 \
                    and partner[b] < 0:
                partner[a], partner[v] = v, a
                partner[w], partner[b] = b, w
                done[[v, w]] = True
                accept[[v, w]] = -1
                flipped += 1
        total_rounds += 3  # propose, accept, flip: O(1) rounds per pass
        if flipped == 0:
            break
    return partner, total_rounds


def clustering_from_matching(partner) -> np.ndarray:
    """Matched pair → cluster min(u, v); unmatched → singleton."""
    partner = np.asarray(partner)
    n = len(partner)
    own = np.arange(n, dtype=np.int32)
    return np.where(partner >= 0, np.minimum(own, partner),
                    own).astype(np.int32)


def forest_cost_from_matching(g: Graph, partner) -> int:
    """cost = m − |M| on a forest (all disagreements are positive edges cut)."""
    return g.m - matching_size(partner)


__all__ = [
    "max_matching_forest",
    "matching_size",
    "maximal_matching_parallel",
    "augmenting_matching_parallel",
    "clustering_from_matching",
    "forest_cost_from_matching",
]
