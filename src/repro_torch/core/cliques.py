"""Corollary 32: deterministic O(λ²)-approximation in O(1) MPC rounds.

Algorithm: every connected component (with respect to E⁺) that is a
*clique* forms one cluster; every other vertex is a singleton.

O(1)-round MPC realization (broadcast/convergecast trees, §2.1.5): each
vertex v computes ``h[v] = min id over N[v]`` in one convergecast. A label
group ``S = {v : h[v] = h, deg(v) = |S| − 1}`` is exactly a clique
connected component: ``deg(v) = |S|−1`` forbids edges leaving S, and a
disjoint union of ≥2 cliques inside one group would violate the degree
equation. Groups passing the check become clusters; everything else is
singleton.

Also hosts the masked connected-components routine (min-label propagation
and pointer jumping) that Algorithm 2's chunk measurements use (Lemma 18).
Torch operations on the graph's device; ``connected_components`` reads one
flag back to the host an iteration, where the reference's ``while_loop``
stays on the device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .graph import Graph
from .mis import INF_RANK, _masked_segment_min


def clique_clustering(g: Graph) -> torch.Tensor:
    """Corollary 32 clustering labels (deterministic, O(1) MPC rounds),
    int32 on ``g``'s device."""
    n = g.n
    own = torch.arange(n, dtype=torch.int32, device=g.device)
    if n == 0:
        return own
    # Convergecast 1: min id over N[v] (closed neighbourhood).
    nbr_min = _masked_segment_min(g, own, torch.ones_like(own, dtype=torch.bool))
    h = torch.minimum(own, torch.where(nbr_min < INF_RANK, nbr_min, own))
    hl = h.long()
    # Group size per candidate label (scatter-add convergecast).
    group_size = torch.zeros_like(own).index_add_(0, hl, torch.ones_like(own))
    k = group_size[hl]
    deg_ok = (g.deg == k - 1).to(torch.int32)
    # Every group member must pass deg_ok: a min of the flag per label.
    ok_per_group = torch.ones_like(own).scatter_reduce_(0, hl, deg_ok,
                                                        reduce="amin")
    accept = (ok_per_group[hl] == 1) & (k >= 1)
    return torch.where(accept, h, own)


def connected_components(g: Graph, mask: torch.Tensor,
                         max_iters: int = 64) -> Tuple[torch.Tensor, int]:
    """Connected components of the subgraph induced by ``mask``.

    Min-label propagation with two pointer jumps an iteration, at most
    ``max_iters`` iterations. Returns (labels, iters); unmasked vertices
    label themselves.
    """
    n = g.n
    labels = torch.arange(n, dtype=torch.int32, device=g.device)
    iters = 0
    if n == 0:
        return labels, iters
    changed = True
    while changed and iters < max_iters:
        # Propagate: min over masked neighbours' labels (masked vertices only).
        nmin = _masked_segment_min(g, labels, mask)
        new = torch.where(mask & (nmin < INF_RANK),
                          torch.minimum(labels, nmin), labels)
        # Pointer jump twice: label <- label[label].
        new = torch.minimum(new, new[new.long()])
        new = torch.minimum(new, new[new.long()])
        changed = bool((new != labels).any())
        labels, iters = new, iters + 1
    return labels, iters


def component_sizes(labels: torch.Tensor, mask: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Size of each vertex's component (0 for unmasked vertices)."""
    sizes = torch.zeros((n,), dtype=torch.int32, device=labels.device)
    sizes.index_add_(0, labels.long(), mask.to(torch.int32))
    return torch.where(mask, sizes[labels.long()], torch.zeros_like(sizes))


__all__ = ["clique_clustering", "connected_components", "component_sizes"]
