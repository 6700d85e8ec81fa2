"""Distributed PIVOT/greedy-MIS over ``torch.distributed``: the MPC ⇒
process-group mapping.

MPC machine ⇔ process (one device each). The padded COO edge array is
split contiguously over the group's ranks (each machine holds ``O(m/M)``
edges, the MPC input distribution); per-vertex state is replicated (the
``O(n)`` aggregate message stream of the broadcast/convergecast trees of
§2.1.5).

One MPC round ⇔ one collective phase:

* each rank segment-reduces its local edge slab into a length-(n+1)
  int32 candidate vector (local computation, free in MPC);
* ``all_reduce(op=MIN)`` combines the candidates (the convergecast);
* every rank applies the same status update to its replica (the
  broadcast), so each tests for termination locally, with no collective.

With ``packed=True`` the hit detection crosses as an int8
``all_reduce(op=MAX)`` of "has a winner neighbour" flags instead of a
second int32 MIN: the winners are known everywhere after the first
collective, so only adjacency to one must cross. 8 → 5 bytes a vertex a
round.

The group is NCCL for CUDA tensors and gloo for CPU tensors; a CUDA graph
on a gloo group raises. With no group given and none initialised, the call
runs as world size 1 on the graph's device with no collective (the
reference's one-device mesh). Output is bit-identical to the
single-device engine (``greedy_mis_parallel`` + the capture), because the
round dynamics are deterministic given π.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.util import resolve_device

from .graph import Graph
from .mis import IN_MIS, INF_RANK, REMOVED, UNDECIDED, _ranks_tensor

# Collectives the engine issued and the bytes they carried, since the last
# reset_stats(); all_reduce of a (n+1,) vector counts 4(n+1) or n+1 bytes.
stats = {"all_reduces": 0, "all_reduce_bytes": 0}


def reset_stats() -> None:
    for name in stats:
        stats[name] = 0


def round_bytes(n: int, packed: bool = False) -> int:
    """Bytes one MIS round all-reduces: the int32 MIN of the undecided
    neighbour-min, then the int32 MIN of the winner-min, or with
    ``packed`` the int8 MAX of the winner flags."""
    return 4 * (n + 1) + ((n + 1) if packed else 4 * (n + 1))


def edge_shard_mesh(num_devices: Optional[int] = None):
    """The process group the edge shards are split over: ``None`` (world
    size 1 on the caller's device) when ``torch.distributed`` is not
    initialised, else the default group, or a new group of its first
    ``num_devices`` ranks (every rank must call it, as for any
    ``new_group``)."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    if num_devices is None or num_devices >= dist.get_world_size():
        return dist.group.WORLD
    return dist.new_group(ranks=list(range(num_devices)))


def pow2_device_mesh(num_devices: Optional[int] = None) -> List[torch.device]:
    """The largest power-of-two prefix of the local CUDA devices (at most
    ``num_devices``): the devices ``ShardedExecutor`` splits the pow2
    group axis over. Raises where there is no CUDA device."""
    count = torch.cuda.device_count()
    if count == 0:
        resolve_device(None)        # raises: no CUDA device
    limit = count if num_devices is None else max(1, min(num_devices, count))
    return [torch.device(f"cuda:{i}")
            for i in range(1 << (limit.bit_length() - 1))]


def _world(group, device: torch.device):
    """(group, world size, rank) for a call on ``device``; the group None
    where no collective runs."""
    if group is None and not (dist.is_available() and dist.is_initialized()):
        return None, 1, 0
    group = dist.group.WORLD if group is None else group
    backend = str(dist.get_backend(group)).lower()
    if device.type == "cuda" and backend != "nccl":
        raise ValueError(f"distributed_pivot: a CUDA graph needs an NCCL "
                         f"group, got {backend}")
    if device.type == "cpu" and backend != "gloo":
        raise ValueError(f"distributed_pivot: a CPU graph needs a gloo "
                         f"group, got {backend}")
    return group, dist.get_world_size(group), dist.get_rank(group)


def _edge_slab(g: Graph, world: int, rank: int):
    """This rank's contiguous slab of the COO arrays, as the reference
    shards them after padding the length to a multiple of the world size
    (pad entries ``src == dst == n`` change no reduction, so the last slab
    is simply shorter)."""
    e = g.src.numel()
    per = -(-e // world)
    lo, hi = min(e, rank * per), min(e, (rank + 1) * per)
    return g.src[lo:hi].long(), g.dst[lo:hi].long()


def distributed_pivot(g: Graph, ranks, group=None, packed: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Edge-parallel PIVOT on ``g``'s device. Returns (labels, in_mis,
    rounds) as host values, equal on every rank.

    Every rank of ``group`` calls it with the same graph and ranks. Each
    round is one or two all-reduces of an (n+1,) vector and one blocking
    read of whether a vertex is still undecided.
    """
    n = g.n
    dev = g.device
    group, world, rank = _world(group, dev)
    ranks = _ranks_tensor(ranks, dev)
    if n == 0:
        return np.zeros(0, np.int32), np.zeros(0, bool), 0
    src, dst = _edge_slab(g, world, rank)
    dst_ok = dst < n
    dst_idx = dst.clamp(max=n - 1)
    seg = src.clamp(max=n)
    rank_at_dst = ranks[dst_idx]
    inf = torch.full_like(rank_at_dst, INF_RANK)

    def all_reduce(t: torch.Tensor, op) -> torch.Tensor:
        if group is not None:
            dist.all_reduce(t, op=op, group=group)
            stats["all_reduces"] += 1
            stats["all_reduce_bytes"] += t.numel() * t.element_size()
        return t

    def nbr_min(mask: torch.Tensor) -> torch.Tensor:
        """Min rank over neighbours in ``mask``: the local slab's partial,
        combined by an int32 MIN (the convergecast)."""
        local = torch.full((n + 1,), INF_RANK, dtype=torch.int32, device=dev)
        local.scatter_reduce_(0, seg, torch.where(dst_ok & mask[dst_idx],
                                                  rank_at_dst, inf),
                              reduce="amin")
        return all_reduce(local, dist.ReduceOp.MIN)[:n]

    def nbr_any(mask: torch.Tensor) -> torch.Tensor:
        """Has a neighbour in ``mask``: int8 flags combined by a MAX."""
        local = torch.zeros((n + 1,), dtype=torch.bool, device=dev)
        local[seg[dst_ok & mask[dst_idx]]] = True
        return all_reduce(local.to(torch.int8), dist.ReduceOp.MAX)[:n] > 0

    status = torch.zeros((n,), dtype=torch.int32, device=dev)
    rounds = 0
    while bool((status == UNDECIDED).any()):
        und = status == UNDECIDED
        winners = und & (ranks < nbr_min(und))
        if packed:
            hit = und & ~winners & nbr_any(winners)
        else:
            hit = und & ~winners & (nbr_min(winners) < INF_RANK)
        status = torch.where(winners, IN_MIS, status)
        status = torch.where(hit, REMOVED, status).to(torch.int32)
        rounds += 1

    # PIVOT capture pass (one more convergecast round).
    in_mis = status == IN_MIS
    wmin = nbr_min(in_mis)
    own = torch.arange(n, dtype=torch.int32, device=dev)
    rank_to_v = torch.zeros((n,), dtype=torch.int32, device=dev)
    rank_to_v.scatter_(0, ranks.long(), own)
    pivot_v = rank_to_v[wmin.long().clamp(max=n - 1)]
    labels = torch.where(in_mis, own,
                         torch.where(wmin < INF_RANK, pivot_v, own))
    return labels.cpu().numpy(), in_mis.cpu().numpy(), rounds


__all__ = ["edge_shard_mesh", "pow2_device_mesh", "distributed_pivot",
           "round_bytes", "stats", "reset_stats"]
