"""Dry run of the paper's own workload: distributed PIVOT correlation
clustering across H100 cards (the MPC cost model).

    PYTHONPATH=src python -m repro_torch.launch.cluster_dryrun \\
        [--n 131072] [--attach 8] [--chips 256] [--device cpu] [--out F]

The port of ``repro/launch/cluster_dryrun.py``, with the same ``run(n,
attach, chips, seed)`` and output keys. Round counts are measured by
running the algorithm on one device at the same graph size (they depend
on the data): ``depth_raw`` and ``depth_capped`` from
``greedy_mis_parallel`` (kernel B3 on the card), ``phases`` from
Algorithm 1 on the capped subgraph. The ranks are the reference's bit for
bit, so the counts equal the reference's.

The reference reads its collective bytes from the HLO of one MIS round
lowered on a ``chips``-way mesh. PyTorch has no HLO, so they are counted
from the all-reduces the edge-sharded engine (``core/dist.py``) issues: a
round all-reduces (n+1)-vectors, ``round_bytes(n, packed)`` per card
(two int32 MINs, or one int32 MIN and one int8 MAX), so
``bytes_per_round_* = chips × round_bytes``, the sum of the buffers over
the cards, which is what the reference's HLO count gives.

``per_device_bytes`` is counted from the shapes one card holds in a raw
round: its slab of ``ceil(2m / chips)`` src and dst ids (int32), the
replicated ranks and status (int32, n each), the two (n+1) int32
all-reduce buffers and the new status. XLA's memory analysis, which the
reference reports, counts the arguments plus the temporaries of its own
schedule, so the two differ by what XLA fuses away or keeps.

``t_collective_s`` is the collective bytes over ``chips`` cards' link
rate: NVLink 4 (450 GB/s each way a card) up to the 8 cards of a node,
the card's 400 Gb/s InfiniBand port (50 GB/s) beyond, since a ring
all-reduce across nodes runs at its slowest link (``kernels/measure.py``).
``t_compute_s`` counts 2 operations (compare, select) per directed edge
per round at the H100's 67 TOP/s outside the tensor cores. Both are
models of an H100 cluster, not measurements.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import numpy as np
import torch

from ..core.degree_cap import degree_capped_pivot, degree_threshold
from ..core.dist import round_bytes
from ..core.graph import build_graph, scale_free
from ..core.mis import greedy_mis_parallel, random_permutation_ranks
from ..core.rng import PRNGKey
from ..kernels.measure import (CARDS_PER_NODE, INFINIBAND_BYTES_PER_S,
                               NON_TENSOR_OPS_PER_S, NVLINK_BYTES_PER_S)
from ..util import DeviceLike, resolve_device


def link_bytes_per_s(chips: int) -> float:
    """The per-card link rate a collective over ``chips`` H100s runs at."""
    return NVLINK_BYTES_PER_S if chips <= CARDS_PER_NODE \
        else INFINIBAND_BYTES_PER_S


def per_device_bytes(n: int, edges_per_shard: int) -> int:
    """Bytes one card holds in a raw round (see the module docstring)."""
    return 4 * (2 * edges_per_shard + 2 * n + 2 * (n + 1) + n)


def run(n: int = 1 << 17, attach: int = 8, chips: int = 256,
        seed: int = 0, device: DeviceLike = None) -> dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    edges, lam = scale_free(n, attach, rng)
    g = build_graph(n, edges, device=dev)
    delta = g.max_degree()
    key = PRNGKey(seed)
    ranks = random_permutation_ranks(n, key, device=dev)

    # --- measured round counts (data-dependent) --------------------------
    depth_raw = int(greedy_mis_parallel(g, ranks).rounds)
    thresh = degree_threshold(lam, 2.0)
    high = g.deg.cpu().numpy() > thresh
    eligible = torch.as_tensor(~high, device=dev)
    depth_capped = int(greedy_mis_parallel(g, ranks,
                                           eligible=eligible).rounds)

    # Algorithm 1 phase stats on the capped subgraph (the phased model).
    capped = degree_capped_pivot(g, lam=lam, key=key, eps=2.0,
                                 engine="phased")
    phases = [(p.prefix_end - p.prefix_start, max(1, p.depth))
              for p in capped.inner.ledger.phases]

    # --- per-round collective bytes, from the all-reduce sizes -----------
    eps_raw = math.ceil(2 * g.m / chips)
    bpr_unpacked = chips * round_bytes(n, packed=False)
    bpr_packed = chips * round_bytes(n, packed=True)

    def total(bpr, rounds):
        return bpr * rounds + bpr / 2  # + capture pass (one MIN)

    # Phased: state vectors are O(t_i), so packed bytes scale by t_i / n.
    phased_bytes = sum(bpr_packed * (t / n) * depth for t, depth in phases)
    variants = {
        "raw_unpacked": total(bpr_unpacked, depth_raw),
        "capped_unpacked": total(bpr_unpacked, depth_capped),
        "capped_packed": total(bpr_packed, depth_capped),
        "capped_packed_phased": phased_bytes + bpr_packed,
    }
    seg_ops = 2.0 * 2 * g.m  # compare+select per directed edge per round
    link = link_bytes_per_s(chips)
    return {
        "n": n, "m": int(g.m), "lambda": lam, "delta": int(delta),
        "threshold": thresh, "high_degree": int(high.sum()),
        "depth_raw": depth_raw, "depth_capped": depth_capped,
        "phases": phases,
        "bytes_per_round_unpacked": bpr_unpacked,
        "bytes_per_round_packed": bpr_packed,
        "per_device_bytes": per_device_bytes(n, eps_raw),
        "variants_total_collective_bytes": variants,
        "t_collective_s": {k: v / (chips * link)
                           for k, v in variants.items()},
        "t_compute_s": seg_ops * depth_raw / (chips * NON_TENSOR_OPS_PER_S),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1 << 17)
    ap.add_argument("--attach", type=int, default=8)
    ap.add_argument("--chips", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = run(n=args.n, attach=args.attach, chips=args.chips,
              seed=args.seed, device=args.device)
    print(json.dumps(res, indent=2, default=float))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=2, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
