"""Algorithm 1 (prefix phases) with Algorithm 2 / Algorithm 3 subroutines.

The *output* of Algorithm 1 is by construction the global randomized greedy
MIS for the permutation π; what the phase/chunk machinery buys is the
**MPC round complexity**, the paper's metric. The schedule is executed as
written and its rounds are *accounted* in a :class:`RoundLedger` whose
charging rules follow the paper:

* Algorithm 2 (Model 1): per chunk graph ``G_{i,j}``, every vertex learns
  its connected component by graph exponentiation, ``ceil(log2(component))``
  rounds (Lemma 19), and resolves it locally in 1 compressed round. The
  realized max component size per chunk is measured (Lemma 18).
* Algorithm 3 (Model 2): per prefix graph, gather the R-hop neighbourhood
  in ``ceil(log2 R)`` exponentiation rounds, then simulate the dependency
  chain in ``ceil(depth / R)`` compressed rounds, where ``depth`` is the
  realized dependency depth of that prefix and ``R = Θ(log n / log Δ')``.
* Every phase pays +1 round for the status-update broadcast (§2.1.4 step
  3), and the final PIVOT capture pass pays +1 convergecast round.

Every window (a prefix, or a chunk of one) is one call of kernel B3's
window mode, :func:`repro_torch.kernels.mis_pivot.mis_window_csr`: one
launch on the card, its plain version on the CPU. The schedule itself is
host Python, as in the reference, and reads back one integer a window (its
rounds), one a measured chunk component and two a phase (the live and the
prefix max degree). The ledger's arithmetic is Python ``math`` on host
integers, as in the reference, so its floats are bit-equal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch

from repro_torch.kernels.mis_pivot import mis_window_csr

from .cliques import component_sizes, connected_components
from .graph import Graph
from .mis import UNDECIDED, MISState, _ranks_tensor, random_permutation_ranks
from .rng import PRNGKey


@dataclasses.dataclass
class PhaseStat:
    phase: int
    prefix_start: int
    prefix_end: int
    delta_before: int          # max live degree entering the phase
    delta_prefix: int          # max degree inside the prefix graph
    depth: int                 # realized parallel dependency depth
    mpc_rounds: float          # charged rounds for this phase
    max_component: int = 0     # Alg 2 only: max chunk-component seen
    chunks: int = 0


@dataclasses.dataclass
class RoundLedger:
    model: str                 # 'model1' (Alg 2) | 'model2' (Alg 3)
    n: int
    phases: List[PhaseStat] = dataclasses.field(default_factory=list)
    extra_rounds: float = 0.0  # capture pass, Δ estimation, etc.

    @property
    def total_rounds(self) -> float:
        return sum(p.mpc_rounds for p in self.phases) + self.extra_rounds

    def summary(self) -> dict:
        return {
            "model": self.model,
            "n": self.n,
            "num_phases": len(self.phases),
            "total_mpc_rounds": self.total_rounds,
            "max_depth": max((p.depth for p in self.phases), default=0),
            "max_component": max((p.max_component for p in self.phases),
                                 default=0),
        }


def _masked_max_degree(g: Graph, mask: torch.Tensor) -> int:
    """Max degree of the subgraph induced by ``mask`` (0 for no vertex)."""
    n = g.n
    if n == 0:
        return 0
    src, dst = g.src.long(), g.dst.long()
    contrib = ((dst < n) & mask[dst.clamp(max=n - 1)]
               & mask[src.clamp(max=n - 1)]).to(torch.int32)
    deg = torch.zeros((n + 1,), dtype=torch.int32, device=g.device)
    deg.index_add_(0, src.clamp(max=n), contrib)
    return int(torch.where(mask, deg[:n], 0).max())


def _live_max_degree(g: Graph, status: torch.Tensor) -> int:
    """Max degree of the graph induced by still-undecided vertices."""
    return _masked_max_degree(g, status == UNDECIDED)


def _run_window(g: Graph, ranks: torch.Tensor, state: MISState,
                lo: int, hi: int) -> Tuple[MISState, int]:
    """Resolve all undecided vertices with rank in [lo, hi): one call of
    B3's window mode. Returns the new state and the window's depth (its
    rounds), read back to the host."""
    status, rounds = mis_window_csr(g.row_offsets, g.dst, ranks,
                                    state.status, lo, hi)
    depth = int(rounds[0])
    return MISState(status=status, rounds=state.rounds + depth), depth


def algorithm2_phase(g: Graph, ranks: torch.Tensor, state: MISState,
                     lo: int, hi: int, delta_prefix: int,
                     chunk_c1: float = 4.0, iters_factor: float = 4.0,
                     measure_components: bool = True,
                     ) -> Tuple[MISState, float, int, int, int]:
    """Process prefix window [lo, hi) with Algorithm 2's chunk schedule.

    Returns (state, charged_rounds, total_depth, max_component, num_chunks).
    """
    t = hi - lo
    dp = max(2, delta_prefix)
    log_d = max(1, math.ceil(math.log2(dp)))
    charged = 0.0
    total_depth = 0
    max_comp = 0
    num_chunks = 0
    pos = lo
    for i in range(log_d + 1):
        if pos >= hi:
            break
        c_i = max(1, math.ceil((2**i) / (chunk_c1 * dp) * t))
        iters = max(1, math.ceil(iters_factor * log_d))
        for _ in range(iters):
            if pos >= hi:
                break
            end = min(hi, pos + c_i)
            if measure_components:
                chunk_mask = ((ranks >= pos) & (ranks < end)
                              & (state.status == UNDECIDED))
                labels, _ = connected_components(g, chunk_mask)
                sizes = component_sizes(labels, chunk_mask, g.n)
                comp = int(sizes.max()) if g.n else 0
            else:
                comp = 2
            state, depth = _run_window(g, ranks, state, pos, end)
            total_depth += depth
            max_comp = max(max_comp, comp)
            num_chunks += 1
            # Lemma 19 charge: learn component via exponentiation + resolve.
            charged += math.ceil(math.log2(max(2, comp))) + 2
            pos = end
    return state, charged, total_depth, max_comp, num_chunks


def algorithm3_phase(g: Graph, ranks: torch.Tensor, state: MISState,
                     lo: int, hi: int, delta_prefix: int,
                     ) -> Tuple[MISState, float, int]:
    """Process prefix window [lo, hi) with Algorithm 3's accounting (Model 2).

    Returns (state, charged_rounds, depth).
    """
    n = g.n
    state, depth = _run_window(g, ranks, state, lo, hi)
    dp = max(2, delta_prefix)
    R = max(1, math.ceil(math.log2(max(2, n)) / math.log2(dp)))
    charged = math.ceil(math.log2(R + 1)) + math.ceil(max(1, depth) / R) + 1
    return state, charged, depth


def algorithm1(g: Graph, ranks: Optional[torch.Tensor] = None,
               key=None,
               subroutine: str = "alg3",
               c_prefix: float = 2.0,
               chunk_c1: float = 4.0,
               iters_factor: float = 4.0,
               measure_components: bool = True,
               max_phases: int = 64,
               ) -> Tuple[MISState, torch.Tensor, RoundLedger]:
    """Algorithm 1: phased prefix processing of randomized greedy MIS, on
    ``g``'s device.

    Returns (final MISState, ranks, ledger). The MIS equals the global
    greedy MIS for π; the ledger holds the charged MPC rounds (Model 1 for
    ``subroutine='alg2'``, Model 2 for ``'alg3'``).
    """
    n = g.n
    if ranks is None:
        ranks = random_permutation_ranks(
            n, key if key is not None else PRNGKey(0), device=g.device)
    ranks = _ranks_tensor(ranks, g.device)

    ledger = RoundLedger(model="model1" if subroutine == "alg2" else "model2",
                         n=n)
    state = MISState(status=torch.zeros((n,), dtype=torch.int32,
                                        device=g.device), rounds=0)
    delta = max(1, g.max_degree())
    ledger.extra_rounds += 1.0  # O(1) rounds to estimate Δ (Remark 7)

    offset = 0
    log_n = math.log(max(2, n))
    for i in range(max_phases):
        if offset >= n:
            break
        target = max(1.0, delta / (2.0**i))
        t_i = min(n - offset, max(1, math.ceil(c_prefix * n * log_n / target)))
        lo, hi = offset, offset + t_i

        delta_before = _live_max_degree(g, state.status)
        # Max degree inside the prefix graph (undecided ∩ window, both ends).
        window = (ranks >= lo) & (ranks < hi) & (state.status == UNDECIDED)
        delta_prefix = _masked_max_degree(g, window)

        if subroutine == "alg2":
            state, charged, depth, max_comp, chunks = algorithm2_phase(
                g, ranks, state, lo, hi, delta_prefix,
                chunk_c1=chunk_c1, iters_factor=iters_factor,
                measure_components=measure_components,
            )
        else:
            state, charged, depth = algorithm3_phase(
                g, ranks, state, lo, hi, delta_prefix
            )
            max_comp, chunks = 0, 1

        ledger.phases.append(
            PhaseStat(
                phase=i,
                prefix_start=lo,
                prefix_end=hi,
                delta_before=delta_before,
                delta_prefix=delta_prefix,
                depth=depth,
                mpc_rounds=charged,
                max_component=max_comp,
                chunks=chunks,
            )
        )
        offset = hi

    # Mop-up (line 8 of Algorithm 1): any stragglers (should be none).
    if bool((state.status == UNDECIDED).any()):
        state, depth = _run_window(g, ranks, state, 0, n)
        ledger.extra_rounds += math.ceil(math.log2(max(2, depth + 1))) + 1

    return state, ranks, ledger


def remaining_max_degree_after_prefix(g: Graph, ranks, t: int) -> int:
    """Lemma 22 probe: run greedy MIS on the rank-prefix of size t, return
    the max degree among still-undecided vertices."""
    ranks = _ranks_tensor(ranks, g.device)
    state = MISState(status=torch.zeros((g.n,), dtype=torch.int32,
                                        device=g.device), rounds=0)
    state, _ = _run_window(g, ranks, state, 0, t)
    return _live_max_degree(g, state.status)


__all__ = [
    "PhaseStat",
    "RoundLedger",
    "algorithm1",
    "algorithm2_phase",
    "algorithm3_phase",
    "remaining_max_degree_after_prefix",
]
