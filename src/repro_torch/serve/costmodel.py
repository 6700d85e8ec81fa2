"""Flush cost model: price a scheduling decision before committing to it.

The paper's MPC bound is an accounting argument — every machine's O(n^δ)
memory budget per round is spent on useful work, and the constant-round
results (Cohen-Addad et al.; Behnezhad et al.) follow from pricing exactly
what each round carries. The serving analogue: a flush is a round, its
``(B, R, W)`` tensor is the memory budget, and a work-stealing decision
that promotes a starving request into a hot flush *changes the budget* —
pow2 group inflation adds empty device entries, promoted rows pad every
stolen entry to the larger ``R``, and an inflated batch axis may hit a
bucket program that was never compiled. The age-only
:class:`~repro_torch.serve.scheduler.CoalescingPolicy` ignores all of that; this
module prices it, from inputs the serving stack already has:

* **Padding** — the same pure ``PackStats`` formula the packer reports
  real flushes with (:func:`repro_torch.core.plan.estimate_pack_stats`),
  differenced between the with-steal and without-steal packs. The
  marginal quantities reduce to count arithmetic over bucket keys (see
  :meth:`FlushCostModel.price_steal`), so pricing needs no tensors — and
  what it prices is exactly what ``stats.padded_slots`` will later report
  (locked down in ``tests/test_scheduler.py``'s pad-accounting test).
* **Service time** — the per-bucket / global EWMAs of
  :class:`~repro_torch.serve.scheduler.FlushTelemetry`, already stamped on every
  harvested flush by the executor layer. Since the admission-time packing
  split these walls cover bucket *assembly* + device time only — the
  per-request row build happens at admission, in telemetry's separate
  ``build`` stream — so the EWMAs price exactly what a flush costs, not
  host work that would have been paid regardless of the steal. A
  configurable floor (``service_floor_s``) acts as a pessimistic prior
  for simulations and deterministic benches.
* **Compile probability** — :func:`repro_torch.core.executor.
  program_cache_contains`, a non-mutating probe of the bounded program
  LRU: stealing is only charged a compile when it inflates the batch axis
  to a shape whose program is not resident.

The model is deliberately conservative and symmetric to the bit-exactness
contract: it only decides *whether* a steal happens, never what a flush
computes, and when telemetry is cold (no EWMA, no floor) it abstains —
the cost-aware policy then degrades to plain age-only coalescing.

:class:`ShapeHeat` is the second half of the budget story: the scheduler
watches which bucket shapes retire often and feeds that heat to the
program cache's ``touch``/``pin`` surface, so a hot shape's compiled
programs outlive a churn of one-off cold shapes the blind LRU would let
evict them.

A copy of the framework-free ``repro/serve/costmodel.py`` with the
port's program registry in place of the compiled-program cache (its
``program_cache_*`` functions have the same names and LRU rules, and no
kernel, donation or mesh flag enters the key).
"""

from __future__ import annotations

import dataclasses
from collections import Counter, deque
from typing import Callable, Optional, Sequence, Tuple

from repro_torch.util import next_pow2

# Queue identity: (method, R, W), matching the scheduler's BucketKey. The
# pricing formulas only use the trailing shape pair (`bucket[-2:]`) plus
# the method prefix for the program-cache probe, so legacy bare (R, W)
# keys are tolerated (the prefix defaults to the 'pivot' program family).
BucketKey = Tuple[str, int, int]


@dataclasses.dataclass(frozen=True)
class FlushCost:
    """Priced outcome of one candidate steal set (all values marginal,
    relative to the same flush running without the steal).

    ``priced=False`` means the model abstained (cold telemetry): the
    caller should fall back to its unpriced behaviour.
    """

    benefit_s: float          # deadline slack saved + avoided own flushes
    pad_cost_s: float         # est. device time of added pad entries + rows
    compile_cost_s: float     # expected compile charge of the inflated B
    pad_entries_added: int    # marginal empty entries ((B1−B0) − stolen·k)
    vertex_waste_added: int   # Σ (R − R_src) over stolen groups (rows)
    priced: bool = True
    # Portion of benefit_s credited for source-bucket flushes this steal
    # avoids (observed compile-free walls only — zero for cold sources).
    own_flush_credit_s: float = 0.0

    @property
    def total_cost_s(self) -> float:
        return self.pad_cost_s + self.compile_cost_s

    def accepts(self, hurdle: float = 1.0) -> bool:
        """True when the steal pays for itself (or the model abstained)."""
        if not self.priced:
            return True
        return self.benefit_s >= hurdle * self.total_cost_s


_ABSTAIN = FlushCost(benefit_s=0.0, pad_cost_s=0.0, compile_cost_s=0.0,
                     pad_entries_added=0, vertex_waste_added=0, priced=False)


class FlushCostModel:
    """Prices candidate steals for :class:`~repro_torch.serve.scheduler.
    CostAwareCoalescingPolicy`.

    Args:
      compile_cost_s: *static prior* charged when the steal inflates the
        batch axis to a ``(B, R, W)`` shape with no resident compiled
        program and no compile wall has been observed yet; once telemetry
        carries observed compile walls the learned per-shape EWMA replaces
        this prior (only meaningful once :meth:`bind_engine` has provided
        the exact program signature; unbound models never charge a
        compile).
      service_floor_s: lower bound on the assumed flush service time. The
        default 0.0 makes pricing purely telemetry-driven; simulations and
        deterministic benches set a pessimistic floor so decisions do not
        depend on host noise.
      hurdle: benefit must be at least ``hurdle ×`` cost to accept — >1
        biases against stealing, <1 toward it.
    """

    def __init__(self, compile_cost_s: float = 0.1,
                 service_floor_s: float = 0.0, hurdle: float = 1.0):
        if compile_cost_s < 0 or service_floor_s < 0:
            raise ValueError("compile_cost_s and service_floor_s must be "
                             ">= 0")
        if hurdle <= 0:
            raise ValueError(f"hurdle must be > 0, got {hurdle}")
        self.compile_cost_s = compile_cost_s
        self.service_floor_s = service_floor_s
        self.hurdle = hurdle
        # Engine binding (how the batcher actually runs flushes) — filled
        # in by ClusterBatcher via the policy's bind_engine hook.
        self._group_pad: Callable[[int], int] = lambda n: next_pow2(max(1, n))
        self._k = 1
        self._objective = "disagree"
        self._device = None
        self._bound = False

    def bind_engine(self, *, executor=None, num_samples: int = 1,
                    objective: str = "disagree") -> None:
        """Learn the engine's execution profile (group padding rule and the
        compiled-program signature — including the engine's ``objective``,
        which is part of the program key) so pad and compile pricing match
        what the flush will really run. The *method* half of the signature
        is not bound: it rides in each bucket key, so one model prices
        mixed-method traffic. Called by the batcher at construction; an
        unbound model still prices padding with plain pow2 rules."""
        if executor is not None:
            self._group_pad = executor.group_pad
            # The device the executor runs on: the probe resolves tuned
            # launch plans for it exactly as the executor's submit does.
            self._device = getattr(executor, "device", None)
        self._k = max(1, int(num_samples))
        self._objective = objective
        self._bound = True

    # -- pricing inputs ---------------------------------------------------

    def group_pad(self, n_groups: int) -> int:
        """The engine's padded group count for ``n_groups`` graphs (plain
        pow2 until :meth:`bind_engine` supplies the executor's rule)."""
        return self._group_pad(max(1, n_groups))

    def service_estimate(self, bucket: BucketKey,
                         telemetry) -> Optional[float]:
        """Expected service seconds of one flush of this bucket shape:
        bucket EWMA, falling back to the global EWMA, floored by the
        configured prior. None = genuinely cold (no basis to price)."""
        ewma = telemetry.bucket_ewma_wall(bucket)
        if ewma is None:
            ewma = telemetry.ewma_wall
        if ewma is None:
            return self.service_floor_s if self.service_floor_s > 0 else None
        return max(ewma, self.service_floor_s)

    def compile_charge(self, bucket: BucketKey, b1: int,
                       telemetry=None) -> float:
        """Expected compile cost of running the inflated batch axis ``b1``
        at ``bucket`` — zero when the exact program is resident or the
        model has no binding to know the program signature.

        With ``telemetry`` the charge is *learned*: the per-shape EWMA of
        observed compile walls (fed by the executor's compile stamps via
        :meth:`FlushTelemetry.record_compile`), falling back to the global
        compile EWMA, and only then to the static ``compile_cost_s``
        prior — so warmed tiers are priced at what compiles actually cost
        on this host, not at a guess."""
        if not self._bound:
            return 0.0
        from repro_torch.core.executor import program_cache_contains

        *prefix, R, W = bucket
        method = prefix[0] if prefix else "pivot"
        if program_cache_contains((b1, R, W), self._k,
                                  method=method,
                                  objective=self._objective,
                                  device=self._device):
            return 0.0
        if telemetry is not None:
            learned = telemetry.bucket_ewma_compile(bucket)
            if learned is None:
                learned = telemetry.ewma_compile
            if learned is not None:
                return learned
        return self.compile_cost_s

    # -- the decision -----------------------------------------------------

    def price_steal(self, bucket: BucketKey, count: int,
                    candidates: Sequence[Tuple[BucketKey, float]],
                    max_wait: Optional[float],
                    telemetry) -> FlushCost:
        """Price promoting ``candidates`` into a ``bucket`` flush already
        carrying ``count`` native requests.

        ``candidates`` is ``[(source_bucket, age_seconds), ...]`` — one
        entry per stolen request, in steal order. Benefit is the deadline
        slack saved: a rejected candidate waits out the remainder of its
        own ``max_wait`` budget, so riding this flush saves
        ``max_wait − age`` seconds (its full age when no deadline is
        configured) — plus, per distinct source bucket, the *avoided
        own-flush* service time: absorbing a source's stragglers spares
        the deadline flush that source would otherwise run. That credit
        uses only the source's observed compile-free wall EWMA
        (:meth:`FlushTelemetry.bucket_ewma_wall_xc`) — never the floor or
        the global fallback — so cold sources earn nothing and a
        pessimistic ``service_floor_s`` keeps its one-sided meaning. Cost
        is the marginal padding the promotion adds — pow2 group inflation
        priced at the bucket's observed per-entry service time, plus the
        promoted-row waste of running each stolen entry at the larger
        ``R`` — and the (learned, see :meth:`compile_charge`) compile the
        inflated batch axis would pay if its program is not resident.
        """
        if not candidates:
            return _ABSTAIN
        R, W = bucket[-2:]
        k = self._k
        g0 = self._group_pad(max(1, count))
        g1 = self._group_pad(count + len(candidates))
        b0, b1 = g0 * k, g1 * k
        service = self.service_estimate(bucket, telemetry)

        benefit = 0.0
        vertex_rows = 0
        for src, age in candidates:
            benefit += max(0.0, max_wait - age) if max_wait is not None \
                else max(0.0, age)
            vertex_rows += max(0, R - src[-2])
        pad_entries = (b1 - b0) - len(candidates) * k

        if service is None:
            # Cold engine: nothing to price against — abstain, but still
            # report the count arithmetic for observability.
            return dataclasses.replace(
                _ABSTAIN, pad_entries_added=pad_entries,
                vertex_waste_added=vertex_rows)

        per_entry = service / max(1, b0)
        pad_cost = max(0, pad_entries) * per_entry
        # A stolen entry's rows n..R are dead weight relative to running it
        # at its native R_src; charge the promoted fraction of an entry.
        vertex_cost = sum(
            k * max(0, R - src[-2]) / R for src, _ in candidates
        ) * per_entry
        compile_cost = self.compile_charge(bucket, b1, telemetry) \
            if b1 > b0 else 0.0
        own_flush_credit = 0.0
        xc = getattr(telemetry, "bucket_ewma_wall_xc", None)
        if xc is not None:
            for src in {src for src, _ in candidates}:
                observed = xc(src)
                if observed is not None:
                    own_flush_credit += observed
        return FlushCost(benefit_s=benefit + own_flush_credit,
                         pad_cost_s=pad_cost + vertex_cost,
                         compile_cost_s=compile_cost,
                         pad_entries_added=pad_entries,
                         vertex_waste_added=vertex_rows,
                         own_flush_credit_s=own_flush_credit)


class ShapeHeat:
    """Sliding-window bucket-shape heat → program-cache eviction hints.

    The executor's LRU only sees program *runs*; the scheduler sees the
    retire stream, which says which shapes keep coming back. Each retire
    lands in a bounded window; the ``max_pinned`` most frequent shapes with
    at least ``min_heat`` window hits are pinned in the program cache
    (:func:`repro_torch.core.executor.program_cache_pin`) and every retire
    refreshes its shape's recency (``program_cache_touch``). Shapes that
    stop retiring fall out of the window and are unpinned, so a pin is a
    lease on heat, not a permanent reservation — and the cache capacity
    stays a hard bound regardless.
    """

    def __init__(self, window: int = 64, max_pinned: int = 4,
                 min_heat: int = 3, pin=None, unpin=None, touch=None):
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if max_pinned < 0:
            raise ValueError(f"max_pinned must be >= 0, got {max_pinned}")
        if min_heat < 1:
            raise ValueError(f"min_heat must be >= 1, got {min_heat}")
        if pin is None or unpin is None or touch is None:
            from repro_torch.core.executor import (program_cache_pin,
                                             program_cache_touch,
                                             program_cache_unpin)

            pin = pin or program_cache_pin
            unpin = unpin or program_cache_unpin
            touch = touch or program_cache_touch
        self.window = window
        self.max_pinned = max_pinned
        self.min_heat = min_heat
        self._pin, self._unpin, self._touch = pin, unpin, touch
        self._events: deque = deque(maxlen=window)
        self._counts: Counter = Counter()
        self.pinned: set = set()

    def on_retire(self, bucket: BucketKey) -> None:
        """Account one retired flush of ``bucket`` shape and refresh the
        cache hints (touch always; re-derive the pinned hot set).

        Heat is tracked per ``(R, W)`` *shape*, the granularity the
        program cache pins at: a ``(method, R, W)`` queue key is reduced
        to its shape part, so a shape two methods keep hot accumulates
        their combined heat (both methods' programs share the pin)."""
        bucket = (int(bucket[-2]), int(bucket[-1]))
        if len(self._events) == self._events.maxlen:
            old = self._events[0]
            self._counts[old] -= 1
            if self._counts[old] <= 0:
                del self._counts[old]
        self._events.append(bucket)
        self._counts[bucket] += 1
        self._touch(bucket)
        hot = {b for b, c in self._counts.most_common(self.max_pinned)
               if c >= self.min_heat}
        # Pins are refcounted process-global state, so bookkeeping must
        # stay consistent even if a pin/unpin call fails partway: drop a
        # shape from `pinned` *before* unpinning (a retry can then never
        # decrement the same refcount twice and strip another engine's
        # pin) and record a pin only *after* it succeeded. The failure
        # bias is deliberate — an interrupted update can at worst leak a
        # pin (released by `release`/`__del__` eventually), never steal
        # one.
        for b in list(self.pinned - hot):
            self.pinned.discard(b)
            self._unpin(b)
        for b in list(hot - self.pinned):
            self._pin(b)
            self.pinned.add(b)

    def release(self) -> None:
        """Unpin everything this tracker pinned (engine teardown).

        Pins live in the *process-global* program cache, so a tracker that
        dies without releasing would shield its shapes from eviction
        forever — ``__del__`` backstops that, but engines should call
        this (via ``ClusterBatcher.close()``) deterministically.

        Idempotent at the refcount level: each shape is popped from
        ``pinned`` before its single ``unpin``, so calling ``release``
        twice — or ``__del__`` after an explicit ``close()`` — cannot
        double-decrement a refcount and strip a shape another live
        engine still pins.
        """
        while self.pinned:
            self._unpin(self.pinned.pop())

    def __del__(self):
        try:
            self.release()
        except Exception:       # interpreter teardown: modules may be gone
            pass


__all__ = ["FlushCost", "FlushCostModel", "ShapeHeat"]
