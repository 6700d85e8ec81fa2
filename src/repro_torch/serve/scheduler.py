"""Pluggable scheduling-policy layer: *which* bucket flushes, *when*, at
*what* sub-batch size.

The serving analogue of the paper's MPC resource question. Cohen-Addad et
al. get constant rounds by being deliberate about what each round does and
how machines are loaded — per-round compute is never the bottleneck, the
round/launch schedule is. In this repo the "round" is a bucket flush and
the "machines" are the in-flight device programs, so the scheduling
decisions (flush triggers, admission control, load balancing across bucket
queues) deserve their own layer instead of being hard-coded into
:class:`~repro_torch.serve.cluster_batcher.ClusterBatcher`. The batcher keeps
the *mechanics* — queues, staging leases, packing, harvest — and delegates
every *decision* to a :class:`SchedulerPolicy`:

* :class:`FullBucketPolicy` — flush a bucket only when it holds
  ``max_batch`` requests. MPC analogue: run a round only with machines at
  full memory load, maximizing work amortized per round (the paper's
  O(n·λ) total-memory budget spent in as few rounds as possible).
* :class:`DeadlinePolicy` — full buckets, plus flush any bucket whose
  oldest request has waited ``max_wait`` (a partial, pow2-padded
  sub-batch). MPC analogue: the constant-*round* guarantee itself — no
  item's round count depends on what the rest of the stream does.
* :class:`AdaptivePolicy` — replaces the static ``max_in_flight`` knob
  with a dynamic admission window derived from executor telemetry: keep
  ``ceil(EWMA(flush service time) / EWMA(assemble time))`` flushes in
  flight —
  enough that the host never leaves the device idle, no more than that so
  queueing delay is not hidden inside the engine. MPC analogue: sizing
  the number of machines to the observed round time instead of fixing it
  up front.
* :class:`CoalescingPolicy` — work-stealing across bucket queues: when a
  bucket flushes, requests starving in a *compatible smaller* ``(R', W')``
  bucket (``R' ≤ R, W' ≤ W``, same bucket-program method — a flush runs
  exactly one registered method) are promoted into the flush via
  :func:`repro_torch.core.plan.promote_plan`, so no queue waits unboundedly
  behind a hot one. MPC analogue: migrating a straggler machine's items
  into a busier machine's round — sound here because a graph that fits a
  small ``(R, W)`` memory budget trivially fits a larger one, and the
  clustering of each packed entry is independent of its neighbours in the
  batch (which is also why promotion is bit-exact).
* :class:`CostAwareCoalescingPolicy` — coalescing with the steal *priced*
  (:class:`~repro_torch.serve.costmodel.FlushCostModel`): a steal is taken only
  when the deadline slack it saves covers the pow2 pad inflation, the
  promoted-row waste and any compile the inflated batch axis would pay —
  otherwise it is trimmed to the slots that ride existing padding for
  free. Its ``on_retire`` additionally feeds bucket-shape heat
  (:class:`~repro_torch.serve.costmodel.ShapeHeat`) to the compiled-program
  LRU's ``touch``/``pin`` surface, so hot shapes outlive cold-shape
  churn. MPC analogue: the paper's per-machine O(n^δ) budget accounting —
  Cohen-Addad et al. and Behnezhad et al. get their constant round counts
  precisely by pricing what each round carries; migrating an item into a
  round is only sound when it does not blow the budget the round was
  priced at. Cost only ever decides *whether* a steal happens, never what
  a flush computes, so the bit-exactness contract is untouched.

Policies see three read-only inputs: the bucket queues (admission-ordered
request lists), the engine clock's ``now``, and a :class:`FlushTelemetry`
(per-bucket flush latency EWMAs/percentiles fed by the executor layer,
plus the current in-flight count). They return :class:`FlushDecision`
values — bucket key, sub-batch size, and optionally which queues to steal
from — and the batcher executes them without second-guessing.

The queues contain only *primary* requests — work that will actually pack
a device row. Admissions the batcher's result cache retires immediately,
and single-flight subscribers riding an identical queued/in-flight
request, never enter a queue (and skip the ``on_admit`` gate: they add no
device work to the window it protects). A policy can therefore trust
``len(queue)`` as the exact row count a flush of that queue packs, and
queue ages as the ages of real pending device work — subscribed
duplicates are never double-counted in depth or age.

Determinism: policies only ever read the injected engine clock (``now``)
and telemetry; they never touch wall-clock time themselves, so tests and
simulators drive them with virtual clocks and fabricated telemetry.

A copy of the framework-free ``repro/serve/scheduler.py``.
"""

from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Dict, List, Optional, Protocol, Sequence, Tuple, \
    runtime_checkable

import numpy as np

# Queue identity: (method, R, W) — the registered bucket program that will
# run the flush plus the padded ELL shape it packs into. (Telemetry and the
# policies also tolerate legacy bare (R, W) keys — the method prefix is
# whatever precedes the trailing shape pair — but the engine always keys by
# the full GraphPlan.queue_key.)
BucketKey = Tuple[str, int, int]


@dataclasses.dataclass(frozen=True)
class FlushDecision:
    """One flush the policy wants executed.

    ``bucket`` is the ``(method, R, W)`` queue the flush packs from (the
    registered bucket program plus the padded shape); ``count`` requests
    are taken (oldest first) from that bucket's own queue; ``steal`` names
    extra ``(source_bucket, count)`` groups to promote into the same flush
    (their plans are re-targeted at the decision's shape via
    :func:`repro_torch.core.plan.promote_plan` — every source must satisfy
    ``R' ≤ R and W' ≤ W`` **and run the same method**: a bucket program
    runs exactly one registered method per flush, so the batcher refuses a
    cross-method steal with ``ValueError``). The batcher pops stolen
    requests from the *front* of each source queue, so a steal always
    names that queue's oldest unconsumed requests. ``deadline`` marks the
    flush as forced by a wait budget, for stats accounting only.
    """

    bucket: BucketKey
    count: int
    steal: Tuple[Tuple[BucketKey, int], ...] = ()
    deadline: bool = False


class FlushTelemetry:
    """Rolling flush-latency telemetry — the policies' stats surface.

    Host packing work is accounted as two separate streams since the
    admission-time packing split:

    * **build** — the per-request :func:`~repro_torch.core.plan.
      build_packed_rows` time, recorded by the batcher at admission via
      :meth:`record_build`. It is not part of any flush's wall.
    * **assemble** — the per-bucket staging assembly time stamped on each
      :class:`~repro_torch.core.executor.InFlightBucket` (the only host packing
      cost left on the flush critical path), fed here on harvest together
      with the submit→fetch wall time.

    Policies read the EWMAs (adaptive in-flight control); benchmarks and
    ``ClusterStats`` read :meth:`summary` (per-bucket p50/p99). Bounded:
    at most ``window`` samples are retained per bucket shape.

    ``in_flight`` is refreshed by the batcher before every policy call —
    it is the number of submitted-but-unharvested flushes, the quantity
    admission control windows bound.
    """

    def __init__(self, window: int = 256, alpha: float = 0.2):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.window = window
        self.alpha = alpha
        self.in_flight = 0
        self.total_flushes = 0
        self.total_builds = 0
        # Lifetime wall accumulators for the two host packing streams —
        # batch_bench emits these as fractions of the serve wall.
        self.total_build_s = 0.0
        self.total_assemble_s = 0.0
        self._ewma_wall: Optional[float] = None
        self._ewma_service: Optional[float] = None
        self._ewma_assemble: Optional[float] = None
        self._ewma_build: Optional[float] = None
        self._ewma_compile: Optional[float] = None
        self._per_bucket: Dict[BucketKey, dict] = {}

    def record(self, bucket: BucketKey, wall_s: float,
               assemble_s: float = 0.0, depth: int = 1,
               compile_s: Optional[float] = None) -> None:
        """Account one completed flush of shape ``bucket``.

        ``depth`` is how many flushes were in flight when this one was
        submitted (1 = it had the device to itself). Submit→fetch wall
        time includes queueing behind the ``depth − 1`` earlier flushes,
        so ``wall / depth`` estimates the per-flush *service* time — the
        quantity the adaptive window must use, or queue wait would feed
        back into a larger window which creates more queue wait.

        ``assemble_s`` is the flush's host bucket-assembly time (the
        earlier ``pack_s``, minus the per-request row build that now
        happens at admission — see :meth:`record_build`).

        ``compile_s`` is the compile wall this flush paid (None on
        program-cache hits): subtracted to maintain a *compile-free* wall
        EWMA per bucket, the steady-state service estimate the cost
        model's own-flush steal credit reads — crediting a first flush's
        compile-inflated wall would overprice avoided flushes wildly.
        """
        a = self.alpha
        self.total_flushes += 1
        self.total_assemble_s += assemble_s
        self._ewma_wall = wall_s if self._ewma_wall is None \
            else a * wall_s + (1 - a) * self._ewma_wall
        service = wall_s / max(1, depth)
        self._ewma_service = service if self._ewma_service is None \
            else a * service + (1 - a) * self._ewma_service
        self._ewma_assemble = assemble_s if self._ewma_assemble is None \
            else a * assemble_s + (1 - a) * self._ewma_assemble
        rec = self._bucket_rec(bucket)
        rec["wall"].append(wall_s)
        rec["assemble"].append(assemble_s)
        rec["count"] += 1
        rec["ewma_wall"] = wall_s if rec["ewma_wall"] is None \
            else a * wall_s + (1 - a) * rec["ewma_wall"]
        wall_xc = max(0.0, wall_s - (compile_s or 0.0))
        rec["ewma_wall_xc"] = wall_xc if rec.get("ewma_wall_xc") is None \
            else a * wall_xc + (1 - a) * rec["ewma_wall_xc"]

    def record_build(self, bucket: BucketKey, build_s: float) -> None:
        """Account one request's admission-time row build for ``bucket``.

        Fed by the batcher right after :func:`~repro_torch.core.plan.
        build_packed_rows`; per-request (not per-flush), so the stream's
        sample count is the prebuilt-admission count, not the flush count.
        """
        a = self.alpha
        self.total_builds += 1
        self.total_build_s += build_s
        self._ewma_build = build_s if self._ewma_build is None \
            else a * build_s + (1 - a) * self._ewma_build
        rec = self._bucket_rec(bucket)
        rec["build"].append(build_s)
        rec["builds"] += 1

    def _bucket_rec(self, bucket: BucketKey) -> dict:
        rec = self._per_bucket.get(bucket)
        if rec is None:
            rec = self._per_bucket[bucket] = {
                "wall": deque(maxlen=self.window),
                "assemble": deque(maxlen=self.window),
                "build": deque(maxlen=self.window),
                "compile": deque(maxlen=self.window),
                "count": 0,
                "builds": 0,
                "compiles": 0,
                "ewma_wall": None,
                "ewma_wall_xc": None,
                "ewma_compile": None,
            }
        return rec

    def record_compile(self, bucket: BucketKey, wall_s: float) -> None:
        """Account one observed compile wall for shape ``bucket``.

        The executor stamps ``compile_seconds`` on each in-flight handle
        that missed the program cache; the batcher feeds the samples here
        on harvest. Windowed like wall/assemble; the per-shape EWMA is the
        learned prior :meth:`~repro_torch.serve.costmodel.FlushCostModel.
        compile_charge` prefers over its static ``compile_cost_s``.
        """
        a = self.alpha
        self._ewma_compile = wall_s if self._ewma_compile is None \
            else a * wall_s + (1 - a) * self._ewma_compile
        rec = self._bucket_rec(bucket)
        rec["compile"].append(wall_s)
        rec["compiles"] += 1
        rec["ewma_compile"] = wall_s if rec["ewma_compile"] is None \
            else a * wall_s + (1 - a) * rec["ewma_compile"]

    @property
    def ewma_wall(self) -> Optional[float]:
        """EWMA submit→fetch wall seconds across all buckets (None = no
        flush recorded yet)."""
        return self._ewma_wall

    @property
    def ewma_service(self) -> Optional[float]:
        """EWMA per-flush service seconds (wall normalized by the in-flight
        depth at submit) — the adaptive window's input."""
        return self._ewma_service

    @property
    def ewma_assemble(self) -> Optional[float]:
        """EWMA host bucket-assembly seconds per flush across all buckets
        (the earlier ``ewma_pack``)."""
        return self._ewma_assemble

    @property
    def ewma_build(self) -> Optional[float]:
        """EWMA per-request admission-time row-build seconds (None until
        a prebuilt admission is recorded)."""
        return self._ewma_build

    @property
    def ewma_pack(self) -> Optional[float]:
        """Deprecated earlier name of :attr:`ewma_assemble`."""
        return self._ewma_assemble

    def bucket_ewma_wall(self, bucket: BucketKey) -> Optional[float]:
        rec = self._per_bucket.get(bucket)
        return None if rec is None else rec["ewma_wall"]

    @property
    def ewma_compile(self) -> Optional[float]:
        """EWMA observed compile wall seconds across all buckets (None =
        no compile observed yet)."""
        return self._ewma_compile

    def bucket_ewma_compile(self, bucket: BucketKey) -> Optional[float]:
        rec = self._per_bucket.get(bucket)
        return None if rec is None else rec.get("ewma_compile")

    def bucket_ewma_wall_xc(self, bucket: BucketKey) -> Optional[float]:
        """Compile-free wall EWMA — the steady-state service estimate the
        cost model's own-flush steal credit is allowed to use (observed
        flushes only; no floor/global fallback)."""
        rec = self._per_bucket.get(bucket)
        return None if rec is None else rec.get("ewma_wall_xc")

    def samples(self, metric: str) -> list:
        """All retained samples of one metric, pooled across bucket shapes.

        ``metric`` is one of ``'wall'``, ``'assemble'``, ``'build'`` or
        ``'compile'`` (seconds, flush/record order within each bucket).
        Benchmarks use this for stream-wide percentiles that per-bucket
        :meth:`summary` entries cannot express. Bounded by the telemetry
        window: at most ``window`` samples per bucket shape survive.
        """
        out: list = []
        for rec in self._per_bucket.values():
            out.extend(rec.get(metric, ()))
        return out

    def summary(self) -> Dict[str, dict]:
        """Per-bucket-shape latency percentiles, JSON-ready (ms).

        Keys are ``"method:RxW"`` strings (bare ``"RxW"`` for legacy
        2-tuple keys); values carry flush counts, wall
        p50/p99, assemble p50/p99 and the wall EWMA — the fields the
        benchmarks emit so scheduling quality is tracked across changes.
        Since the admission-time packing split the earlier
        ``pack_p50_ms``/``pack_p99_ms`` fields are renamed
        ``assemble_p50_ms``/``assemble_p99_ms`` (per-flush bucket
        assembly), and shapes with prebuilt admissions additionally carry
        ``builds_total``/``build_p50_ms``/``build_p99_ms`` (per-request
        admission-time row build). Counts are explicit about scope:
        ``flushes_total`` is the lifetime count for the bucket shape
        while ``window_samples`` is the number of retained samples the
        percentiles are computed over (at most ``window``) — a long-lived
        bucket's percentiles describe its recent flushes, not its
        lifetime.
        """
        out: Dict[str, dict] = {}
        for bucket, rec in sorted(self._per_bucket.items(),
                                  key=lambda kv: tuple(map(str, kv[0]))):
            *prefix, R, W = bucket
            label = f"{prefix[0]}:{R}x{W}" if prefix else f"{R}x{W}"
            wall = np.asarray(rec["wall"], dtype=np.float64)
            assemble = np.asarray(rec["assemble"], dtype=np.float64)
            entry = {
                "flushes_total": rec["count"],
                "window_samples": int(len(wall)),
            }
            if len(wall):       # a shape may have compile samples only
                entry.update(
                    wall_p50_ms=float(np.percentile(wall, 50)) * 1e3,
                    wall_p99_ms=float(np.percentile(wall, 99)) * 1e3,
                    assemble_p50_ms=float(np.percentile(assemble, 50)) * 1e3,
                    assemble_p99_ms=float(np.percentile(assemble, 99)) * 1e3,
                    wall_ewma_ms=rec["ewma_wall"] * 1e3,
                )
            if rec.get("builds"):
                build = np.asarray(rec["build"], dtype=np.float64)
                entry.update(
                    builds_total=rec["builds"],
                    build_p50_ms=float(np.percentile(build, 50)) * 1e3,
                    build_p99_ms=float(np.percentile(build, 99)) * 1e3,
                )
            if rec.get("compiles"):
                entry["compiles_total"] = rec["compiles"]
                entry["compile_wall_ewma_ms"] = rec["ewma_compile"] * 1e3
            out[label] = entry
        return out


@runtime_checkable
class SchedulerPolicy(Protocol):
    """Structural protocol the batcher's decision layer is swapped by.

    ``queues`` is always the batcher's live bucket → request-list mapping,
    admission-ordered (oldest first); policies must treat it as read-only.
    Requests expose at least ``admitted_at`` (engine-clock stamp).
    """

    name: str

    def on_admit(self, queues, now: float,
                 telemetry: FlushTelemetry) -> bool:
        """Admission gate, called *before* a request is queued. Returning
        False makes the engine raise ``AdmissionRejected`` (shed load)."""
        ...

    def select_flushes(self, queues, now: float,
                       telemetry: FlushTelemetry) -> List[FlushDecision]:
        """Decide which buckets flush now (called after every admit and on
        every poll)."""
        ...

    def on_retire(self, bucket: BucketKey,
                  telemetry: FlushTelemetry) -> None:
        """Notification that a flush of shape ``bucket`` was harvested
        (its latency is already recorded in ``telemetry``)."""
        ...


class FullBucketPolicy:
    """Today's throughput default, extracted: flush only full buckets.

    ``max_in_flight`` (optional) is the static admission window the
    pre-scheduler engine exposed: while that many flushes are in flight,
    ``on_admit`` refuses and the engine sheds load.
    """

    name = "full"

    def __init__(self, max_batch: int, max_in_flight: Optional[int] = None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_in_flight is not None and max_in_flight < 1:
            raise ValueError(
                f"max_in_flight must be >= 1, got {max_in_flight}")
        self.max_batch = max_batch
        self.max_in_flight = max_in_flight

    # -- admission ------------------------------------------------------

    def admission_window(self, telemetry: FlushTelemetry) -> Optional[int]:
        """Current in-flight bound (None = unbounded)."""
        return self.max_in_flight

    def on_admit(self, queues, now, telemetry) -> bool:
        window = self.admission_window(telemetry)
        return window is None or telemetry.in_flight < window

    # -- flush selection ------------------------------------------------

    def select_flushes(self, queues, now, telemetry) -> List[FlushDecision]:
        out: List[FlushDecision] = []
        for bucket, q in queues.items():
            avail = len(q)
            while avail >= self.max_batch:
                out.append(FlushDecision(bucket=bucket, count=self.max_batch))
                avail -= self.max_batch
        return out

    def on_retire(self, bucket, telemetry) -> None:
        pass


class DeadlinePolicy(FullBucketPolicy):
    """Full buckets plus ``max_wait``-bounded tail latency, extracted.

    Any bucket whose oldest *unconsumed* request has waited ``max_wait``
    engine-clock seconds flushes partially (the packer pads the sub-batch
    to a power of two, keeping compiles O(#buckets · log B)).
    """

    name = "deadline"

    def __init__(self, max_batch: int, max_wait: Optional[float] = None,
                 max_in_flight: Optional[int] = None):
        super().__init__(max_batch, max_in_flight=max_in_flight)
        if max_wait is not None and max_wait < 0:
            raise ValueError(f"max_wait must be >= 0, got {max_wait}")
        self.max_wait = max_wait

    def select_flushes(self, queues, now, telemetry) -> List[FlushDecision]:
        out = super().select_flushes(queues, now, telemetry)
        if self.max_wait is None:
            return out
        consumed: Dict[BucketKey, int] = {}
        for d in out:
            consumed[d.bucket] = consumed.get(d.bucket, 0) + d.count
        for bucket, q in queues.items():
            used = consumed.get(bucket, 0)
            rest = len(q) - used
            if rest > 0 and now - q[used].admitted_at >= self.max_wait:
                out.append(FlushDecision(bucket=bucket, count=rest,
                                         deadline=True))
        return out


class AdaptivePolicy(DeadlinePolicy):
    """Dynamic in-flight window from observed flush latency.

    Replaces the static ``max_in_flight`` knob: the admission window is
    ``clamp(ceil(EWMA(service) / EWMA(assemble)), min_window,
    max_window)`` — the pipeline depth at which the host (assembling one
    flush in ``assemble`` seconds; the per-request row build happens at
    admission and is off this path) exactly keeps a device busy for
    ``service`` seconds per flush. Fewer in flight and the device idles
    between flushes; more and
    extra arrivals only queue *inside* the engine where the front-end
    cannot see or shed them. ``service`` is the submit→fetch wall time
    normalized by the in-flight depth at submit (queue-excluded) — raw
    wall time grows with the very depth this window sets, a positive
    feedback that would pin it at ``max_window``. Until telemetry exists
    (cold engine) the window is ``max_window``, so a cold start is never
    throttled by a guess.
    """

    name = "adaptive"

    def __init__(self, max_batch: int, max_wait: Optional[float] = None,
                 min_window: int = 1, max_window: int = 8):
        super().__init__(max_batch, max_wait=max_wait, max_in_flight=None)
        if not 1 <= min_window <= max_window:
            raise ValueError(
                f"need 1 <= min_window <= max_window, got "
                f"{min_window}..{max_window}")
        self.min_window = min_window
        self.max_window = max_window

    def admission_window(self, telemetry: FlushTelemetry) -> Optional[int]:
        service = telemetry.ewma_service
        assemble = telemetry.ewma_assemble
        if service is None or assemble is None or assemble <= 0.0:
            return self.max_window
        depth = math.ceil(service / assemble)
        return max(self.min_window, min(self.max_window, depth))


class CoalescingPolicy(DeadlinePolicy):
    """Work-stealing across bucket queues via shape promotion.

    Every flush decision (full or deadline) additionally *steals* requests
    waiting in compatible smaller buckets — ``(R', W')`` with ``R' ≤ R``
    and ``W' ≤ W``, **same method only** (a bucket program runs exactly
    one registered method per flush, so cross-method queues are never
    steal candidates no matter how starved; their own deadlines still
    bound them) — whose oldest request has waited at least
    ``steal_wait`` (default: ``max_wait / 2`` when a deadline is set,
    otherwise 0 = steal whenever there is room). Stolen requests are
    promoted into the flushing ``(R, W)`` shape by the batcher
    (:func:`repro_torch.core.plan.promote_plan`), most-starved queue first, up
    to the flush's ``max_batch`` capacity. A bucket whose arrival rate is
    starved by a hot neighbour therefore retires at the hot bucket's flush
    cadence instead of waiting for its own fill or the end-of-stream
    drain. Promotion never changes an answer: clustering is per-entry and
    padding rows/width is inert (the bit-exactness contract, asserted in
    ``tests/test_scheduler.py``).

    Pair it with ``max_wait``: steals only ride flushes with spare room,
    and without a deadline the only flushes are *full* ones (``count ==
    max_batch``, zero room) — the policy would silently degenerate to
    full-bucket. :func:`make_policy` therefore requires ``max_wait`` for
    ``'coalesce'``; constructing the class directly without one is allowed
    for composition and tests.
    """

    name = "coalesce"

    def __init__(self, max_batch: int, max_wait: Optional[float] = None,
                 max_in_flight: Optional[int] = None,
                 steal_wait: Optional[float] = None):
        super().__init__(max_batch, max_wait=max_wait,
                         max_in_flight=max_in_flight)
        if steal_wait is None:
            steal_wait = max_wait / 2 if max_wait is not None else 0.0
        if steal_wait < 0:
            raise ValueError(f"steal_wait must be >= 0, got {steal_wait}")
        self.steal_wait = steal_wait

    def select_flushes(self, queues, now, telemetry) -> List[FlushDecision]:
        base = super().select_flushes(queues, now, telemetry)
        consumed: Dict[BucketKey, int] = {}
        for d in base:
            consumed[d.bucket] = consumed.get(d.bucket, 0) + d.count
        out: List[FlushDecision] = []
        for d in base:
            R, W = d.bucket[-2:]
            room = self.max_batch - d.count
            steals: List[Tuple[BucketKey, int]] = []
            if room > 0:
                cands = []
                for b2, q2 in queues.items():
                    if b2 == d.bucket:
                        continue
                    if b2[:-2] != d.bucket[:-2]:
                        # Cross-method: a bucket program runs exactly one
                        # registered method, so a 'precluster' queue can
                        # never be promoted into a 'pivot' flush (the
                        # batcher would refuse the decision with a
                        # ValueError). Its own deadline still bounds it.
                        continue
                    R2, W2 = b2[-2:]
                    if R2 > R or W2 > W:
                        continue        # would not fit the (R, W) budget
                    used = consumed.get(b2, 0)
                    rest = len(q2) - used
                    if rest <= 0:
                        continue
                    oldest = q2[used].admitted_at
                    if now - oldest < self.steal_wait:
                        continue        # not starving yet
                    cands.append((oldest, b2, rest))
                cands.sort()            # most-starved queue first
                for _, b2, rest in cands:
                    if room <= 0:
                        break
                    take = min(rest, room)
                    steals.append((b2, take))
                    consumed[b2] = consumed.get(b2, 0) + take
                    room -= take
            out.append(dataclasses.replace(d, steal=tuple(steals))
                       if steals else d)
        return out


class CostAwareCoalescingPolicy(CoalescingPolicy):
    """Coalescing with every steal priced by a :class:`FlushCostModel`.

    The age-only parent steals whenever a starving compatible bucket
    exists and the flush has room — even when promoting the stragglers
    inflates the pow2 sub-batch (empty device entries), pads every stolen
    row to a larger ``R``, or lands on a batch-axis shape whose program
    was never compiled. This subclass asks the cost model whether the
    deadline slack the steal saves covers that bill, and otherwise trims
    the steal to the prefix that rides existing padding for free
    (``group_pad(count) − count`` slots cost nothing). A rejected
    candidate is never stranded: its own ``max_wait`` deadline still
    fires, so the coalesce latency bound survives every rejection.

    When telemetry is cold the model abstains and the policy degrades to
    plain age-only coalescing — a cold engine is never throttled by a
    guess (the same discipline as :class:`AdaptivePolicy`).

    ``on_retire`` additionally feeds bucket-shape heat
    (:class:`~repro_torch.serve.costmodel.ShapeHeat`) to the compiled-program
    LRU's ``touch``/``pin`` surface: the scheduler sees the retire stream,
    so it knows which shapes keep coming back long before the cache's own
    access order does — hot shapes outlive a churn of one-off cold shapes.

    Counters (``steals_accepted`` / ``steals_rejected`` /
    ``pad_entries_avoided``) are the policy's own observability surface,
    emitted by the benchmarks.
    """

    name = "cost"

    def __init__(self, max_batch: int, max_wait: Optional[float] = None,
                 max_in_flight: Optional[int] = None,
                 steal_wait: Optional[float] = None,
                 cost_model=None, heat=None):
        from .costmodel import FlushCostModel, ShapeHeat

        super().__init__(max_batch, max_wait=max_wait,
                         max_in_flight=max_in_flight, steal_wait=steal_wait)
        self.cost_model = cost_model if cost_model is not None \
            else FlushCostModel()
        self.heat = heat if heat is not None else ShapeHeat()
        self.steals_accepted = 0
        self.steals_rejected = 0
        self.pad_entries_avoided = 0

    def bind_engine(self, **kwargs) -> None:
        """Forwarded by the batcher at construction so pricing matches the
        engine's real execution profile (group padding, k, program sig)."""
        self.cost_model.bind_engine(**kwargs)

    def cost_stats(self) -> Dict[str, int]:
        """JSON-ready counters for benchmarks."""
        return {
            "steals_accepted": self.steals_accepted,
            "steals_rejected": self.steals_rejected,
            "pad_entries_avoided": self.pad_entries_avoided,
        }

    def select_flushes(self, queues, now, telemetry) -> List[FlushDecision]:
        base = super().select_flushes(queues, now, telemetry)
        # The parent plans steals assuming every earlier one executes, but
        # the batcher pops stolen requests from each source queue's
        # *front* — so once this policy trims a steal, later steals from
        # the same queue shift toward older entries at execution. Price
        # each steal group against the entries that will actually be
        # popped: native consumption (the parent's opening assumption)
        # plus the steals *kept* so far this tick.
        native: Dict[BucketKey, int] = {}
        for d in base:
            native[d.bucket] = native.get(d.bucket, 0) + d.count
        kept_from: Dict[BucketKey, int] = {}
        out: List[FlushDecision] = []
        for d in base:
            if not d.steal:
                out.append(d)
                continue
            flat: List[Tuple[BucketKey, float]] = []
            for src, cnt in d.steal:
                start = native.get(src, 0) + kept_from.get(src, 0)
                flat.extend((src, now - q.admitted_at)
                            for q in queues[src][start:start + cnt])
            keep = self._evaluate(d.bucket, d.count, flat, telemetry)
            self.steals_accepted += keep
            self.steals_rejected += len(flat) - keep
            # Keep the accepted prefix (most-starved first, the order the
            # parent built the steal list in), tracking kept counts per
            # source so later decisions re-anchor correctly.
            steals: List[Tuple[BucketKey, int]] = []
            kept = 0
            for src, cnt in d.steal:
                take = min(cnt, keep - kept)
                if take <= 0:
                    break
                steals.append((src, take))
                kept_from[src] = kept_from.get(src, 0) + take
                kept += take
            out.append(d if keep == len(flat)
                       else dataclasses.replace(d, steal=tuple(steals)))
        return out

    def release(self) -> None:
        """Drop this policy's program-cache pins (engine teardown)."""
        self.heat.release()

    def _evaluate(self, bucket, count, flat, telemetry) -> int:
        """How many of the candidate steals (a most-starved-first list of
        ``(source_bucket, age)``) to keep: the full set when it prices out,
        else the free prefix when *that* prices out, else none."""
        full = self.cost_model.price_steal(bucket, count, flat,
                                           self.max_wait, telemetry)
        if full.accepts(self.cost_model.hurdle):
            return len(flat)
        self.pad_entries_avoided += max(0, full.pad_entries_added)
        # Slots inside the already-padded group count are free of pow2
        # inflation; re-price just that prefix (promoted-row waste can
        # still reject it).
        free = max(0, self.cost_model.group_pad(count) - count)
        if free > 0 and free < len(flat):
            partial = self.cost_model.price_steal(bucket, count, flat[:free],
                                                  self.max_wait, telemetry)
            if partial.accepts(self.cost_model.hurdle):
                return free
        return 0

    def on_retire(self, bucket, telemetry) -> None:
        super().on_retire(bucket, telemetry)
        self.heat.on_retire(bucket)


POLICY_NAMES = ("full", "deadline", "adaptive", "coalesce", "cost")


def make_policy(spec=None, *, max_batch: int,
                max_wait: Optional[float] = None,
                max_in_flight: Optional[int] = None) -> SchedulerPolicy:
    """Resolve a policy argument: name, instance, or None (back-compat).

    ``None`` reproduces the pre-scheduler engine exactly: the deadline
    policy when ``max_wait`` is set, full-bucket otherwise, both carrying
    the static ``max_in_flight`` admission bound. ``'adaptive'`` uses
    ``max_in_flight`` (when given) as its ``max_window`` cap, since the
    dynamic window replaces the static knob.

    A :class:`SchedulerPolicy` *instance* carries its own knobs, so
    passing ``max_wait`` / ``max_in_flight`` alongside one is a conflict
    the instance would silently win — that raises ``ValueError`` instead
    (set the knobs on the policy itself).
    """
    if spec is None:
        spec = "deadline" if max_wait is not None else "full"
    if isinstance(spec, str):
        if spec == "full":
            return FullBucketPolicy(max_batch, max_in_flight=max_in_flight)
        if spec == "deadline":
            if max_wait is None:
                raise ValueError(
                    "policy='deadline' needs max_wait (the wait budget)")
            return DeadlinePolicy(max_batch, max_wait=max_wait,
                                  max_in_flight=max_in_flight)
        if spec == "adaptive":
            kwargs = {} if max_in_flight is None \
                else {"max_window": max_in_flight}
            return AdaptivePolicy(max_batch, max_wait=max_wait, **kwargs)
        if spec in ("coalesce", "cost"):
            if max_wait is None:
                raise ValueError(
                    f"policy={spec!r} needs max_wait: steals only ride "
                    "flushes with spare room, and without a deadline every "
                    "flush is full — the policy would silently act like "
                    "'full'")
            cls = CoalescingPolicy if spec == "coalesce" \
                else CostAwareCoalescingPolicy
            return cls(max_batch, max_wait=max_wait,
                       max_in_flight=max_in_flight)
        raise ValueError(f"unknown scheduling policy {spec!r}; expected one "
                         f"of {sorted(POLICY_NAMES)}")
    if isinstance(spec, SchedulerPolicy):
        conflicts = [name for name, val in
                     (("max_wait", max_wait), ("max_in_flight", max_in_flight))
                     if val is not None]
        if conflicts:
            raise ValueError(
                f"policy instance {type(spec).__name__} carries its own "
                f"schedule knobs; also passing {' and '.join(conflicts)} "
                "is a conflict the instance would silently ignore — set "
                "them on the policy itself")
        return spec
    raise TypeError(f"policy must be a name or SchedulerPolicy, "
                    f"got {type(spec).__name__}")


__all__ = [
    "BucketKey",
    "FlushDecision",
    "FlushTelemetry",
    "SchedulerPolicy",
    "FullBucketPolicy",
    "DeadlinePolicy",
    "AdaptivePolicy",
    "CoalescingPolicy",
    "CostAwareCoalescingPolicy",
    "POLICY_NAMES",
    "make_policy",
]
