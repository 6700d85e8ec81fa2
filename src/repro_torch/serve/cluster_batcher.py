"""Continuous batching for clustering-as-a-service — the *mechanics* half.

Implements the :class:`repro_torch.serve.engine.ClusterEngine` protocol for graph
queries: incoming graphs are **admitted** into the ``(method, R, W)`` queue
their registered bucket program and padded shape map to, buckets **flush**
through the injected :class:`~repro_torch.core.executor.BucketExecutor`, and
flushed requests **retire** with their results attached. One engine serves
mixed-method traffic: a request may carry its own ``method`` (defaulting to
the engine's), and because a bucket program runs exactly one registered
method per flush, queues coalesce only within a method — policies never
see, and must never propose, a cross-method steal (``_execute`` refuses one
with a ``ValueError`` if a custom policy tries). *When* a bucket flushes, at what
sub-batch size, whether an admission is refused, and whether a flush steals
work from a starving neighbour bucket are not decided here: every decision
is delegated to the injected :class:`~repro_torch.serve.scheduler.SchedulerPolicy`
(``policy=``), and this class only executes the
:class:`~repro_torch.serve.scheduler.FlushDecision` values it returns. The
batcher owns the queues, the staging leases, the packing, the harvest, and
the stats — the policy owns the schedule.

Scheduling policies (see :mod:`repro_torch.serve.scheduler` for the full story)
  ``policy=`` takes ``'full'`` (flush only full buckets), ``'deadline'``
  (bound any request's wait by ``max_wait``), ``'adaptive'`` (deadline +
  a dynamic in-flight admission window derived from observed flush
  latency, replacing the static ``max_in_flight`` knob), ``'coalesce'``
  (work-stealing: starving smaller-bucket requests are promoted into a
  compatible larger bucket's flush via
  :func:`repro_torch.core.plan.promote_plan`), ``'cost'`` (coalescing with each
  steal priced by :class:`~repro_torch.serve.costmodel.FlushCostModel` — taken
  only when the wait it saves covers the pad/compile cost it adds — plus
  shape-heat eviction hints to the program registry), any
  :class:`~repro_torch.serve.scheduler.SchedulerPolicy` instance, or ``None`` —
  which reproduces the historical behaviour from ``max_wait`` /
  ``max_in_flight`` alone. A policy *instance* carries its own knobs:
  combining one with ``max_wait``/``max_in_flight`` raises ``ValueError``
  instead of silently ignoring the knobs.

Executor injection (how a flush reaches the device)
  ``ClusterBatcher(executor=...)`` takes ``'sync'`` (block per flush — the
  classic path), ``'async'`` (non-blocking dispatch: the batcher packs and
  flushes the next bucket while the previous one computes and transfers;
  completed flushes are harvested on the next ``admit``/``poll``/``retire``),
  ``'sharded'`` (one flush split over the local CUDA devices, or
  ``[device]``), or any :class:`BucketExecutor` instance. Results are
  bit-identical under every executor *and every policy* — scheduling can
  never change an answer, including coalesced flushes where a request runs
  at a promoted ``(R, W)`` shape. An executor instance must not be shared
  between engines: the batcher harvests *all* of its executor's handles.

Admission backpressure (bounded in-flight work)
  The policy's ``on_admit`` gate refuses requests while its admission
  window is full — ``admit`` raises :class:`AdmissionRejected` (counted in
  ``stats.rejected``), the signal a front-end needs to shed load instead
  of queueing unboundedly when arrivals outrun the device. The static
  window is ``max_in_flight``; the adaptive policy derives a dynamic one
  from flush-latency telemetry.

Admission-time packing (build/assemble split)
  With ``prebuild_rows=True`` (default) every cold admission finishes its
  per-graph packing work right away: :func:`repro_torch.core.plan.
  build_packed_rows` scatters the plan's canonical edge list into the
  graph's :class:`~repro_torch.core.plan.PackedRows` and dispatches its rank
  permutations, once per request. Flushes then *assemble* buckets by row
  copies into the leased staging arrays — the argsort/bincount host work
  leaves the flush critical path, which is what the admission-time split
  buys (JetStream-style: per-request preprocessing at admission, batch
  assembly a memcpy). ``prebuild_rows=False`` keeps the legacy
  derive-at-flush packing; both paths are bit-identical.

Telemetry (the policies' stats surface)
  Every harvested flush records its host bucket-assembly time and
  submit→fetch wall time — stamped by the executor layer on the
  :class:`~repro_torch.core.executor.InFlightBucket` handle — into
  ``stats.latency`` (a :class:`~repro_torch.serve.scheduler.FlushTelemetry`),
  keyed by bucket shape; prebuilt admissions record their per-request
  row-build time into the same telemetry's ``build`` stream. Policies
  read the EWMAs; benchmarks emit the p50/p99 summaries.

Buffer reuse
  All flushes route through one :class:`repro_torch.core.plan.BucketBufferPool`:
  host staging arrays per bucket shape (pinned memory on a CUDA device)
  are **leased** per flush and refilled in place. A lease is only
  released once its flush's outputs are fetched, so pipelined flushes of
  the same bucket shape get distinct buffer generations — a buffer feeding
  an in-flight program is never refilled.

Result cache + single-flight coalescing (repeat traffic)
  ``ClusterBatcher(result_cache=...)`` content-addresses every admission
  by :func:`repro_torch.core.plan.graph_fingerprint` — the canonical hash of
  the planned request's ELL content, exact PRNG key, and
  ``method``/``num_samples``/``eps``. A fingerprint found in the
  :class:`~repro_torch.serve.resultcache.ResultCache` retires at admission,
  bit-identical to a cold flush (only post-selection winners are cached,
  keyed on the exact key). A fingerprint matching a *queued or in-flight*
  request subscribes to that flush's harvest instead of packing a
  duplicate row; subscribers stay attached to their primary through the
  requeue-on-error path, so a failed flush retries them. Subscribers
  never appear in the bucket queues and neither cached nor subscribed
  admissions consult the policy's ``on_admit`` gate — they add no device
  work, so policies see exactly the queue depths/ages that will pack.

Clocks
  The engine clock (``clock=``, monotonic seconds, injectable) is the
  *only* time source scheduling decisions see: ``admitted_at`` stamps,
  deadline ages, steal thresholds. No code path falls back to a bare
  ``time.monotonic()`` call, so tests and simulators drive virtual time
  deterministically. (Telemetry wall/pack latencies are real wall-clock
  measurements from the executor layer — they describe the device, not
  the request stream.)

Devices
  The port's engine takes ``device=`` (``None`` means CUDA and raises
  without it) where the reference takes ``use_kernel``: on the card every
  flush launches the hand-written kernels, on the CPU their plain
  versions run. ``warmup(autotune=True)`` sweeps the launch plans of
  kernels B1 and B2 per bucket tier on the engine's device
  (:mod:`repro_torch.kernels.autotune`) before running the programs.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import BucketBufferPool, make_executor, plan_graph
from repro_torch.core.api import ClusterResult, sample_keys
from repro_torch.core.executor import pack_and_submit
from repro_torch.core.graph import Graph
from repro_torch.core.plan import (GraphFingerprint, GraphPlan,
                             build_packed_rows, graph_fingerprint,
                             promote_plan, result_for_plan)
from repro_torch.core.programs import method_spec, objective_spec
from repro_torch.util import DeviceLike, next_pow2, resolve_device

from .engine import AdmissionRejected, EngineStats
from .resultcache import ResultCacheStats, make_result_cache
from .scheduler import FlushDecision, FlushTelemetry, make_policy


@dataclasses.dataclass
class ClusterRequest:
    uid: int
    graph: Graph
    key: np.ndarray                 # a key of repro_torch.core.rng
    lam: Optional[int] = None
    method: Optional[str] = None    # None = the engine's default method
    result: Optional[ClusterResult] = None
    done: bool = False
    admitted_at: Optional[float] = None     # engine clock time of admission
    plan: Optional[GraphPlan] = None        # resolved once at admission
    fingerprint: Optional[GraphFingerprint] = None  # content address (cache)
    # Single-flight: identical requests admitted while this one is queued
    # or in flight ride its harvest instead of packing duplicate rows.
    subscribers: List["ClusterRequest"] = dataclasses.field(
        default_factory=list)


@dataclasses.dataclass
class ClusterStats(EngineStats):
    flushes: int = 0
    deadline_flushes: int = 0    # partial flushes forced by max_wait
    coalesced_flushes: int = 0   # flushes that stole from another bucket
    stolen_requests: int = 0     # requests promoted into a larger bucket
    clustered: int = 0
    padded_slots: int = 0        # empty device entries, from the packer
    pad_vertex_waste: int = 0    # Σ (R − n) over clustered graphs
    buckets_seen: int = 0        # distinct (method, R, W) queues admitted
    rejected: int = 0            # admissions refused by backpressure
    in_flight_peak: int = 0      # max concurrent in-flight flushes seen
    cache_misses: int = 0        # admissions that went the cold path
    subscribed: int = 0          # single-flight riders on identical requests
    latency: FlushTelemetry = dataclasses.field(
        default_factory=FlushTelemetry)  # per-bucket flush wall/pack times
    # Live counters of the engine's result cache (None = caching off).
    # Cache-lifetime, not engine-lifetime, when the cache is shared
    # between engines; the scalar cache_hits/cache_misses above are this
    # engine's own. Mutable and aliased to the cache — delta accounting
    # must go through EngineStats.snapshot(), not dataclasses.replace.
    result_cache: Optional[ResultCacheStats] = None
    # Autotune telemetry from the last warmup(autotune=True): tuning-cache
    # counters and the sweep log (None = never autotuned).
    tuning: Optional[dict] = None


class ClusterBatcher:
    """Bucketed clustering engine: queue/lease/harvest mechanics, with all
    flush/admission decisions delegated to a scheduling policy.

    Implements the :class:`~repro_torch.serve.engine.ClusterEngine` protocol
    (``admit`` / ``flush`` / ``retire`` / ``stats`` / ``pending``), plus
    :meth:`poll` to give time-based policies (deadline, coalescing) a tick.

    Args:
      max_batch: bucket capacity; the default policies flush a bucket when
        it holds this many requests.
      max_wait: optional deadline in seconds (engine-clock). With the
        default policy selection, setting it selects the deadline policy:
        ``poll()`` flushes any bucket whose oldest request has waited
        longer, padded to the next power-of-two sub-batch. ``None`` = full
        buckets only.
      clock: the engine clock (monotonic seconds). Injectable so tests and
        simulators can drive virtual time; ``None`` selects
        ``time.monotonic``. Every scheduling decision uses this clock and
        nothing else.
      num_samples: best-of-k PIVOT per request (``< 1`` is coerced to 1;
        the engine itself rejects invalid values).
      method: the engine's default bucket program (any method registered
        in :mod:`repro_torch.core.programs`); a request carrying its own
        ``method`` overrides it per-admission — one engine serves mixed
        ``'pivot'``/``'precluster'`` traffic, with queues, result-cache
        fingerprints and steal compatibility all keyed per method.
      objective: the registered cost pass scoring samples before
        best-of-k selection (``'disagree'`` default, ``'minmax'``);
        engine-wide, carried into every fingerprint and flush.
      device: where flushes run; ``None`` means CUDA (see
        :func:`repro_torch.util.resolve_device`). The executor and the
        pool follow it.
      pool: buffer pool shared by all flushes (created if omitted).
      executor: bucket executor name (``'sync'``/``'async'``/``'sharded'``)
        or instance — see the module docstring. Default ``'sync'``.
      max_in_flight: optional static bound on concurrently in-flight
        flushes; the policy's ``on_admit`` gate raises
        :class:`AdmissionRejected` at the bound. ``None`` disables
        backpressure (one-shot / offline driving).
      policy: scheduling policy name (``'full'``/``'deadline'``/
        ``'adaptive'``/``'coalesce'``/``'cost'``) or
        :class:`~repro_torch.serve.scheduler.SchedulerPolicy` instance; ``None``
        derives the historical behaviour from ``max_wait``/``max_in_flight``.
        An instance must carry its own ``max_wait``/``max_in_flight`` —
        passing those knobs alongside one raises ``ValueError``.
      result_cache: content-addressed result cache + single-flight
        coalescing. ``True`` (default) creates a default-sized
        :class:`~repro_torch.serve.resultcache.ResultCache`; ``False``/``None``
        disables both (every admission packs and flushes); an ``int``
        sets the entry capacity; a :class:`ResultCache` instance is
        shared as-is (e.g. one cache across engines/corpora). A cache
        hit retires at admission, bit-identical to a cold flush — the
        fingerprint covers the exact PRNG key, so caching never trades
        determinism for speed.
      prebuild_rows: build each cold admission's
        :class:`~repro_torch.core.plan.PackedRows` at admission (default), so
        flushes assemble buckets by row copies instead of re-deriving
        every graph's ELL rows. ``False`` restores the legacy
        derive-at-flush packing — bit-identical results either way (the
        benchmark's ``pack_split`` scenario runs both arms).
    """

    def __init__(self, max_batch: int = 64, method: str = "pivot",
                 eps: float = 2.0, num_samples: int = 1,
                 objective: str = "disagree",
                 device: DeviceLike = None,
                 max_wait: Optional[float] = None,
                 clock=None,
                 pool: Optional[BucketBufferPool] = None,
                 executor="sync",
                 max_in_flight: Optional[int] = None,
                 policy=None,
                 result_cache=True,
                 prebuild_rows: bool = True):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_wait is not None and max_wait < 0:
            raise ValueError(f"max_wait must be >= 0, got {max_wait}")
        if max_in_flight is not None and max_in_flight < 1:
            raise ValueError(
                f"max_in_flight must be >= 1, got {max_in_flight}")
        self.max_batch = max_batch
        self.method = method
        method_spec(method)          # fail fast, listing registered methods
        objective_spec(objective)
        self.objective = objective
        self.eps = eps
        self.num_samples = max(1, num_samples)
        self.device = resolve_device(device)
        self.max_wait = max_wait
        self.clock = time.monotonic if clock is None else clock
        self.pool = pool if pool is not None else BucketBufferPool(
            device=self.device)
        self.executor = make_executor(executor, device=self.device)
        self.max_in_flight = max_in_flight
        self.prebuild_rows = prebuild_rows
        self.policy = make_policy(policy, max_batch=max_batch,
                                  max_wait=max_wait,
                                  max_in_flight=max_in_flight)
        # Policies that price decisions (the cost-aware coalescer) need the
        # engine's execution profile — group padding rule, best-of-k count,
        # compiled-program signature. Optional structural hook.
        bind = getattr(self.policy, "bind_engine", None)
        if bind is not None:
            bind(executor=self.executor, num_samples=self.num_samples,
                 objective=self.objective)
        self.result_cache = make_result_cache(result_cache)
        # Queues keyed by GraphPlan.queue_key = (method, R, W): requests
        # coalesce only when they share both the padded shape and the
        # bucket program that will run them.
        self.buckets: Dict[Tuple[str, int, int], List[ClusterRequest]] = {}
        self._bucket_keys_seen: set = set()
        self._retired: Deque[ClusterRequest] = deque()
        self._in_flight_reqs = 0
        self._subscribed_pending = 0
        # Single-flight registry: fingerprint digest → the primary request
        # currently queued or in flight for that content. Entries live
        # until the primary's result is delivered (a requeued-on-error
        # primary stays registered, so its subscribers retry with it).
        self._single_flight: Dict[str, ClusterRequest] = {}
        self.stats = ClusterStats(
            policy=self.policy.name,
            result_cache=self.result_cache.stats
            if self.result_cache is not None else None)

    # -- ClusterEngine protocol ------------------------------------------

    def admit(self, req: ClusterRequest,
              now: Optional[float] = None) -> List[ClusterRequest]:
        """Admit a request; returns whatever retired as a consequence.

        Shape/width validation happens here (``plan_graph`` raises for
        graphs exceeding the largest supported bucket) and so does
        backpressure — the policy's ``on_admit`` gate refuses while its
        admission window is full (:class:`AdmissionRejected`, counted in
        ``stats.rejected``). A request the engine cannot take fails at
        admission, not inside a later batched flush.

        The leading harvest here raises immediately (unlike ``poll``'s,
        which defers): it runs *before* the request is queued, so the
        caller can safely retry the same ``admit`` — deferring would
        admit the request and then raise, inviting a double admission.

        With a result cache enabled, admission is content-addressed
        first: a fingerprint hit retires the request immediately —
        bit-identical to a cold flush, no queueing, no device work — and
        a fingerprint matching a *queued or in-flight* request subscribes
        to that flush's harvest (single-flight) instead of packing a
        duplicate row. Neither path consults the policy's ``on_admit``
        backpressure gate: they add no device work to the window the gate
        protects. Subscribers never appear in the bucket queues, so
        policies cannot double-count them in queue depth or ages.
        """
        self._harvest()
        now = self.clock() if now is None else now
        if req.plan is None:
            # Resolved once; a retry after AdmissionRejected (and the
            # flush itself) reuses the plan verbatim.
            req.plan = self._plan_for(req.graph, lam=req.lam,
                                      method=req.method)
            req.lam = req.plan.lam
        plan = req.plan
        if self.result_cache is not None:
            if req.fingerprint is None:
                req.fingerprint = graph_fingerprint(
                    plan, req.key, method=plan.method,
                    num_samples=self.num_samples, eps=self.eps,
                    objective=self.objective)
            cached = self.result_cache.get(req.fingerprint)
            if cached is not None:
                req.admitted_at = now
                self.stats.submitted += 1
                self.stats.cache_hits += 1
                self._deliver(req, *cached)
                self._run_policy(now)
                return self.retire()
            primary = self._single_flight.get(req.fingerprint.digest)
            if primary is not None:
                req.admitted_at = now
                primary.subscribers.append(req)
                self._subscribed_pending += 1
                self.stats.submitted += 1
                self.stats.subscribed += 1
                self._run_policy(now)
                return self.retire()
        if not self.policy.on_admit(self.buckets, now, self._telemetry()):
            self.stats.rejected += 1
            raise AdmissionRejected(
                f"policy {self.policy.name!r} refused admission with "
                f"{self.executor.in_flight} flushes in flight; retry after "
                "retiring")
        req.admitted_at = now
        if self.prebuild_rows and plan.rows is None:
            # The request's per-graph packing work, done once here — the
            # ELL scatter from the plan's canonical edges plus the async
            # rank dispatch — so its flushes only copy rows. Placed after
            # the cache/single-flight/backpressure gates: only requests
            # that will actually pack pay the build.
            t_build = time.perf_counter()
            plan.rows = build_packed_rows(
                plan, sample_keys(req.key, self.num_samples))
            self.stats.latency.record_build(
                plan.queue_key, time.perf_counter() - t_build)
        self.buckets.setdefault(plan.queue_key, []).append(req)
        if req.fingerprint is not None:
            self._single_flight[req.fingerprint.digest] = req
            # Counted here (not at the probe) so a rejected-then-retried
            # admission registers one miss, not one per retry.
            self.stats.cache_misses += 1
        self.stats.submitted += 1
        self._bucket_keys_seen.add(plan.queue_key)
        self.stats.buckets_seen = len(self._bucket_keys_seen)
        self._run_policy(now)
        return self.retire()

    def flush(self) -> List[ClusterRequest]:
        """Drain every bucket (end of stream), full or partial, and block
        for all in-flight work. End-of-stream draining is mechanics, not
        policy — every queue flushes at its native shape.

        Errors are deferred until every bucket has been drained (same
        discipline as the policy tick): one bad flush — a failed harvest
        of an earlier dispatch *or* a pack/submit failure of one bucket —
        must not strand the remaining queues undispatched or leave work
        computing unharvested. The first error is re-raised after the
        blocking harvest; the failed flush's requests are requeued, so a
        retrying caller loses nothing.
        """
        first_err: Optional[BaseException] = None
        for bucket in list(self.buckets):
            try:
                err = self._execute(
                    FlushDecision(bucket=bucket,
                                  count=len(self.buckets[bucket])))
            except Exception as dispatch_err:
                # Pack/submit failed; _execute already requeued the popped
                # requests (this bucket will be retried by a later flush).
                err = dispatch_err
            first_err = first_err or err
        # Always block for the in-flight work, even on an earlier error —
        # flush()'s contract is that nothing is left computing.
        harvest_err = self._harvest(block=True, defer=True)
        first_err = first_err or harvest_err
        if first_err is not None:
            raise first_err
        return self.retire()

    def retire(self) -> List[ClusterRequest]:
        """Drain finished requests not yet handed back to the caller
        (harvesting any flushes that completed since the last call)."""
        self._harvest()
        out = list(self._retired)
        self._retired.clear()
        return out

    def pending(self) -> int:
        """Admitted-but-unfinished requests: bucketed + in flight +
        single-flight subscribers riding a queued/in-flight primary."""
        return sum(len(v) for v in self.buckets.values()) \
            + self._in_flight_reqs + self._subscribed_pending

    def close(self) -> None:
        """Release engine resources held in process-global state — today
        that is the cost policy's program-cache pins (``ShapeHeat`` also
        backstops this from ``__del__``, but a long-lived process swapping
        engines should release deterministically), and the dispatch
        threads of an executor that has them. Idempotent **at the
        pin-refcount level**: closing twice, or ``__del__`` after an
        explicit ``close()``, never decrements a pin refcount a second
        time — so it can never strip a shape another live engine still
        pins (asserted in ``tests/test_executor.py``). The engine remains
        usable for draining afterwards; draining may re-pin, which the
        ``__del__`` backstop releases again."""
        release = getattr(self.policy, "release", None)
        if release is not None:
            release()
        close = getattr(self.executor, "close", None)
        if close is not None:
            close()

    def __del__(self):
        try:
            self.close()
        except Exception:       # interpreter teardown: modules may be gone
            pass

    # -- Policy driving ----------------------------------------------------

    def poll(self, now: Optional[float] = None) -> List[ClusterRequest]:
        """Give the policy a time tick: harvest completed flushes, let the
        policy flush whatever its schedule says is due (overdue deadline
        buckets, coalesced steals, ...), and return the retired requests.

        The tick's leading harvest defers its errors like the mid-tick
        ones: a failed earlier flush surfacing here must not stop the due
        decisions from dispatching (its requests are requeued first, so
        the policy already sees them back in their buckets).
        """
        now = self.clock() if now is None else now
        first_err = self._harvest(defer=True)
        self._run_policy(now, pending_err=first_err)
        return self.retire()

    def oldest_wait(self, now: Optional[float] = None) -> float:
        """Age of the oldest pending request (0.0 when idle), on the
        engine clock."""
        now = self.clock() if now is None else now
        ages = [now - reqs[0].admitted_at
                for reqs in self.buckets.values() if reqs]
        return max(ages, default=0.0)

    def warmup(self, graphs, autotune: bool = False, candidates=None,
               repeats: int = 3) -> int:
        """Run every pow2 sub-batch program the workload can hit once.

        Deadline flushes run partial buckets at power-of-two sub-batch
        sizes. Given sample graphs covering the expected shape buckets,
        this runs every sub-batch program *for this engine's executor*
        (the sharded executor floors sub-batches at its device count) on
        pad-only tensors, so that the kernels' libraries are loaded and
        the program registry the cost policy reads holds those shapes.
        Returns the number of programs that entered the registry.

        ``autotune=True`` first sweeps the launch plans of kernels B1 and
        B2 (:mod:`repro_torch.kernels.autotune`; ``candidates`` are the
        staged route's rows-per-block caps) per bucket tier over *real
        packed bucket tensors* built from the sample graphs, records each
        winner in the process tuning cache, and only then runs the
        programs, so the registry holds the tuned keys the flushes will
        run. Tiers whose winners are already cached are skipped: a second
        process warming up against a populated
        ``REPRO_TORCH_TUNING_CACHE`` performs zero sweeps (the cache's hit
        counters show it). Sweep telemetry lands in ``stats.tuning``.
        """
        from repro_torch.core.executor import program_cache_size

        before = program_cache_size()
        k = self.num_samples
        by_bucket: Dict[Tuple[int, int], List[GraphPlan]] = {}
        for g in graphs:
            # Same resolution helper as admission — warmup can never plan
            # a graph differently from the admission that will follow it.
            plan = self._plan_for(g)
            by_bucket.setdefault(plan.bucket, []).append(plan)
        for bucket in sorted(by_bucket):
            R, W = bucket
            pads, g_pad = set(), 1
            while g_pad <= next_pow2(self.max_batch):
                pads.add(self.executor.group_pad(g_pad))
                g_pad *= 2
            if autotune:
                self._autotune_bucket(by_bucket[bucket], sorted(pads),
                                      candidates, repeats)
            for gp in sorted(pads):
                b = gp * k
                ell = np.full((b, R, W), R, dtype=np.int32)
                ranks = np.full((b, R + 1), np.iinfo(np.int32).max,
                                dtype=np.int32)
                elig = np.zeros((b, R + 1), dtype=bool)
                m = np.zeros((b,), dtype=np.int32)
                self.executor.submit(ell, ranks, elig, m, k=k, track=False,
                                     method=self.method,
                                     objective=self.objective).result()
        if autotune:
            from repro_torch.kernels.autotune import tuning_info

            self.stats.tuning = tuning_info()
        return program_cache_size() - before

    def _autotune_bucket(self, plans, pads, candidates, repeats) -> None:
        """Sweep B1/B2 launch plans for one bucket, per distinct batch
        tier, over real packed tensors on the engine's device — skipping
        already-tuned tiers (checked through ``TuningCache.get`` with
        counting on, so warmup hits/misses are observable).

        The tensors pack into leased pool staging — the same
        ``pack_bucket`` + :class:`~repro_torch.core.plan.BucketBufferPool`
        path flushes use — so the pool's lease invariant covers the sweep
        too. The lease is released right after the sweep returns: the
        sweep copies the staging to the device and synchronises on every
        timing, so nothing in flight reads it afterwards.
        """
        from repro_torch.core import rng
        from repro_torch.core.executor import _to_device
        from repro_torch.core.plan import pack_bucket
        from repro_torch.kernels import autotune as _at

        cache = _at.tuning_cache()
        R, W = plans[0].bucket
        k = self.num_samples
        done_tiers = set()
        for gp in pads:
            tier = _at.batch_tier(gp * k)
            if tier in done_tiers:
                continue
            done_tiers.add(tier)
            if all(cache.get(kern, R, W, tier, device=self.device)
                   is not None for kern in _at.KERNELS):
                continue        # tuned by an earlier process: zero sweeps
            # Fill the padded group axis with real plans (cycling the
            # samples) so the measured tensors match what flushes run.
            use = list(plans)
            while len(use) < gp:
                use.extend(plans)
            use = use[:gp]
            keys = [sample_keys(rng.PRNGKey(i), k) for i in range(len(use))]
            lease = self.pool.acquire(gp * k, R, W)
            try:
                ell, ranks, elig, _m, _pad = pack_bucket(
                    use, keys, k=k, g_pad=gp, staging=lease.arrays)
                _at.sweep_bucket(*(_to_device(a, self.device)
                                   for a in (ell, ranks, elig)),
                                 cache=cache, candidates=candidates,
                                 repeats=repeats)
            finally:
                lease.release()

    # -- Internals ---------------------------------------------------------

    def _plan_for(self, graph: Graph, lam: Optional[int] = None,
                  method: Optional[str] = None) -> GraphPlan:
        """The engine's single ``plan_graph`` call site — admission and
        warmup both resolve method/eps/lam through here, so the two can
        never diverge. ``method=None`` means the engine default."""
        return plan_graph(graph, method=method if method is not None
                          else self.method, eps=self.eps, lam=lam)

    def _telemetry(self) -> FlushTelemetry:
        """The policies' stats surface, with ``in_flight`` refreshed — the
        single place that syncs it, so no policy call sees a stale count."""
        telemetry = self.stats.latency
        telemetry.in_flight = self.executor.in_flight
        return telemetry

    def _run_policy(self, now: float,
                    pending_err: Optional[BaseException] = None) -> None:
        """Ask the policy what to flush and execute each decision.

        Every decision executes before any harvest error surfaces: a
        failed *earlier* flush harvested opportunistically mid-tick must
        not silently drop the remaining decisions (a due deadline flush
        would be skipped past its budget — the regression in
        ``tests/test_scheduler.py::test_harvest_error_does_not_drop_
        remaining_decisions``). Dispatch (pack/submit) failures of one
        decision are contained the same way — the popped requests are
        already requeued, the rest of the schedule still runs.
        ``pending_err`` lets a caller's leading harvest join the same
        discipline (``poll``); the first error is re-raised once the
        tick's schedule has been fully dispatched.
        """
        first_err = pending_err
        for decision in self.policy.select_flushes(self.buckets, now,
                                                   self._telemetry()):
            try:
                err = self._execute(decision)
            except Exception as dispatch_err:
                err = dispatch_err
            first_err = first_err or err
        if first_err is not None:
            raise first_err

    def _take(self, bucket: Tuple[str, int, int],
              count: int) -> List[ClusterRequest]:
        """Pop up to ``count`` oldest requests from one bucket queue."""
        q = self.buckets.get(bucket)
        if not q or count <= 0:
            return []
        taken, rest = q[:count], q[count:]
        if rest:
            self.buckets[bucket] = rest
        else:
            self.buckets.pop(bucket, None)
        return taken

    def _requeue(self, reqs: Sequence[ClusterRequest]) -> None:
        """Put popped requests back at the *front* of their own bucket
        queues (each request's native plan bucket), preserving age order —
        stolen requests return to the queue they were stolen from."""
        by_bucket: Dict[Tuple[str, int, int], List[ClusterRequest]] = {}
        for r in reqs:
            by_bucket.setdefault(r.plan.queue_key, []).append(r)
        for bucket, rs in by_bucket.items():
            self.buckets[bucket] = rs + self.buckets.get(bucket, [])

    def _execute(self,
                 decision: FlushDecision) -> Optional[BaseException]:
        """Carry out one policy decision: pop the requests it names
        (including steals from smaller buckets), promote plans to the
        decision's ``(R, W)`` shape, pack, and hand to the executor.

        Packing/dispatch errors raise (nothing was dispatched, the popped
        requests are requeued); errors from the opportunistic trailing
        harvest — they belong to a *previous* flush — are returned instead
        of raised, so the caller can finish its tick before surfacing them.
        """
        reqs = self._take(decision.bucket, decision.count)
        stolen: List[ClusterRequest] = []
        for src, cnt in decision.steal:
            stolen.extend(self._take(src, cnt))
        all_reqs = reqs + stolen
        if not all_reqs:
            return None
        k = self.num_samples
        method, R, W = decision.bucket
        bad = next((r for r in all_reqs if r.plan.method != method), None)
        if bad is not None:
            # The built-in policies never propose this (their steal filters
            # require queue_key method equality); a custom policy that does
            # is refused here with the requests safely requeued — a bucket
            # program runs exactly one registered method per flush.
            self._requeue(all_reqs)
            raise ValueError(
                f"flush decision for method {method!r} names a "
                f"{bad.plan.method!r} request: a bucket program runs "
                "exactly one registered method — cross-method "
                "coalescing/stealing is refused")
        # Promotion is a no-op for native requests; for stolen ones it
        # re-targets the plan at the flush's larger shape (bit-exact),
        # relaying any prebuilt rows via pad-copies. Prebuilt plans drew
        # their rank permutations at admission, so no sample keys are
        # derived for them here — that fold_in work is off the flush path.
        plans = [promote_plan(r.plan, R, W) for r in all_reqs]
        bkeys = [None if p.rows is not None else sample_keys(r.key, k)
                 for r, p in zip(all_reqs, plans)]
        try:
            _, pack = pack_and_submit(
                plans, bkeys, k, self.executor, pool=self.pool,
                payload=all_reqs, objective=self.objective)
        except BaseException:
            # Nothing was dispatched (the helper released the staging
            # lease): requeue the popped requests so none are lost, then
            # surface the error to the caller.
            self._requeue(all_reqs)
            raise
        self._in_flight_reqs += len(all_reqs)
        self.stats.flushes += 1
        if decision.deadline:
            self.stats.deadline_flushes += 1
        if stolen:
            self.stats.coalesced_flushes += 1
            self.stats.stolen_requests += len(stolen)
        # Pad accounting straight from the packer — no re-derivation here.
        self.stats.padded_slots += pack.padded_entries
        self.stats.pad_vertex_waste += pack.pad_vertex_waste
        self.stats.in_flight_peak = max(self.stats.in_flight_peak,
                                        self.executor.in_flight)
        return self._harvest(defer=True)

    def _deliver(self, req: ClusterRequest, labels_row: np.ndarray,
                 cost: int, picked: int, rounds: int) -> None:
        """Attach one result (device row or cache entry) and retire it."""
        req.result = result_for_plan(req.plan, labels_row, cost, picked,
                                     rounds, self.num_samples,
                                     req.plan.method)
        req.done = True
        self.stats.retired += 1
        self._retired.append(req)

    def _harvest(self, block: bool = False,
                 defer: bool = False) -> Optional[BaseException]:
        """Collect completed flushes from the executor into the retired
        queue (``block=True`` waits for everything in flight).

        A flush whose fetch fails (device-side runtime error surfacing at
        ``result()``) has its requests requeued into their native buckets
        — ahead of newer arrivals, preserving deadline age order — and the
        first such error is re-raised after every other handle has been
        processed, so one bad flush can neither lose requests nor strand
        the handles behind it. Single-flight subscribers stay attached to
        their requeued primary, so a failed flush *retries* them rather
        than dropping them. With ``defer=True`` the first error is
        *returned* instead of raised — mid-tick callers (``_execute``,
        ``flush``) finish dispatching their remaining decisions before
        surfacing it. Successful harvests fan each primary's device row
        out to its subscribers, insert the post-selection winner into the
        result cache, record the flush's wall/assemble latency into
        ``stats.latency``, and notify the policy.
        """
        handles = self.executor.drain() if block else self.executor.retire()
        first_err: Optional[BaseException] = None
        for handle in handles:
            reqs = handle.payload
            try:
                labels, costs, picked, rounds = handle.result()
            except BaseException as err:
                self._in_flight_reqs -= len(reqs)
                if reqs:
                    self._requeue(reqs)
                if first_err is None:
                    first_err = err
                continue
            for slot, req in enumerate(reqs):
                row = labels[slot]
                cost, pick = int(costs[slot]), int(picked[slot])
                depth = int(rounds[slot])
                self._deliver(req, row, cost, pick, depth)
                self.stats.clustered += 1
                if req.subscribers:
                    subs, req.subscribers = req.subscribers, []
                    for sub in subs:
                        # Same device row, the subscriber's own plan —
                        # identical content by fingerprint equality, so
                        # the result is bit-identical to a cold flush.
                        self._deliver(sub, row, cost, pick, depth)
                        self.stats.clustered += 1
                        self._subscribed_pending -= 1
                if req.fingerprint is not None:
                    self._single_flight.pop(req.fingerprint.digest, None)
                    if self.result_cache is not None:
                        self.result_cache.put(
                            req.fingerprint, row[: req.plan.n],
                            cost, pick, depth)
            self._in_flight_reqs -= len(reqs)
            if handle.shape is not None and handle.wall_seconds is not None:
                bucket = (handle.method, handle.shape[1], handle.shape[2])
                self.stats.latency.record(bucket, handle.wall_seconds,
                                          handle.assemble_seconds,
                                          depth=handle.inflight_at_submit)
                self.policy.on_retire(bucket, self.stats.latency)
        if defer:
            return first_err
        if first_err is not None:
            raise first_err
        return None


__all__ = ["ClusterRequest", "ClusterStats", "ClusterBatcher",
           "AdmissionRejected"]
