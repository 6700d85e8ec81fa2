"""Device-side execution layer of the batch engine: programs + executors.

The "how it runs" half of the plan/executor split (packing and bucketing
live in :mod:`repro_torch.core.plan`). Three pieces:

**The bucket program** — :func:`run_bucket_program` moves one packed bucket
to the device and runs the composed program of
:mod:`repro_torch.core.programs`: the method's rounds body, the
objective's cost pass and the best-of-k argmin, so only the winners'
labels, costs, sample indices and rounds come back. Every batch entry is
independent of every other, which is what makes both overlap and
data-parallel sharding semantics-preserving.

**The program registry** — PyTorch runs eagerly and compiles nothing, but
the serving layer's cost policy prices a steal by whether the flush shape
it would create has run before, and pins hot shapes against eviction. The
registry keeps the reference's bounded-LRU API over the
``(B, R, W, k, program, objective)`` keys that have run once
(:func:`program_cache_contains`, ``_touch``, ``_pin``, ``_unpin``,
``_info``, ``_size``, :func:`set_program_cache_capacity`), with the same
LRU, refcounted-pin and capacity rules, so the policies decide as the
reference's do on the same trace. Methods of one program family
(``'pivot'`` / ``'pivot_raw'``) share keys, and pivot × disagree keeps the
legacy short key. A shape whose bucket tier the autotuner has tuned
(:mod:`repro_torch.kernels.autotune`) runs with the tuned launch plans of
B1 and B2, and its key carries them; an untuned shape keeps the untuned
key, so the cost model's residency probe and a run never disagree. Plans
are resolved on the submitting thread (:func:`_resolve_plans`), never on
a dispatch thread. No compile wall exists to learn, so the policy's
compile charge for an unseen shape is its static prior.

**Bucket executors** — how a packed bucket reaches the device:

* :class:`SyncExecutor` — dispatch, block, fetch; one bucket at a time.
* :class:`AsyncExecutor` — ``submit`` hands the flush to one dispatch
  thread of the executor and returns at once. The thread copies the staged
  inputs to the device, runs the program on the executor's own CUDA stream
  (the kernel wrappers launch on the thread's current stream), copies the
  outputs to pinned host memory and records a CUDA event. The pivot rounds
  loop blocks its issuing thread once a round to test termination, which
  is why the flush needs a thread of its own for ``submit`` to return
  before its rounds end. A handle is ready once the thread is done and the
  event has completed; its staging lease is released only then.
  ``retire()`` harvests completed handles without blocking, ``drain()``
  hands back everything.
* :class:`ShardedExecutor` — splits the pow2 group axis over the listed
  devices, one dispatch thread and stream each, and merges the shards'
  outputs in order. ``group_pad`` floors at the device count so the batch
  axis splits evenly and best-of-k replicas never straddle a shard. With
  one H100 it is the one-device case.

All executors return results bit-identical to each other and to the
per-graph engine for matching keys.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Deque, List, Optional, Protocol, Sequence, Tuple, \
    runtime_checkable

import numpy as np
import torch

from repro_torch.util import DeviceLike, next_pow2, resolve_device

from .dist import pow2_device_mesh
from .programs import bucket_impl, method_spec, objective_spec

# ---------------------------------------------------------------------------
# Bounded LRU registry of the bucket programs that have run.
# ---------------------------------------------------------------------------

_DEFAULT_CACHE_CAPACITY = 256

_program_cache: "OrderedDict[tuple, bool]" = OrderedDict()
_program_cache_capacity = _DEFAULT_CACHE_CAPACITY
_program_cache_evictions = 0
_program_cache_compiles = 0
# Pinned (R, W) bucket shapes → pin count, refcounted: two engines sharing
# a hot shape must not have one engine's teardown strip the other's pin.
_program_cache_pins: dict = {}
_cache_lock = threading.Lock()


def _program_key(shape, k: int, program: str = "pivot",
                 objective: str = "disagree", plans=None) -> tuple:
    """The registry key of one bucket program; untuned pivot × disagree
    keeps the reference's legacy short form, and a tuned program carries
    its ``(neighbor_min, label_agree)`` plan choices."""
    base = (tuple(int(s) for s in shape), int(k))
    if plans is None:
        if program == "pivot" and objective == "disagree":
            return base
        return base + (program, objective)
    return base + (program, objective, tuple(plans))


def _resolve_plans(shape, device, plans=None):
    """The launch plans a bucket program of ``shape`` on ``device`` runs
    with: the caller's explicit ``(neighbor_min, label_agree)`` pair, else
    the tuning cache's winners, else None (untuned: ``launch_plan`` picks,
    and the key keeps its untuned form). ``device=None`` resolves nothing
    (the probe of an engine whose device is unknown)."""
    if plans is not None:
        return tuple(plans)
    if device is None:
        return None
    from repro_torch.kernels.autotune import resolve_plans

    return resolve_plans(shape, device)


def _key_bucket(key: tuple) -> Tuple[int, int]:
    """(R, W) bucket shape of a key's packed (B, R, W) shape."""
    shape = key[0]
    return (shape[1], shape[2])


def _evict_to_capacity() -> None:
    global _program_cache_evictions
    while len(_program_cache) > _program_cache_capacity:
        # LRU order, skipping pinned bucket shapes; capacity is a hard
        # bound, so when everything left is pinned the LRU loses anyway.
        victim = next((key for key in _program_cache
                       if _key_bucket(key) not in _program_cache_pins),
                      None)
        if victim is None:
            victim = next(iter(_program_cache))
        _program_cache.pop(victim)
        _program_cache_evictions += 1


def _record_run(shape, k: int, program: str, objective: str,
                plans=None) -> None:
    """Enter (or refresh) the key of a program about to run."""
    global _program_cache_compiles
    key = _program_key(shape, k, program, objective, plans)
    with _cache_lock:
        if key in _program_cache:
            _program_cache.move_to_end(key)
            return
        _program_cache_compiles += 1
        _program_cache[key] = True
        _evict_to_capacity()


def program_cache_size() -> int:
    """Number of bucket programs resident in the registry."""
    return len(_program_cache)


def program_cache_capacity() -> int:
    return _program_cache_capacity


def set_program_cache_capacity(capacity: int) -> int:
    """Bound the registry; returns the previous capacity."""
    global _program_cache_capacity
    if capacity < 1:
        raise ValueError(f"capacity must be >= 1, got {capacity}")
    with _cache_lock:
        prev = _program_cache_capacity
        _program_cache_capacity = capacity
        _evict_to_capacity()
    return prev


def program_cache_contains(shape, k: int, method: str = "pivot",
                           objective: str = "disagree", device=None,
                           plans=None) -> bool:
    """Non-mutating probe: has this exact bucket program run (and is it
    still resident)? Never touches the LRU order. ``plans`` resolves as
    a run on ``device`` does (:func:`_resolve_plans`: explicit pair >
    tuning-cache winners > untuned), so probe and run agree on the key."""
    return _program_key(shape, k, method_spec(method).program, objective,
                        _resolve_plans(shape, device, plans)) \
        in _program_cache


def program_cache_touch(bucket: Tuple[int, int]) -> int:
    """Refresh the LRU recency of every program of one ``(R, W)`` bucket
    shape; returns how many were touched."""
    with _cache_lock:
        keys = [key for key in _program_cache if _key_bucket(key) == bucket]
        for key in keys:
            _program_cache.move_to_end(key)
    return len(keys)


def program_cache_pin(bucket: Tuple[int, int]) -> int:
    """Protect a bucket shape's programs from eviction; returns the number
    currently resident. Durable (programs of the shape entered later are
    protected too), refcounted, and a preference: capacity stays a hard
    bound."""
    bucket = (int(bucket[0]), int(bucket[1]))
    with _cache_lock:
        _program_cache_pins[bucket] = _program_cache_pins.get(bucket, 0) + 1
        return sum(1 for key in _program_cache
                   if _key_bucket(key) == bucket)


def program_cache_unpin(bucket: Tuple[int, int]) -> bool:
    """Drop one reference to a bucket shape's eviction protection; True if
    the shape was pinned (it stays protected while other pinners remain)."""
    bucket = (int(bucket[0]), int(bucket[1]))
    with _cache_lock:
        count = _program_cache_pins.get(bucket, 0)
        if count <= 0:
            return False
        if count == 1:
            del _program_cache_pins[bucket]
        else:
            _program_cache_pins[bucket] = count - 1
        return True


def program_cache_info() -> dict:
    """Registry observability for serving stats: ``compiles`` counts first
    runs of a key; ``compile_wall_ewma_ms`` stays empty (nothing is
    compiled)."""
    return {
        "size": len(_program_cache),
        "capacity": _program_cache_capacity,
        "evictions": _program_cache_evictions,
        "compiles": _program_cache_compiles,
        "pinned": sorted(_program_cache_pins),
        "compile_wall_ewma_ms": {},
    }


# ---------------------------------------------------------------------------
# The bucket program.
# ---------------------------------------------------------------------------


def _to_device(a, dev: torch.device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    # Asynchronous from pinned staging; a plain copy otherwise.
    return t.to(dev, non_blocking=True).contiguous()


def run_bucket_program(ell, ranks_p, elig_p, m_edges, k: int,
                       method: str = "pivot", objective: str = "disagree",
                       device: DeviceLike = None, plans=None):
    """Run one bucket program on ``device``; returns device tensors.

    The inputs are the host arrays of :func:`repro_torch.core.plan.
    pack_bucket` (or tensors); they are copied to the device here, on the
    calling thread's current stream. ``plans`` forces the B1/B2 plan
    choices (default: the tuning cache's, :func:`_resolve_plans`).
    """
    program = method_spec(method).program
    objective_spec(objective)            # fail fast on unknown objectives
    dev = resolve_device(device)
    shape = np.shape(ell)
    plans = _resolve_plans(shape, dev, plans)
    _record_run(shape, k, program, objective, plans)
    return _launch((ell, ranks_p, elig_p, m_edges), k, program, objective,
                   dev, plans)


def _launch(args, k: int, program: str, objective: str,
            dev: torch.device, plans=None):
    return bucket_impl(*(_to_device(a, dev) for a in args), k=k,
                       program=program, objective=objective, plans=plans)


def _run_to_host(args, k: int, program: str, objective: str,
                 dev: torch.device, stream, plans=None) -> Tuple[list, Any]:
    """One (shard of a) flush on a dispatch thread: the program on
    ``stream``, its outputs copied to pinned host memory, and a CUDA event
    recorded after the copies (None on the CPU). ``plans`` were resolved
    by the submitting thread."""
    if stream is None:
        return list(_launch(args, k, program, objective, dev, plans)), None
    with torch.cuda.stream(stream):
        outs = _launch(args, k, program, objective, dev, plans)
        host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                for o in outs]
        for h, o in zip(host, outs):
            h.copy_(o, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return host, event


# ---------------------------------------------------------------------------
# Executors.
# ---------------------------------------------------------------------------


class InFlightBucket:
    """Handle for one dispatched bucket program.

    Holds the pending outputs (futures of dispatch threads, or finished
    tensors), the submitter's ``payload``, and the staging lease whose host
    buffers fed the program. ``result()`` waits for the outputs, converts
    them to numpy and only then releases the lease: the invariant that
    keeps overlapped flushes from refilling a buffer still in flight.

    Per-flush telemetry rides on the handle: ``shape`` is the packed
    ``(B, R, W)``, ``assemble_seconds`` the host bucket-assembly time
    (stamped by :func:`pack_and_submit`), ``submitted_at`` the dispatch
    stamp (``time.perf_counter``), ``returned_seconds`` how long ``submit``
    took to return, and ``wall_seconds`` the submit→fetch wall, filled in
    when the outputs are first fetched.
    """

    __slots__ = ("payload", "_parts", "_fetched", "_lease", "shape",
                 "assemble_seconds", "submitted_at", "returned_seconds",
                 "wall_seconds", "inflight_at_submit", "method", "objective")

    def __init__(self, parts, payload: Any = None, lease=None,
                 shape: Optional[Tuple[int, ...]] = None,
                 assemble_seconds: float = 0.0,
                 submitted_at: Optional[float] = None,
                 inflight_at_submit: int = 1,
                 method: str = "pivot", objective: str = "disagree"):
        # ``parts``: per shard, a Future of (host tensors, event) or a
        # finished (tensors, None) pair.
        self._parts = parts
        self._fetched: Optional[Tuple[np.ndarray, ...]] = None
        self.payload = payload
        self._lease = lease
        self.shape = shape
        self.assemble_seconds = assemble_seconds
        self.submitted_at = submitted_at
        self.returned_seconds: Optional[float] = None
        self.wall_seconds: Optional[float] = None
        self.method = method
        self.objective = objective
        # In-flight depth counting this flush: its wall includes queueing
        # behind the depth−1 earlier flushes.
        self.inflight_at_submit = inflight_at_submit

    @property
    def harvested(self) -> bool:
        return self._fetched is not None

    def ready(self) -> bool:
        """True once every shard's program and copies have finished
        (never blocks). Also true after a failed fetch: there is nothing
        left to wait for, and ``result()`` reports the failure."""
        if self._fetched is not None or self._parts is None:
            return True
        for part in self._parts:
            if isinstance(part, Future):
                if not part.done():
                    return False
                if part.exception() is not None:
                    continue
                part = part.result()
            event = part[1]
            if event is not None and not event.query():
                return False
        return True

    def result(self) -> Tuple[np.ndarray, ...]:
        """(labels, costs, picked, rounds) as numpy; blocks if needed.

        The staging lease is released whether the fetch succeeds or the
        program raised: either way it is finished with its input buffers.
        """
        if self._fetched is None:
            parts, self._parts = self._parts, None
            if parts is None:
                raise RuntimeError(
                    "bucket program outputs unavailable (an earlier fetch "
                    "of this handle failed)")
            try:
                # Every shard's future is read, so none keeps an unseen
                # error; the first one raises.
                done = [part.exception() or part.result()
                        if isinstance(part, Future) else part
                        for part in parts]
                err = next((d for d in done if isinstance(d, BaseException)),
                           None)
                if err is not None:
                    raise err
                shards = []
                for outs, event in done:
                    if event is not None:
                        event.synchronize()
                    shards.append([o.cpu().numpy() for o in outs])
                self._fetched = tuple(np.concatenate(cols) if len(cols) > 1
                                      else cols[0] for cols in zip(*shards))
                if self.submitted_at is not None:
                    self.wall_seconds = time.perf_counter() - self.submitted_at
            finally:
                if self._lease is not None:
                    self._lease.release()
                    self._lease = None
        return self._fetched


@runtime_checkable
class BucketExecutor(Protocol):
    """Structural protocol the serving layer schedules bucket flushes by."""

    name: str

    def group_pad(self, n_groups: int) -> int:
        """Padded group count for a bucket of ``n_groups`` graphs."""
        ...

    def submit(self, ell, ranks_p, elig_p, m_edges, k: int,
               payload: Any = None, lease=None, track: bool = True,
               assemble_seconds: float = 0.0, method: str = "pivot",
               objective: str = "disagree") -> InFlightBucket:
        """Dispatch one packed bucket; returns its in-flight handle.

        ``track=True`` (serving layers) enqueues the handle for delivery
        through ``retire``/``drain``; ``track=False`` (one-shot callers that
        harvest via ``result()``) leaves queue bookkeeping to the caller.
        The B1/B2 launch plans are the tuning cache's winners for the
        shape, resolved here, on the submitting thread.
        """
        ...

    def retire(self) -> List[InFlightBucket]:
        """Harvest completed handles without blocking."""
        ...

    def drain(self) -> List[InFlightBucket]:
        """Hand back every outstanding handle (callers block via result)."""
        ...

    @property
    def in_flight(self) -> int:
        """Submitted-but-unharvested bucket count (backpressure signal)."""
        ...


class _QueueExecutor:
    """Shared submit/retire bookkeeping for the concrete executors."""

    name = "base"

    def __init__(self):
        self._pending: Deque[InFlightBucket] = deque()

    def group_pad(self, n_groups: int) -> int:
        return next_pow2(max(1, n_groups))

    def _dispatch(self, args, k: int, program: str, objective: str,
                  plans=None) -> list:
        raise NotImplementedError

    def submit(self, ell, ranks_p, elig_p, m_edges, k: int,
               payload: Any = None, lease=None, track: bool = True,
               assemble_seconds: float = 0.0, method: str = "pivot",
               objective: str = "disagree") -> InFlightBucket:
        program = method_spec(method).program
        objective_spec(objective)
        shape = tuple(int(s) for s in np.shape(ell))
        submitted_at = time.perf_counter()
        # Resolved here, not on a dispatch thread, so the key recorded and
        # the plans run are one.
        plans = _resolve_plans(shape, self.device)
        _record_run(shape, k, program, objective, plans)
        parts = self._dispatch((ell, ranks_p, elig_p, m_edges), k, program,
                               objective, plans)
        handle = InFlightBucket(parts, payload=payload, lease=lease,
                                shape=shape,
                                assemble_seconds=assemble_seconds,
                                submitted_at=submitted_at,
                                inflight_at_submit=len(self._pending) + 1,
                                method=method, objective=objective)
        self._post_submit(handle)
        handle.returned_seconds = time.perf_counter() - submitted_at
        if track:
            self._pending.append(handle)
        return handle

    def _post_submit(self, handle: InFlightBucket) -> None:
        pass

    @property
    def in_flight(self) -> int:
        return len(self._pending)

    def retire(self) -> List[InFlightBucket]:
        done: List[InFlightBucket] = []
        still: Deque[InFlightBucket] = deque()
        while self._pending:
            h = self._pending.popleft()
            (done if h.ready() else still).append(h)
        self._pending = still
        return done

    def drain(self) -> List[InFlightBucket]:
        out = list(self._pending)
        self._pending.clear()
        return out


class SyncExecutor(_QueueExecutor):
    """Dispatch, block, fetch — one bucket at a time, on one device.

    ``submit`` returns only after the outputs (and the staging lease) have
    been harvested into the handle.
    """

    name = "sync"

    def __init__(self, device: DeviceLike = None):
        super().__init__()
        self.device = resolve_device(device)

    def _dispatch(self, args, k, program, objective, plans=None):
        return [(list(_launch(args, k, program, objective, self.device,
                              plans)), None)]

    def _post_submit(self, handle: InFlightBucket) -> None:
        handle.result()


class _Lane:
    """One device of a threaded executor: its dispatch thread (started at
    the first flush, and again after a shutdown) and, on a CUDA device,
    its own stream."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = (torch.cuda.Stream(device=device)
                       if device.type == "cuda" else None)
        self.pool: Optional[ThreadPoolExecutor] = None

    def submit(self, args, k, program, objective, plans=None) -> Future:
        if self.pool is None:
            self.pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="bucket-dispatch")
        return self.pool.submit(_run_to_host, args, k, program, objective,
                                self.device, self.stream, plans)

    def shutdown(self) -> None:
        pool, self.pool = self.pool, None
        if pool is not None:
            pool.shutdown(wait=True)


class AsyncExecutor(_QueueExecutor):
    """Pipelined path: ``submit`` returns before the flush's rounds end.

    One dispatch thread issues every flush, in submission order, on the
    executor's own CUDA stream; the caller packs the next bucket meanwhile.
    ``retire()`` harvests whatever has finished (thread done, event
    completed); ``drain()`` hands back everything (harvest order =
    submission order).
    """

    name = "async"

    def __init__(self, device: DeviceLike = None):
        super().__init__()
        self._use([resolve_device(device)])

    def _use(self, devices: List[torch.device]) -> None:
        self.devices = devices
        self.device = devices[0]
        self.num_devices = len(devices)
        self._lanes = [_Lane(d) for d in devices]

    def _dispatch(self, args, k, program, objective, plans=None):
        # One shard a lane; a shard is whole groups of k entries.
        B = int(np.shape(args[0])[0])
        if B % (self.num_devices * k):
            raise ValueError(
                f"batch of {B} entries does not split into "
                f"{self.num_devices} shards of whole k={k} groups; pad the "
                "group axis with group_pad")
        step = B // self.num_devices
        return [lane.submit(tuple(a[i * step:(i + 1) * step] for a in args),
                            k, program, objective, plans)
                for i, lane in enumerate(self._lanes)]

    def close(self) -> None:
        """Wait for the dispatch threads and stop them; a later flush
        starts them again."""
        for lane in self._lanes:
            lane.shutdown()


class ShardedExecutor(AsyncExecutor):
    """Data-parallel path: one flush split over the listed devices.

    The packed batch axis is cut into ``len(devices)`` equal shards, each
    run by its device's dispatch thread on that device's stream with no
    communication (batch entries are independent), and the shards' outputs
    are concatenated in order on the host. ``group_pad`` raises the group
    padding to the device count, so the pow2 group axis splits evenly and
    best-of-k replicas never straddle a shard. ``devices=None`` takes
    every local CUDA device (a power of two of them). A device may be
    listed twice (the CPU tests run two ``"cpu"`` shards).
    """

    name = "sharded"

    def __init__(self, devices: Optional[Sequence[DeviceLike]] = None):
        _QueueExecutor.__init__(self)
        if devices is None:
            devices = pow2_device_mesh()
        devs = [resolve_device(d) for d in devices]
        if not devs or len(devs) & (len(devs) - 1):
            raise ValueError(
                f"ShardedExecutor needs a power-of-two device count to "
                f"split the pow2 group axis evenly, got {len(devs)}")
        self._use(devs)

    def group_pad(self, n_groups: int) -> int:
        return max(self.num_devices, next_pow2(max(1, n_groups)))


def pack_and_submit(plans, group_keys, k: int, executor: BucketExecutor,
                    pool=None, payload: Any = None, track: bool = True,
                    objective: str = "disagree"):
    """Pack one bucket and dispatch it through an executor.

    The lease → ``pack_bucket`` → ``submit`` sequence shared by
    ``correlation_cluster_batch`` and the serving-layer flush. One flush
    runs one method, taken from the plans (``GraphPlan.method``); a
    mixed-method plan list is refused. Returns ``(handle, stats)`` with this
    flush's :class:`~repro_torch.core.plan.PackStats`. If packing or
    dispatch raises, the staging lease is released before re-raising.
    """
    from .plan import estimate_pack_stats, pack_bucket

    R, W = plans[0].bucket
    method = plans[0].method
    for p in plans[1:]:
        if p.method != method:
            raise ValueError(
                f"cannot pack methods {method!r} and {p.method!r} into one "
                "bucket flush: a bucket program runs exactly one registered "
                "method — cross-method coalescing/stealing is refused")
    g_pad = executor.group_pad(len(plans))
    lease = pool.acquire(g_pad * k, R, W) if pool is not None else None
    try:
        t_pack = time.perf_counter()
        ell, ranks, elig, m_edges, _ = pack_bucket(
            plans, group_keys, k=k, g_pad=g_pad,
            staging=lease.arrays if lease is not None else None)
        assemble_seconds = time.perf_counter() - t_pack
        handle = executor.submit(ell, ranks, elig, m_edges, k=k,
                                 payload=payload, lease=lease, track=track,
                                 assemble_seconds=assemble_seconds,
                                 method=method, objective=objective)
    except BaseException:
        if lease is not None:
            lease.release()
        raise
    return handle, estimate_pack_stats(plans, k, g_pad=g_pad)


_EXECUTORS = {
    "sync": SyncExecutor,
    "async": AsyncExecutor,
    "sharded": ShardedExecutor,
}


def make_executor(spec=None, device: DeviceLike = None) -> BucketExecutor:
    """Resolve an executor argument: a name, an instance, or None (sync).

    ``device`` places ``'sync'`` and ``'async'``; ``'sharded'`` by name
    takes every local CUDA device, or ``[device]`` when one is given.
    """
    if spec is None:
        spec = "sync"
    if isinstance(spec, str):
        if spec not in _EXECUTORS:
            raise ValueError(f"unknown executor {spec!r}; expected one of "
                             f"{sorted(_EXECUTORS)}")
        if spec == "sharded":
            return ShardedExecutor(None if device is None else [device])
        return _EXECUTORS[spec](device=device)
    if isinstance(spec, BucketExecutor):
        return spec
    raise TypeError(f"executor must be a name or BucketExecutor, "
                    f"got {type(spec).__name__}")


__all__ = [
    "InFlightBucket",
    "BucketExecutor",
    "SyncExecutor",
    "AsyncExecutor",
    "ShardedExecutor",
    "make_executor",
    "pack_and_submit",
    "run_bucket_program",
    "program_cache_size",
    "program_cache_capacity",
    "set_program_cache_capacity",
    "program_cache_info",
    "program_cache_contains",
    "program_cache_touch",
    "program_cache_pin",
    "program_cache_unpin",
]
