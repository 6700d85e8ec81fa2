"""Unified serving-engine protocol: admit / flush / retire / stats.

A copy of the framework-free ``repro/serve/engine.py``. An outer loop
drives a serving engine through a small API, as JetStream drives its
``prefill`` / ``generate`` / ``insert`` programs and vLLM its slots. Both
serving paths of the port implement it: the token path
(:class:`repro_torch.serve.batching.ContinuousBatcher`) and the clustering
path (:class:`repro_torch.serve.cluster_batcher.ClusterBatcher`).

* ``admit(request)`` — hand one request to the engine. The engine may run
  device work immediately (a bucket filled, a slot freed) and returns any
  requests that *retired* as a direct consequence; otherwise ``[]``.
  Engines with admission control may refuse instead, raising
  ``AdmissionRejected`` — the caller sheds load or retries after the next
  retire, rather than queueing unboundedly.
* ``flush()`` — force pending work through the device: drain partially
  filled buckets / decode remaining slots. Returns the retired requests.
  Engines with a deadline policy also expose ``poll(now)`` to flush only
  what has waited past its budget.
* ``retire()`` — drain the finished-request queue without running device
  work (requests completed by earlier ``admit``/``flush`` calls that the
  caller has not collected yet).
* ``pending()`` — number of admitted-but-unfinished requests.
* ``stats`` — an :class:`EngineStats` (or subclass) attribute with at
  least ``submitted``/``retired`` counters.

The protocol is structural (``typing.Protocol``): anything with these
members can be scheduled, no inheritance required. ``serve_all`` is the
reference outer loop — admit a stream, poll deadlines, drain at the end.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Iterable, List, Protocol, runtime_checkable


class AdmissionRejected(RuntimeError):
    """Raised by ``admit`` when an engine's admission policy refuses a
    request (e.g. the in-flight window is full) — the caller sheds load or
    retries after the next retire."""


@dataclasses.dataclass
class EngineStats:
    """Counters every serving engine keeps; subclasses add path-specific
    fields (padding accounting, decode-step counts, ...). ``policy`` names
    the scheduling policy driving the engine's flush/admission decisions —
    part of the protocol's stats surface so outer loops and benchmarks can
    report which scheduler produced the numbers. ``cache_hits`` counts
    requests retired straight from a content-addressed result cache
    without device work (engines without one leave it 0)."""

    submitted: int = 0
    retired: int = 0
    policy: str = ""
    cache_hits: int = 0

    def snapshot(self) -> "EngineStats":
        """Deep copy for delta accounting against a long-lived engine.

        ``dataclasses.replace(stats)`` is a *shallow* copy: mutable nested
        fields (flush-latency telemetry, live result-cache counters) alias
        the live object, so a delta computed from the "snapshot" later
        reads the current value and comes out zero. Callers that report
        per-call deltas (streaming dedup over a reused batcher) must
        snapshot through this instead.
        """
        return copy.deepcopy(self)


@runtime_checkable
class ClusterEngine(Protocol):
    """Structural protocol for slot/bucket serving engines (see module doc)."""

    stats: Any

    def admit(self, request: Any) -> List[Any]:
        """Admit one request; returns requests retired as a side effect."""
        ...

    def flush(self) -> List[Any]:
        """Force all pending work through the device; returns retired."""
        ...

    def retire(self) -> List[Any]:
        """Drain already-finished requests without running device work."""
        ...

    def pending(self) -> int:
        """Admitted-but-unfinished request count."""
        ...


def serve_all(engine: ClusterEngine, requests: Iterable[Any],
              reject_backoff: float = 0.0005,
              max_stalled_rounds: int = 100_000) -> List[Any]:
    """Reference outer loop: admit a request stream, then drain the engine.

    Engines with a deadline policy are polled after every admit (so a
    ``max_wait`` budget is honoured mid-stream, not only at end of stream)
    — this is what lets the driver exercise deadline/adaptive scheduling
    policies instead of only full-bucket flushes. Engines with admission
    control are retried: on :class:`AdmissionRejected` the loop harvests
    finished work (``retire`` + ``poll``) and re-admits, backing off
    ``reject_backoff`` seconds only when no progress was made — a stand-in
    for a front-end that would 429/shed instead. Time is always the
    *engine's own* clock — inject a virtual clock into the engine
    (``ClusterBatcher(clock=...)``) for simulations; a second clock here
    could disagree with the ``admitted_at`` stamps and silently disable
    the deadline. The backoff follows the same rule: when the engine
    carries an injected clock with an ``advance`` method (a
    ``VirtualClock``), the loop advances *that* clock by
    ``reject_backoff`` instead of sleeping — wall-clock sleep does not
    move virtual time, so under a virtual clock a rejection loop would
    otherwise spin forever with the deadline frozen. ``max_stalled_rounds``
    consecutive no-progress rejections raise ``RuntimeError`` (loudly)
    rather than spinning unbounded — that many fruitless retries means a
    stalled flush or a policy that can never admit, on any clock. Returns
    every retired request, in retirement order — each request exactly
    once.
    """
    retired: List[Any] = []
    poll = getattr(engine, "poll", None)
    clock = getattr(engine, "clock", None)
    advance = getattr(clock, "advance", None) \
        if clock is not None and clock is not time.monotonic else None
    for req in requests:
        stalled = 0
        while True:
            try:
                retired.extend(engine.admit(req))
                break
            except AdmissionRejected:
                progressed = engine.retire()
                if poll is not None:
                    progressed.extend(poll())
                retired.extend(progressed)
                if progressed:
                    stalled = 0
                    continue
                stalled += 1
                if stalled >= max_stalled_rounds:
                    pending = getattr(engine, "pending", lambda: "?")()
                    raise RuntimeError(
                        f"serve_all made no progress across {stalled} "
                        f"consecutive rejected admissions ({pending} "
                        "requests pending) — a flush is stalled or the "
                        "admission policy can never open")
                if reject_backoff:
                    if advance is not None:
                        advance(reject_backoff)   # engine time, not wall time
                    else:
                        time.sleep(reject_backoff)  # let in-flight work finish
        if poll is not None:
            retired.extend(poll())
    retired.extend(engine.flush())
    retired.extend(engine.retire())
    return retired


__all__ = ["AdmissionRejected", "EngineStats", "ClusterEngine", "serve_all"]
