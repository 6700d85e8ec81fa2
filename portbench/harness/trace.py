"""The traced part of a ``--trace 1`` run: the profiler over a stretch of
the measured window, the harness's own spans, and their reduction to the
device's busy time, its kernels and its idle gaps.

The profiler records the device (CUDA) alone, which costs little a
kernel; recording every host operation as well more than doubled a
training step's host time. The harness's spans (``pb.<what>``, opened
around its calls into the program) are kept on the host clock and set on
the device's by one marker kernel launched at the start: an idle gap on
the device is named by the innermost span open on the host at its
middle.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "pb.window"


@dataclasses.dataclass
class Reading:
    """What the profiler saw over the traced stretch: its length
    (``window_s``), the union of device activity in it (``busy_s``),
    every device kernel as ``(name, seconds)``, the device time by
    operation name, and the idle time by the harness span open."""
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float]]
    device_ops: Dict[str, float]
    idle_by_span: Dict[str, float]

    def breakdown(self, top: int = 10) -> dict:
        def largest(d):
            return [[n, s] for n, s in sorted(d.items(), key=lambda kv: -kv[1])
                    [:top]]
        return {"device_ops": largest(self.device_ops),
                "idle_gaps": largest(self.idle_by_span)}


class Tracer:
    """Profiles the card from :meth:`start` to :meth:`stop` when
    ``active`` and a card is there; :meth:`span` marks harness spans
    while it runs."""

    def __init__(self, active: bool):
        self.active = active and torch.cuda.is_available()
        self._prof = None
        self._spans: List[Tuple[str, int, int]] = []
        self._marker_ns = 0
        self._reading: Optional[Reading] = None
        self.running = False

    @property
    def reading(self) -> Optional[Reading]:
        """The reduction of what was traced (None when nothing was): made
        on first use, after the window, not while it runs."""
        if self._reading is None and self._prof is not None \
                and not self.running:
            self._reading = reduce_events(
                self._prof.profiler.kineto_results.events(), self._spans,
                self._marker_ns)
            self._prof = None
        return self._reading

    @contextlib.contextmanager
    def _record(self, name: str):
        t = time.perf_counter_ns()
        try:
            yield
        finally:
            self._spans.append((name, t, time.perf_counter_ns()))

    def span(self, name: str):
        if self.running:
            return self._record(name)
        return contextlib.nullcontext()

    def start(self) -> None:
        if not self.active:
            return
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA],
                             acc_events=True)
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._marker_ns = time.perf_counter_ns()
        torch.ones(1, device="cuda")     # the marker: the first kernel
        self.running = True

    def stop(self) -> None:
        if not self.running:
            return
        torch.cuda.synchronize()
        self._spans.append((WINDOW, self._marker_ns,
                            time.perf_counter_ns()))
        self._prof.__exit__(None, None, None)
        self.running = False


def _is_kernel(name: str) -> bool:
    return not (name.startswith("Memcpy") or name.startswith("Memset"))


def reduce_events(events, spans: List[Tuple[str, int, int]],
                  marker_ns: int) -> Reading:
    """A :class:`Reading` of the raw profiler events and the host
    ``spans``: the earliest device event is the marker launched at
    ``marker_ns`` on the host clock, which sets the host's spans on the
    device's clock."""
    cuda = torch.autograd.DeviceType.CUDA
    device = [(e.name(), e.start_ns(), e.end_ns()) for e in events
              if e.device_type() == cuda and not e.is_user_annotation()]
    if not device:
        return None
    offset = min(d[1] for d in device) - marker_ns
    return reduce_intervals([(n, a + offset, b + offset)
                             for n, a, b in spans], device)


def reduce_intervals(spans: List[Tuple[str, int, int]],
                     device: List[Tuple[str, int, int]]) -> Reading:
    """The reduction on plain tuples ``(name, start_ns, end_ns)``: host
    ``spans`` (one of them the window) and ``device`` operations."""
    win = [s for s in spans if s[0] == WINDOW]
    if not win:
        raise ValueError("no window span in the trace")
    w0, w1 = win[0][1], win[0][2]
    inside = sorted((max(a, w0), min(b, w1), n) for n, a, b in device
                    if b > w0 and a < w1)
    busy, gaps, cur_a, cur_b = 0, [], None, w0
    for a, b, _ in inside:
        if cur_a is None or a > cur_b:
            if cur_a is not None:
                busy += cur_b - cur_a
            if a > cur_b:
                gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_a is not None:
        busy += cur_b - cur_a
    if w1 > cur_b:
        gaps.append((cur_b, w1))
    ops: Dict[str, float] = {}
    kernels = []
    for a, b, n in inside:
        ops[n] = ops.get(n, 0.0) + (b - a) / 1e9
        if _is_kernel(n):
            kernels.append((n, (b - a) / 1e9))
    idle: Dict[str, float] = {}
    others = sorted((s for s in spans if s[0] != WINDOW), key=lambda s: s[1])
    for a, b in gaps:
        mid = (a + b) / 2
        name = WINDOW
        for n, s0, s1 in others:      # the innermost: latest start
            if s0 > mid:
                break
            if s1 >= mid:
                name = n
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e9
    return Reading(window_s=(w1 - w0) / 1e9, busy_s=busy / 1e9,
                   kernels=kernels, device_ops=ops, idle_by_span=idle)


__all__ = ["Tracer", "Reading", "reduce_events", "reduce_intervals",
           "WINDOW"]
