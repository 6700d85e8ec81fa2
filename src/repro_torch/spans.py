"""Spans and counters inside the port: where a prefill's or a training
step's time goes, on the host's clock and on the device's.

Recording is on while a ``torch.profiler`` profile runs in the process
(a benchmark's ``--trace 1`` stretch records exactly what it profiles)
or between :func:`enable` and :func:`disable`. While it is off,
:func:`span`, :func:`request` and :func:`count` read one flag and return:
no CUDA event is created, no kernel launched, nothing synced.

    from repro_torch import spans
    spans.enable()
    batcher.admit(req)                 # or a training step
    spans.disable()
    for r in spans.records():
        print(r.name, r.parent, r.request, r.host_ns, r.device_ns)
    print(spans.counters())            # {"host_syncs": 2, ...}
    spans.clear()

Each :class:`Record` holds its name, the index of the span it opened in
(a stack per thread: the backward runs on autograd's device thread), the
thread, the request id it inherits from :func:`request`, and its start
and end on ``time.perf_counter_ns``. Where CUDA has started in the
process it also carries a device interval: a CUDA event recorded on the
current stream at entry and at exit, set on the host's clock by one
anchor (the first span after recording starts synchronizes, reads the
clock and records an anchor event). The device interval is when the
stream reached the span's entry and its exit: its kernels plus whatever
idle the host left between them. Device times are resolved when the
records are read, never while they are made. A ``sync.*`` span has a
host interval only: it is the host waiting for the card, and an event
there (some 20 us of host time each on an H100 machine's host) would
lengthen the stretch in which the card, drained by the sync, waits for
the host's next launch.

The spans, by name:

* ``serve.prefill``: ``ContinuousBatcher`` admitting a request: the
  prompt's upload, ``Model.prefill`` and the greedy pick, under
  ``request(uid)``;
* ``prefill``: ``models.decoding.prefill``, the whole call;
* ``attn``: each self- or cross-attention of a prefill (norm,
  projections, rope, B4, the cache writes, the output projection);
* ``ffn``: each layer's feed-forward in a prefill (SwiGLU or MoE);
* ``mamba``: each Mamba2 mixer of a hybrid_moe prefill (norm,
  in-projection, conv, chunked scan, gated norm, out-projection,
  residual), and ``ssd``: the chunked scan inside any Mamba2 block run
  over a whole sequence;
* ``moe.shared``: the shared expert beside the routed ones, inside
  ``ffn``;
* ``logits``: the last position's norm and the head;
* ``moe.route`` (router and the sort by expert), ``moe.dispatch``
  (counts, ranks, capacity and the scatter into expert batches),
  ``moe.experts`` (the experts' SwiGLU), ``moe.combine`` (gated results
  added back to their tokens): ``models.mlp.moe_sort``;
* ``train.step``, ``train.forward`` (``Model.loss``), ``train.backward``
  (``torch.autograd.grad``), ``train.optimizer`` (clipping and AdamW);
* ``sync.<what>``: a wait of the host for the device: ``sync.tokens``
  (a prompt's upload), ``sync.greedy`` (the picked token read back),
  ``sync.bincount`` (the MoE dispatch's expert counts).

The counters: ``host_syncs`` (the waits of every ``sync.*`` span: one
each, but two for ``sync.bincount``, since ``torch.bincount`` on the card
reads back its input's least and greatest values), ``moe.slots``
(experts × capacity of every dispatch), ``moe.slots_filled`` (kept
assignments), ``moe.assignments`` (tokens × k), ``moe.dropped``
(assignments past their expert's capacity), ``rope.table_builds``
(rope's frequency table built on a device: one per new head dim, theta
and device, none once each is cached), ``ssd.tokens`` (tokens times
layers the chunked scan ran over), ``spans.dropped`` (spans not kept
past :data:`CAP`). :func:`count` takes a Python int or a 0-d
tensor; tensors are summed on their device and read when
:func:`counters` is called.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.autograd import profiler as _profiler

CAP = 1 << 20                   # spans kept; later ones are counted only
_FOLD = 1024                    # device counts summed into one past this
_NOOP = contextlib.nullcontext()
_clock = time.perf_counter_ns


class Record(NamedTuple):
    name: str
    parent: Optional[int]       # index in records() of the enclosing span
    thread: int
    request: Optional[int]
    host_ns: Tuple[int, int]
    device_ns: Optional[Tuple[int, int]]    # on the host's clock


class _Open:
    __slots__ = ("name", "parent", "thread", "request", "dev", "t0", "t1",
                 "e0", "e1", "device_ns")


def _device() -> Optional[int]:
    """The current CUDA device once CUDA has started, else None."""
    return torch.cuda.current_device() if torch.cuda.is_initialized() \
        else None


class _Recorder:
    def __init__(self):
        self.forced = False
        self.lock = threading.Lock()
        self.local = threading.local()
        self.open: List[_Open] = []
        self.ints: Dict[str, int] = {}
        self.tensors: Dict[str, List[torch.Tensor]] = {}
        self.anchors: Dict[int, tuple] = {}     # device → (ns, event)
        self.pool: Dict[int, list] = {}         # device → free events

    def thread(self):
        loc = self.local
        if not hasattr(loc, "stack"):
            loc.stack, loc.request = [], None
        return loc

    def event(self, dev: int):
        free = self.pool.setdefault(dev, [])
        ev = free.pop() if free else torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def enter(self, name: str, syncs: int) -> Optional[_Open]:
        sync = name.startswith("sync.")
        if sync:
            self.add("host_syncs", syncs)
        loc = self.thread()
        o = _Open()
        o.name, o.thread, o.request = name, threading.get_ident(), \
            loc.request
        o.parent = loc.stack[-1] if loc.stack else None
        o.dev = None if sync else _device()
        o.e0, o.e1, o.t1, o.device_ns = None, None, None, None
        with self.lock:
            if len(self.open) >= CAP:
                self.ints["spans.dropped"] = \
                    self.ints.get("spans.dropped", 0) + 1
                return None
            loc.stack.append(len(self.open))
            self.open.append(o)
        if o.dev is not None and o.dev not in self.anchors:
            torch.cuda.synchronize()
            t = _clock()
            self.anchors[o.dev] = (t, self.event(o.dev))
        o.t0 = _clock()
        if o.dev is not None:
            o.e0 = self.event(o.dev)
        return o

    def exit(self, o: Optional[_Open]) -> None:
        if o is None:
            return
        if o.e0 is not None:
            o.e1 = self.event(o.dev)
        o.t1 = _clock()
        stack = self.thread().stack
        if stack:
            stack.pop()

    def add(self, name: str, n) -> None:
        with self.lock:
            if isinstance(n, torch.Tensor):
                ts = self.tensors.setdefault(name, [])
                ts.append(n)
                if len(ts) >= _FOLD:
                    self.tensors[name] = [torch.stack(ts).sum()]
            else:
                self.ints[name] = self.ints.get(name, 0) + int(n)

    def records(self) -> List[Record]:
        with self.lock:
            items = list(self.open)
        done = [i for i, o in enumerate(items) if o.t1 is not None]
        pending = {o.dev for o in items if o.e1 is not None
                   and o.device_ns is None}
        for dev in pending:
            torch.cuda.synchronize(dev)
        index = {i: j for j, i in enumerate(done)}
        out = []
        for i in done:
            o = items[i]
            if o.e1 is not None and o.device_ns is None:
                t, anchor = self.anchors[o.dev]
                a = t + round(anchor.elapsed_time(o.e0) * 1e6)
                o.device_ns = (a, a + round(o.e0.elapsed_time(o.e1) * 1e6))
            out.append(Record(o.name, index.get(o.parent), o.thread,
                              o.request, (o.t0, o.t1), o.device_ns))
        return out

    def counters(self) -> Dict[str, int]:
        with self.lock:
            out = dict(self.ints)
            for name, ts in self.tensors.items():
                total = torch.stack(ts).sum()
                self.tensors[name] = [total]
                out[name] = out.get(name, 0) + int(total.item())
        return out

    def clear(self) -> None:
        with self.lock:
            events = [(o.dev, e) for o in self.open for e in (o.e0, o.e1)
                      if e is not None]
            events += [(d, ev) for d, (_, ev) in self.anchors.items()]
            for dev, ev in events:
                self.pool.setdefault(dev, []).append(ev)
            self.open, self.ints, self.tensors, self.anchors = [], {}, {}, {}
        self.thread().stack.clear()


_REC = _Recorder()


class _Span:
    __slots__ = ("name", "syncs", "open")

    def __init__(self, name: str, syncs: int):
        self.name, self.syncs = name, syncs

    def __enter__(self):
        self.open = _REC.enter(self.name, self.syncs)

    def __exit__(self, *exc):
        _REC.exit(self.open)
        return False


class _Request:
    __slots__ = ("uid", "prev")

    def __init__(self, uid: int):
        self.uid = uid

    def __enter__(self):
        loc = _REC.thread()
        self.prev, loc.request = loc.request, self.uid

    def __exit__(self, *exc):
        _REC.thread().request = self.prev
        return False


def recording() -> bool:
    """Whether spans and counts are kept now."""
    return _profiler._is_profiler_enabled or _REC.forced


def span(name: str, syncs: int = 1):
    """A context that records the span ``name`` while recording is on; a
    ``sync.*`` span adds ``syncs``, the waits its call makes on the card,
    to ``host_syncs``."""
    if not (_profiler._is_profiler_enabled or _REC.forced):
        return _NOOP
    return _Span(name, syncs)


def request(uid: int):
    """A context whose spans carry the request id ``uid``."""
    if not (_profiler._is_profiler_enabled or _REC.forced):
        return _NOOP
    return _Request(uid)


def count(name: str, n=1) -> None:
    """Adds ``n`` (an int or a 0-d tensor) to the counter ``name``."""
    if _profiler._is_profiler_enabled or _REC.forced:
        _REC.add(name, n)


def enable() -> None:
    _REC.forced = True


def disable() -> None:
    _REC.forced = False


def records() -> List[Record]:
    """Every closed span kept since the last :func:`clear`, in the order
    opened (it synchronizes the devices its spans ran on once)."""
    return _REC.records()


def counters() -> Dict[str, int]:
    """Every counter's total since the last :func:`clear`."""
    return _REC.counters()


def clear() -> None:
    """Forgets every record and counter (call it with no span open)."""
    _REC.clear()


def self_ns(recs: List[Record], device: bool = False) -> List[int]:
    """Each record's duration less the union of its children's intervals
    inside it, on the host's clock or the device's (None where a record
    has no device interval)."""
    def interval(r):
        return r.device_ns if device else r.host_ns

    kids: List[list] = [[] for _ in recs]
    for r in recs:
        if r.parent is not None and interval(r) is not None:
            kids[r.parent].append(interval(r))
    out = []
    for r, ks in zip(recs, kids):
        if interval(r) is None:
            out.append(None)
            continue
        a, b = interval(r)
        covered, end = 0, a
        for s0, s1 in sorted(ks):
            s0, s1 = max(s0, end), min(s1, b)
            if s1 > s0:
                covered += s1 - s0
                end = s1
        out.append(b - a - covered)
    return out


__all__ = ["Record", "CAP", "span", "request", "count", "recording",
           "enable", "disable", "records", "counters", "clear", "self_ns"]
