"""The port's span recorder (``repro_torch.spans``) on the CPU.

* off (no profiler, no ``enable``): nothing is recorded or counted, and
  no CUDA event is created nor the device synchronised even where CUDA
  has started (faked);
* on under ``torch.profiler.profile`` and after ``enable``, off again
  after either ends;
* each record's parent, thread and request id; self time as the span
  less the union of its children;
* spans opened on a second thread keep their own stack;
* int and 0-d tensor counters, read without being cleared; ``host_syncs``
  adds each ``sync.*`` span's waits;
* the cap: spans past it are counted, not kept;
* device intervals: with CUDA's events and clock faked, one anchor a
  recording, the intervals set on the host's clock, none for a ``sync.*``
  span, events reused after ``clear``.
"""

import threading
import time

import pytest
import torch

from repro_torch import spans


@pytest.fixture(autouse=True)
def _fresh():
    spans.disable()
    spans.clear()
    yield
    spans.disable()
    spans.clear()


class _FakeCuda:
    """torch.cuda's events and synchronize on a fake device clock: each
    record stamps the clock, which advances 1,000 ns a record."""

    def __init__(self, monkeypatch):
        self.now = 5_000
        self.created = 0
        self.syncs = 0
        fake = self

        class Event:
            def __init__(self, enable_timing=False):
                assert enable_timing
                fake.created += 1
                self.at = None

            def record(self):
                fake.now += 1_000
                self.at = fake.now

            def elapsed_time(self, other):
                return (other.at - self.at) / 1e6

        def synchronize(device=None):
            fake.syncs += 1

        monkeypatch.setattr(torch.cuda, "Event", Event)
        monkeypatch.setattr(torch.cuda, "synchronize", synchronize)
        monkeypatch.setattr(spans, "_device", lambda: 0)


def _forbid_cuda(monkeypatch):
    def no(*a, **k):
        raise AssertionError("recording off touched CUDA")
    monkeypatch.setattr(torch.cuda, "Event", no)
    monkeypatch.setattr(torch.cuda, "synchronize", no)
    monkeypatch.setattr(spans, "_device", lambda: 0)


def _some_spans():
    with spans.request(3), spans.span("outer"):
        with spans.span("sync.x"):
            pass
        spans.count("n", 2)
        spans.count("t", torch.tensor(5))


def test_off_records_nothing_and_touches_no_device(monkeypatch):
    _forbid_cuda(monkeypatch)
    assert not spans.recording()
    assert spans.span("a") is spans.span("b") is spans.request(1)
    _some_spans()
    assert spans.records() == [] and spans.counters() == {}


def test_on_under_the_profiler_and_after_enable():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.recording()
        with spans.span("profiled"):
            pass
    assert not spans.recording()
    with spans.span("after"):
        pass
    spans.enable()
    with spans.span("enabled"):
        pass
    spans.disable()
    with spans.span("disabled"):
        pass
    assert [r.name for r in spans.records()] == ["profiled", "enabled"]


def test_parents_requests_and_self_time():
    spans.enable()
    with spans.span("root"):
        with spans.request(11), spans.span("a"):
            with spans.span("a.1"):
                time.sleep(0.002)
            with spans.span("a.2"):
                time.sleep(0.002)
        with spans.span("b"):
            pass
    recs = spans.records()
    assert [(r.name, r.parent, r.request) for r in recs] == [
        ("root", None, None), ("a", 0, 11), ("a.1", 1, 11),
        ("a.2", 1, 11), ("b", 0, None)]
    for r in recs:
        assert r.host_ns[0] <= r.host_ns[1] and r.device_ns is None
        if r.parent is not None:
            p = recs[r.parent].host_ns
            assert p[0] <= r.host_ns[0] <= r.host_ns[1] <= p[1]
    own = spans.self_ns(recs)
    dur = [r.host_ns[1] - r.host_ns[0] for r in recs]
    assert own[1] == dur[1] - dur[2] - dur[3]
    assert own[0] == dur[0] - dur[1] - dur[4]
    assert own[2] == dur[2] and own[1] >= 0
    assert spans.self_ns(recs, device=True) == [None] * 5


def test_self_time_takes_the_union_of_children_clipped_to_the_parent():
    R = spans.Record
    recs = [R("p", None, 1, None, (0, 100), (10, 110)),
            R("c", 0, 1, None, (10, 40), (0, 30)),
            R("c", 0, 1, None, (30, 60), (20, 50)),
            R("c", 0, 1, None, (90, 130), None)]
    assert spans.self_ns(recs) == [100 - 50 - 10, 30, 30, 40]
    assert spans.self_ns(recs, device=True) == [100 - 40, 30, 30, None]


def test_a_second_thread_keeps_its_own_stack():
    spans.enable()
    seen = []

    def work():
        with spans.request(9), spans.span("worker"):
            with spans.span("worker.inner"):
                seen.append(threading.get_ident())

    with spans.span("main"):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        with spans.span("main.inner"):
            pass
    recs = {r.name: (i, r) for i, r in enumerate(spans.records())}
    main_i, main = recs["main"]
    w_i, w = recs["worker"]
    assert w.parent is None and w.thread == seen[0] != main.thread
    assert w.request == 9 and main.request is None
    assert recs["worker.inner"][1].parent == w_i
    assert recs["main.inner"][1].parent == main_i


def test_int_and_tensor_counters(monkeypatch):
    monkeypatch.setattr(spans, "_FOLD", 4)
    spans.enable()
    for i in range(10):
        spans.count("ints", i)
        spans.count("tensors", torch.tensor(i))
        spans.count("bools", (torch.arange(6) < i).sum())
    with spans.span("sync.a"), spans.span("sync.b", syncs=2):
        pass
    with spans.span("not.a.sync", syncs=5):
        pass
    want = {"ints": 45, "tensors": 45, "bools": sum(min(i, 6)
                                                    for i in range(10)),
            "host_syncs": 3}
    assert spans.counters() == want
    assert spans.counters() == want           # a read clears nothing
    spans.clear()
    assert spans.counters() == {}


def test_the_cap_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(spans, "CAP", 3)
    spans.enable()
    with spans.span("a"):
        for _ in range(4):
            with spans.span("sync.b"):
                pass
    assert [r.name for r in spans.records()] == ["a", "sync.b", "sync.b"]
    assert spans.counters() == {"host_syncs": 4, "spans.dropped": 2}


def test_device_intervals_on_the_host_clock(monkeypatch):
    cuda = _FakeCuda(monkeypatch)
    spans.enable()
    t_before = time.perf_counter_ns()
    with spans.span("outer"):
        with spans.span("inner"):
            pass
        with spans.span("sync.wait"):                # host interval only
            pass
    assert cuda.syncs == 1 and cuda.created == 5     # anchor + 2 a span
    recs = spans.records()
    outer, inner, wait = recs
    assert wait.device_ns is None and wait.parent == 0
    # outer's entry is stamped 1,000 ns after the anchor, inner's 2,000,
    # inner's exit 3,000 and outer's 4,000.
    host0 = outer.device_ns[0] - 1_000
    assert t_before <= host0 <= outer.host_ns[0]
    assert outer.device_ns == (host0 + 1_000, host0 + 4_000)
    assert inner.device_ns == (host0 + 2_000, host0 + 3_000)
    assert cuda.syncs == 2                           # the read waits once
    assert spans.self_ns(recs, device=True) == [2_000, 1_000, None]
    spans.clear()
    with spans.span("again"):
        pass
    assert cuda.created == 5 and cuda.syncs == 3     # reused; a new anchor
    (again,) = spans.records()
    assert again.device_ns[1] - again.device_ns[0] == 1_000
