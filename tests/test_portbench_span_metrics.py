"""The benchmark's seven per-layer readers of the program's spans and
counters (``portbench/metrics/``, through ``harness/program_spans.py``),
on hand-made records: each reads what its docstring says; each gives
None where nothing was recorded, where the program has no recorder (the
benchmark laid over an older program), and for a cell of the other kind;
the device-time readers give None on records without a device interval
(a run off the card), and the counter readers read a real recording of a
smoke prefill."""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import repro_torch
from repro_torch import spans

BENCH = Path(__file__).resolve().parent.parent / "portbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import main, program_spans  # noqa: E402

PREFILL = SimpleNamespace(kind="prefill")
TRAIN = SimpleNamespace(kind="train")
READERS = {
    "attn_ms_per_prefill.prefill": PREFILL,
    "ffn_ms_per_prefill.prefill": PREFILL,
    "host_syncs_per_prefill.prefill": PREFILL,
    "moe_dispatch_ms_per_prefill.prefill": PREFILL,
    "moe_slot_fill_pct.prefill": PREFILL,
    "optimizer_ms_per_step.train": TRAIN,
    "host_syncs_per_step.train": TRAIN,
}
MS = 1_000_000


class _Book:
    """Records made by hand: ``add`` opens a span under ``parent`` with a
    device interval of ``ms`` milliseconds (or none)."""

    def __init__(self, device=True):
        self.recs, self.device, self.t = [], device, 0

    def add(self, name, parent=None, ms=1.0):
        a = self.t
        self.t += int(ms * MS)
        dev = (a + 7, a + 7 + int(ms * MS)) if self.device else None
        self.recs.append(spans.Record(name, parent, 1, None, (a, self.t),
                                      dev))
        return len(self.recs) - 1


def _prefills(book):
    """Two traced prefills of two layers each; the second layer of each
    is a MoE one: attn 3 + 5 ms, ffn 11 + 13 ms, dispatch spans 1 + 2 + 4
    ms a MoE layer, one span elsewhere (not under a prefill)."""
    for _ in range(2):
        root = book.add("serve.prefill", ms=0.5)
        book.add("sync.tokens", root, 0.01)
        pre = book.add("prefill", root, 0.5)
        for attn_ms, ffn_ms, moe in ((3, 11, False), (5, 13, True)):
            a = book.add("attn", pre, attn_ms)
            book.add("sync.rope", a, 0.01)
            book.add("sync.rope", a, 0.01)
            f = book.add("ffn", pre, ffn_ms)
            if moe:
                book.add("moe.route", f, 1)
                d = book.add("moe.dispatch", f, 2)
                book.add("sync.bincount", d, 0.01)
                book.add("moe.experts", f, 6)
                book.add("moe.combine", f, 4)
        book.add("logits", pre, 1)
        book.add("sync.greedy", root, 0.01)
    book.add("attn", None, 100)          # outside every prefill: not read
    return {"host_syncs": 14, "moe.slots": 640, "moe.slots_filled": 496,
            "moe.assignments": 500, "moe.dropped": 4}


def _steps(book):
    """Three traced steps whose optimizer spans take 20, 30 and 40 ms."""
    for opt in (20, 30, 40):
        s = book.add("train.step", ms=1)
        book.add("train.forward", s, 5)
        book.add("train.backward", s, 9)
        book.add("train.optimizer", s, opt)
    return {"host_syncs": 240}


def _fake(monkeypatch, recs, counts):
    monkeypatch.setattr(program_spans, "recorded", lambda: (recs, counts))


@pytest.fixture(autouse=True)
def _fresh():
    spans.disable()
    spans.clear()
    yield
    spans.disable()
    spans.clear()


@pytest.mark.parametrize("name, want", [
    ("attn_ms_per_prefill.prefill", 8.0),
    ("ffn_ms_per_prefill.prefill", 24.0),
    ("host_syncs_per_prefill.prefill", 7.0),
    ("moe_dispatch_ms_per_prefill.prefill", 7.0),
    ("moe_slot_fill_pct.prefill", 77.5),
])
def test_prefill_readers(name, want, monkeypatch):
    book = _Book()
    counts = _prefills(book)
    _fake(monkeypatch, book.recs, counts)
    assert main.reader(name)(PREFILL) == pytest.approx(want)
    assert main.reader(name)(TRAIN) is None


@pytest.mark.parametrize("name, want", [
    ("optimizer_ms_per_step.train", 30.0),
    ("host_syncs_per_step.train", 80.0),
])
def test_train_readers(name, want, monkeypatch):
    book = _Book()
    counts = _steps(book)
    _fake(monkeypatch, book.recs, counts)
    assert main.reader(name)(TRAIN) == pytest.approx(want)
    assert main.reader(name)(PREFILL) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_none_when_nothing_was_recorded(name):
    assert program_spans.recorded() is None
    assert main.reader(name)(READERS[name]) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_none_where_the_program_has_no_recorder(name, monkeypatch):
    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert program_spans.recorded() is None
    assert main.reader(name)(READERS[name]) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_none_where_the_records_miss_what_the_reader_reads(name,
                                                          monkeypatch):
    book = _Book()
    counts = (_steps(book) if READERS[name] is PREFILL
              else _prefills(book))
    _fake(monkeypatch, book.recs, counts)
    assert main.reader(name)(READERS[name]) is None


@pytest.mark.parametrize("name", ["attn_ms_per_prefill.prefill",
                                  "ffn_ms_per_prefill.prefill",
                                  "moe_dispatch_ms_per_prefill.prefill",
                                  "optimizer_ms_per_step.train"])
def test_device_readers_give_none_off_the_card(name, monkeypatch):
    book = _Book(device=False)
    counts = {**_prefills(book), **_steps(book)}
    _fake(monkeypatch, book.recs, counts)
    assert main.reader(name)(READERS[name]) is None


def test_counter_readers_on_a_recorded_smoke_prefill():
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model
    from repro_torch.serve.batching import ContinuousBatcher, Request

    cfg = get_smoke("olmoe-1b-7b")
    batcher = ContinuousBatcher(build_model(cfg, device="cpu"),
                                cache_len=64)
    spans.enable()
    for uid in range(2):
        batcher.admit(Request(uid=uid, prompt=np.arange(24, dtype=np.int32),
                              max_new_tokens=1))
    spans.disable()
    syncs = main.reader("host_syncs_per_prefill.prefill")(PREFILL)
    assert syncs == 2 * cfg.num_layers + 2    # bincount's two a layer
    fill = main.reader("moe_slot_fill_pct.prefill")(PREFILL)
    c = spans.counters()
    assert 0 < fill == 100.0 * c["moe.slots_filled"] / c["moe.slots"] <= 100
    assert main.reader("attn_ms_per_prefill.prefill")(PREFILL) is None
