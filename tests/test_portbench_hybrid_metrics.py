"""The benchmark's pieces for granite-4.0-h-small: the scan's count of
operations and bytes (``portbench/harness/ssd_flops.py``) by hand at one
shape, the two new per-layer readers on hand-made records (each None
where it finds nothing to read), and the configuration file as the
program's configuration."""

import dataclasses
import json
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import repro_torch
from repro_torch import spans

BENCH = Path(__file__).resolve().parent.parent / "portbench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import hybrid_prefill, main, program_spans, ssd_flops  # noqa: E402

MS = 1_000_000
# The cell's scan: 128 heads of 64, a state of 128, chunks of 256.
SCAN = SimpleNamespace(ssm_heads=128, ssm_head_dim=64, ssm_state=128,
                       chunk=256)


def _ctx(spec=SCAN, kind="prefill"):
    return SimpleNamespace(kind=kind, spec=spec)


def test_ssd_counts_by_hand():
    # 2·128·(128 + 8192) within a chunk, 4·128·128·64 for the states.
    assert ssd_flops.flops_per_token(128, 64, 128, 256) == \
        2_129_920 + 4_194_304
    # x and y (8192 each), dt (128), B and C (128 each), 4 bytes.
    assert ssd_flops.bytes_per_token(128, 64, 128) == 4 * 16_768
    # 6,324,224 FLOPs at 165 TFLOP/s (38.3 ns) against 67,072 bytes at
    # 3.35 TB/s (20.0 ns): the FLOPs bound, 1,000 tokens 38.3 us.
    assert ssd_flops.bound_s(SCAN, 1000) == pytest.approx(
        1000 * 6_324_224 / 165e12)
    small = SimpleNamespace(ssm_heads=8, ssm_head_dim=16, ssm_state=16,
                            chunk=16)
    assert ssd_flops.bound_s(small, 10) == pytest.approx(
        10 * 4 * (256 + 8 + 32) / 3.35e12)


class _Book:
    """Two traced prefills: three Mamba2 mixers of 7 ms a prefill, each
    holding a scan of 4 ms; attention and feed-forward beside them."""

    def __init__(self, device=True):
        self.recs, self.t, self.device = [], 0, device

    def add(self, name, parent=None, ms=1.0):
        a = self.t
        self.t += int(ms * MS)
        dev = (a + 3, a + 3 + int(ms * MS)) if self.device else None
        self.recs.append(spans.Record(name, parent, 1, None, (a, self.t),
                                      dev))
        return len(self.recs) - 1


def _prefills(book):
    for _ in range(2):
        root = book.add("serve.prefill", ms=0.5)
        pre = book.add("prefill", root, 0.5)
        for ms in (2, 2, 3):
            m = book.add("mamba", pre, ms)
            book.add("ssd", m, 4 * ms / 7)
            book.add("ffn", pre, 5)
        book.add("attn", pre, 1)
    book.add("mamba", None, 50)          # outside every prefill: not read
    return {"host_syncs": 6, "ssd.tokens": 3 * 2 * 1000}


@pytest.fixture(autouse=True)
def _fresh():
    spans.disable()
    spans.clear()
    yield
    spans.disable()
    spans.clear()


def _fake(monkeypatch, recs, counts):
    monkeypatch.setattr(program_spans, "recorded", lambda: (recs, counts))


def test_mamba_reader(monkeypatch):
    book = _Book()
    _fake(monkeypatch, book.recs, _prefills(book))
    read = main.reader("mamba_ms_per_prefill.prefill")
    assert read(_ctx()) == pytest.approx(7.0)
    assert read(_ctx(kind="train")) is None


def test_ssd_roofline_reader(monkeypatch):
    book = _Book()
    _fake(monkeypatch, book.recs, _prefills(book))
    read = main.reader("ssd_roofline.prefill")
    spent = 2 * (4 * 2 / 7 + 4 * 2 / 7 + 4 * 3 / 7) / 1e3   # 8 ms
    want = 100 * ssd_flops.bound_s(SCAN, 6000) / spent
    assert read(_ctx()) == pytest.approx(want, rel=1e-6)
    assert read(_ctx(kind="train")) is None
    assert read(_ctx(spec=SimpleNamespace(layers=2))) is None


@pytest.mark.parametrize("name", ["mamba_ms_per_prefill.prefill",
                                  "ssd_roofline.prefill"])
def test_none_where_nothing_is_there_to_read(name, monkeypatch):
    read = main.reader(name)
    assert program_spans.recorded() is None
    assert read(_ctx()) is None
    book = _Book()                          # a dense prefill: no mixer
    root = book.add("serve.prefill")
    book.add("attn", book.add("prefill", root), 3)
    _fake(monkeypatch, book.recs, {"host_syncs": 2})
    assert read(_ctx()) is None
    off = _Book(device=False)               # off the card
    _fake(monkeypatch, off.recs, _prefills(off))
    assert read(_ctx()) is None
    monkeypatch.setattr(program_spans, "recorded", lambda: None)
    assert read(_ctx()) is None


@pytest.mark.parametrize("name", ["mamba_ms_per_prefill.prefill",
                                  "ssd_roofline.prefill"])
def test_none_where_the_program_has_no_recorder(name, monkeypatch):
    monkeypatch.delattr(repro_torch, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert main.reader(name)(_ctx()) is None


def test_readers_on_a_recorded_smoke_prefill():
    """A real recording of the smoke hybrid on the CPU: the scans' counter
    holds tokens times Mamba2 layers, and both readers give None, since
    spans off the card carry no device interval."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import build_model

    cfg = get_smoke("granite-4.0-h-small")
    model = build_model(cfg, device="cpu")
    spans.enable()
    model.prefill(torch.arange(24)[None], cache_len=32)
    spans.disable()
    counts = spans.counters()
    assert counts["ssd.tokens"] == 24 * cfg.layer_types.count("mamba")
    assert main.reader("mamba_ms_per_prefill.prefill")(_ctx()) is None
    assert main.reader("ssd_roofline.prefill")(_ctx()) is None


def test_configuration_file_is_the_programs_card_share():
    from repro_torch.configs import get_config

    conf = json.loads((BENCH / "configs" / "granite-4.0-h-small.json")
                      .read_text())
    want = dataclasses.replace(get_config("granite-4.0-h-small"),
                               experts_held=9, experts_first=0)
    assert dataclasses.asdict(hybrid_prefill.port_config(conf)) == \
        dataclasses.asdict(want)
    spec = hybrid_prefill.spec_of(conf)
    assert (spec.experts, spec.held, spec.chunk, spec.conv_dim) == \
        (72, 9, 256, 8448)
    assert conf["reduced"] == ["num_local_experts"]
    assert conf["deployment"]["published_num_local_experts"] == 72
    catalog = {k: conf[k] for k in ("hidden_size", "intermediate_size",
                                    "shared_intermediate_size",
                                    "mamba_d_state", "mamba_n_heads",
                                    "num_experts_per_tok", "vocab_size")}
    assert catalog == {"hidden_size": 4096, "intermediate_size": 768,
                       "shared_intermediate_size": 1536,
                       "mamba_d_state": 128, "mamba_n_heads": 128,
                       "num_experts_per_tok": 10, "vocab_size": 100352}
