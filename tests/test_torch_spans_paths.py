"""The spans and counters of the port's two measured paths, on the CPU at
smoke sizes.

* a dense (granite-shaped) and a MoE (olmoe-shaped) prefill through
  ``ContinuousBatcher.admit``: one ``serve.prefill`` under the request's
  id holding one ``prefill``, one ``attn`` and one ``ffn`` a layer and
  one ``logits``; the syncs named where they are made (the prompt's
  upload, the MoE counts a layer, the greedy pick; rope's table is kept
  on the device, so attention holds none), ``host_syncs`` their waits
  (two for the MoE counts); the MoE counters equal what the router's own
  top-k gives at the dispatch's capacity;
* a training step: ``train.step`` holding ``train.forward``,
  ``train.backward`` and ``train.optimizer``, with no sync and, once
  rope's table is cached, no counter;
* recording off: the same paths create no CUDA event and synchronise
  nothing even where CUDA has started (faked), and recording on runs the
  same operators as off (the MoE counters' three reductions a layer
  apart).
"""

import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import spans
from repro_torch.configs import get_smoke
from repro_torch.launch.train import run_config
from repro_torch.models import build_model, common, mlp
from repro_torch.serve.batching import ContinuousBatcher, Request
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (StepConfig, init_train_state,
                                          make_train_step)

PROMPT = 40


@pytest.fixture(autouse=True)
def _fresh():
    spans.disable()
    spans.clear()
    yield
    spans.disable()
    spans.clear()


class _Ops(TorchDispatchMode):
    """Counts the ATen operators dispatched."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _prefill(name, uid=7):
    cfg = get_smoke(name)
    model = build_model(cfg, device="cpu")
    batcher = ContinuousBatcher(model, max_slots=4, cache_len=64)
    prompt = (np.arange(PROMPT, dtype=np.int32) * 7) % cfg.vocab_size
    return cfg, lambda: batcher.admit(Request(uid=uid, prompt=prompt,
                                              max_new_tokens=1))


def _train_step():
    cfg = get_smoke("granite-3-2b")
    model = build_model(cfg, device="cpu",
                        rc=run_config(cfg, smoke=False, seq_len=32))
    oc = OptConfig()
    state = [init_train_state(model, oc)]
    step = make_train_step(model, oc, StepConfig())
    tokens = torch.randint(0, cfg.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(0))

    def run():
        state[0], _ = step(state[0], {"tokens": tokens, "labels": tokens})
    return cfg, run


def _names_under(recs, parent):
    return collections.Counter(r.name for r in recs
                               if r.parent is not None
                               and recs[r.parent].name == parent)


@pytest.mark.parametrize("name", ["granite-3-2b", "olmoe-1b-7b"])
def test_prefill_spans_and_syncs(name, monkeypatch):
    monkeypatch.setattr(common, "_ROPE_TABLES", {})
    cfg, admit = _prefill(name)
    moe = bool(cfg.num_experts)
    spans.enable()
    (done,) = admit()
    spans.disable()
    assert done.uid == 7 and len(done.out_tokens) == 1
    recs = spans.records()
    layers = cfg.num_layers
    assert recs[0].name == "serve.prefill" and recs[0].parent is None
    assert all(r.request == 7 for r in recs)
    assert _names_under(recs, "serve.prefill") == {
        "sync.tokens": 1, "prefill": 1, "sync.greedy": 1}
    assert _names_under(recs, "prefill") == {"attn": layers,
                                             "ffn": layers, "logits": 1}
    assert _names_under(recs, "attn") == {}
    if moe:
        assert _names_under(recs, "ffn") == {
            "moe.route": layers, "moe.dispatch": layers,
            "moe.experts": layers, "moe.combine": layers}
        assert _names_under(recs, "moe.dispatch") == {"sync.bincount":
                                                      layers}
    else:
        assert _names_under(recs, "ffn") == {}
    named = (layers if moe else 0) + 2
    assert sum(r.name.startswith("sync.") for r in recs) == named
    got = spans.counters()
    assert got["host_syncs"] == named + (layers if moe else 0)
    assert got["rope.table_builds"] == 1      # one head dim, theta, device


def test_moe_counters_match_the_routers_own_choice(monkeypatch):
    cfg, admit = _prefill("olmoe-1b-7b")
    seen = []
    sort = mlp.moe_sort

    def spy(p, x, cfg_, factor=1.25, first=0):
        _, idx = mlp._router(p, x, cfg_)
        per_expert = torch.bincount(idx.reshape(-1),
                                    minlength=cfg_.num_experts)
        c = mlp._capacity(x.shape[0], cfg_, factor)
        seen.append((int(per_expert.clamp(max=c).sum()), idx.numel(),
                     cfg_.num_experts * c))
        return sort(p, x, cfg_, factor, first)

    monkeypatch.setattr(mlp, "moe_sort", spy)
    spans.enable()
    admit()
    spans.disable()
    assert len(seen) == cfg.num_layers
    kept, assigned, slots = (sum(v) for v in zip(*seen))
    assert assigned == cfg.num_layers * PROMPT * cfg.experts_per_tok
    got = spans.counters()
    assert (got["moe.slots_filled"], got["moe.assignments"],
            got["moe.slots"], got["moe.dropped"]) == (
        kept, assigned, slots, assigned - kept)


def test_train_step_spans():
    _, run = _train_step()
    run()                                 # rope's table built and cached
    spans.enable()
    run()
    spans.disable()
    recs = spans.records()
    assert recs[0].name == "train.step" and recs[0].parent is None
    assert _names_under(recs, "train.step") == {
        "train.forward": 1, "train.backward": 1, "train.optimizer": 1}
    assert _names_under(recs, "train.forward") == {}
    assert spans.counters() == {}


@pytest.mark.parametrize("path", ["granite-3-2b", "olmoe-1b-7b", "train"])
def test_recording_off_adds_no_event_sync_or_operator(path, monkeypatch):
    if path == "train":
        cfg, run = _train_step()
    else:
        cfg, run = _prefill(path)
    run()                                 # first-call work out of the way
    ops_off, ops_on = _Ops(), _Ops()
    with monkeypatch.context() as m:
        def no(*a, **k):
            raise AssertionError("recording off touched CUDA")
        m.setattr(torch.cuda, "Event", no)
        m.setattr(torch.cuda, "synchronize", no)
        m.setattr(spans, "_device", lambda: 0)
        with ops_off:
            run()
    assert spans.records() == [] and spans.counters() == {}
    spans.enable()
    with ops_on:
        run()
    spans.disable()
    assert spans.records()
    moe_reductions = 3 * cfg.num_layers if cfg.num_experts else 0
    assert ops_on.n == ops_off.n + moe_reductions
