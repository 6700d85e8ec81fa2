"""The port's spans on the card (skipped without one): every host-device
sync of the measured paths is a named ``sync.*`` span.

Kept free of ``jax`` and ``repro``, like ``tests/test_torch_cuda.py``:
``python -m pytest -q -m cuda tests/test_torch_cuda_spans.py``. A granite-
and an olmoe-shaped prefill (published widths, two layers, a prompt of
1,000 tokens) through ``ContinuousBatcher.admit``, and a granite-shaped
training step in the training launcher's run configuration and
deterministic mode, run under ``torch.cuda.set_sync_debug_mode("warn")``
with recording on: the warnings (one a sync) equal the ``host_syncs``
counter, whose spans are the path's named syncs (``torch.bincount``'s
span counts its two): the prompt's upload and the greedy pick in a dense
prefill, with two more a MoE layer, and none in a training step (rope's
table stays on the card after the first call). The same runs check the device intervals: each
span but the syncs has one, inside its parent's up to the anchor's few
microseconds.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.launch.train import (deterministic, run_config,
                                      set_cublas_workspace)
from repro_torch.models import build_model
from repro_torch.serve.batching import ContinuousBatcher, Request
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (StepConfig, init_train_state,
                                          make_train_step)

# Deterministic training on the card needs the cuBLAS workspace set before
# the first product; collection imports this module before any test runs.
set_cublas_workspace()

LAYERS = 2
SLACK_NS = 50_000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: sync debug mode is CUDA's")
    spans.disable()
    spans.clear()
    yield torch.device("cuda")
    spans.disable()
    spans.clear()


def _under_sync_debug(run):
    """``run()`` with recording on and every sync warned of: (where each
    warning came from, the ``host_syncs`` counter, the records)."""
    spans.enable()
    with spans.span("anchor"):       # the recorder's own first sync
        pass
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    spans.disable()
    sites = [f"{w.filename}:{w.lineno}" for w in got
             if "synchroniz" in str(w.message)]
    return sites, spans.counters().get("host_syncs", 0), spans.records()


def _nested(recs):
    for r in recs:
        if r.name.startswith("sync."):       # the host's waits: no events
            assert r.device_ns is None
            continue
        assert r.device_ns is not None and r.device_ns[0] <= r.device_ns[1]
        if r.parent is not None:
            p = recs[r.parent].device_ns
            assert p[0] - SLACK_NS <= r.device_ns[0], (r, recs[r.parent])
            assert r.device_ns[1] <= p[1] + SLACK_NS, (r, recs[r.parent])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["granite-3-2b", "olmoe-1b-7b"])
def test_every_sync_of_a_prefill_is_named(cuda, name):
    cfg = dataclasses.replace(get_config(name), num_layers=LAYERS)
    batcher = ContinuousBatcher(build_model(cfg, device=cuda),
                                cache_len=1024)
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, 1000,
                                               dtype=np.int32)

    def admit(uid):
        (done,) = batcher.admit(Request(uid, prompt, max_new_tokens=1))
        assert done.out_tokens

    admit(0)                          # builds B4 and the first-call state
    torch.cuda.synchronize()
    sites, syncs, recs = _under_sync_debug(lambda: admit(1))
    assert len(sites) == syncs, "\n".join(sites)
    assert syncs == (2 * LAYERS if cfg.num_experts else 0) + 2
    _nested(recs)


@pytest.mark.cuda
def test_every_sync_of_a_train_step_is_named(cuda):
    cfg = dataclasses.replace(get_config("granite-3-2b"), num_layers=LAYERS)
    model = build_model(cfg, device=cuda,
                        rc=run_config(cfg, smoke=False, seq_len=1024))
    oc = OptConfig()
    state = [init_train_state(model, oc)]
    step = make_train_step(model, oc, StepConfig())
    tokens = torch.randint(0, cfg.vocab_size, (2, 1024), device=cuda)

    def run():
        state[0], _ = step(state[0], {"tokens": tokens, "labels": tokens})

    with deterministic(cuda):
        run()
        torch.cuda.synchronize()
        sites, syncs, recs = _under_sync_debug(run)
    assert len(sites) == syncs, "\n".join(sites)
    assert syncs == 0
    _nested(recs)
