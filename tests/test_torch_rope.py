"""Rope's frequency table kept on the device (``common.rope_table``).

``apply_rope`` reads its f32 inverse frequencies from a cache keyed by
``(head_dim, theta, device)`` instead of copying them from the host on
every call. Its output and its gradient are held with ``torch.equal`` to
the per-call formula it replaced, kept here as ``_rope_per_call``; each
cache miss counts one ``rope.table_builds`` and a hit counts nothing; a
no-grad prefill that fills the cache leaves a table that a training step
with autograd uses as the formula's. Kept free of ``jax`` and ``repro``,
so the ``cuda``-marked case runs on the card:
``python -m pytest -q -m cuda tests/test_torch_rope.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.configs import get_smoke
from repro_torch.launch.train import run_config
from repro_torch.models import build_model, common
from repro_torch.serve.batching import ContinuousBatcher, Request
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (StepConfig, init_train_state,
                                          make_train_step)


def _rope_per_call(x, positions, theta):
    """``apply_rope`` as it was: the table copied from the host a call."""
    half = x.shape[-1] // 2
    freqs = torch.as_tensor(common.rope_frequencies(x.shape[-1], theta),
                            dtype=torch.float32, device=x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    monkeypatch.setattr(common, "_ROPE_TABLES", {})
    spans.disable()
    spans.clear()
    yield
    spans.disable()
    spans.clear()


def _inputs(shape, positions_2d, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=g)
    b, s = shape[:2]
    pos = torch.arange(s, dtype=torch.int32) * 3 + 5
    if positions_2d:
        pos = pos[None, :].repeat(b, 1) + torch.arange(b, dtype=torch.int32)[
            :, None] * 7
    return x.to(device), pos.to(device)


@pytest.mark.parametrize("positions_2d", [False, True], ids=["1d", "2d"])
@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("head_dim", [64, 80, 128, 160])
def test_apply_rope_equals_the_per_call_formula(head_dim, theta,
                                                positions_2d):
    x, pos = _inputs((2, 37, 3, head_dim), positions_2d)
    want = _rope_per_call(x, pos, theta)
    for _ in range(2):                    # the build, then the cached table
        assert torch.equal(common.apply_rope(x, pos, theta), want)


def test_apply_rope_equals_the_per_call_formula_in_bf16():
    x, pos = _inputs((2, 37, 3, 64), True)
    x = x.to(torch.bfloat16)
    got = common.apply_rope(x, pos, 1e4)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, _rope_per_call(x, pos, 1e4))


def test_table_builds_count_each_new_key_once():
    spans.enable()
    for head_dim, theta in [(64, 1e4), (64, 1e4), (128, 1e4), (64, 1e6),
                            (128, 1e4), (64, 1e6)]:
        x, pos = _inputs((1, 5, 2, head_dim), False)
        common.apply_rope(x, pos, theta)
    assert spans.counters() == {"rope.table_builds": 3}
    spans.clear()
    x, pos = _inputs((1, 5, 2, 64), False)
    common.apply_rope(x, pos, 1e4)
    assert spans.counters() == {}
    # Keyed by the device: a meta tensor gets a table of its own.
    xm = torch.empty((1, 5, 2, 64), device="meta")
    pm = torch.empty((5,), dtype=torch.int32, device="meta")
    assert common.apply_rope(xm, pm, 1e4).device.type == "meta"
    assert spans.counters() == {"rope.table_builds": 1}
    assert sorted(k[2].type for k in common._ROPE_TABLES) == \
        ["cpu", "cpu", "cpu", "meta"]
    table = common.rope_table(64, 1e4, torch.device("cpu"))
    assert table.dtype == torch.float32 and not table.requires_grad
    assert torch.equal(table, torch.from_numpy(
        common.rope_frequencies(64, 1e4)).float())


def test_no_grad_prefill_then_training_step_with_autograd():
    cfg = get_smoke("granite-3-2b")
    model = build_model(cfg, device="cpu",
                        rc=run_config(cfg, smoke=False, seq_len=32))
    prompt = (np.arange(24, dtype=np.int32) * 5) % cfg.vocab_size
    batcher = ContinuousBatcher(model, max_slots=2, cache_len=64)
    spans.enable()
    (done,) = batcher.admit(Request(uid=1, prompt=prompt, max_new_tokens=1))
    assert done.out_tokens
    assert spans.counters()["rope.table_builds"] == 1
    spans.clear()

    oc = OptConfig()
    state = init_train_state(model, oc)
    step = make_train_step(model, oc, StepConfig())
    tokens = torch.randint(0, cfg.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(0))
    state, metrics = step(state, {"tokens": tokens, "labels": tokens})
    assert np.isfinite(float(metrics["loss"]))
    assert spans.counters() == {}         # the prefill's table, reused
    spans.disable()

    x, pos = _inputs((2, 32, cfg.num_heads, cfg.head_dim), False, seed=3)
    w = torch.randn(x.shape, generator=torch.Generator().manual_seed(4))
    grads = []
    for rope in (common.apply_rope, _rope_per_call):
        q = x.clone().requires_grad_(True)
        (g,) = torch.autograd.grad((rope(q, pos, cfg.rope_theta) * w).sum(),
                                   q)
        grads.append(g)
    assert torch.equal(*grads)


@pytest.mark.cuda
def test_apply_rope_on_the_card_at_granites_prefill_shape():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the table's device is the card")
    cuda = torch.device("cuda")
    theta = 1e4                           # granite-3-2b: 32 q / 8 kv heads
    for heads in (32, 8):
        x, pos = _inputs((1, 3856, heads, 64), False, device=cuda)
        want = _rope_per_call(x, pos, theta)
        for _ in range(2):
            assert torch.equal(common.apply_rope(x, pos, theta), want)
    (key,) = common._ROPE_TABLES
    assert key[2] == torch.device("cuda", torch.cuda.current_device())
