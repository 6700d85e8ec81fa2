"""The trace's reduction and the per-layer readers on made-up events."""

import types

import pytest

from harness import flops, main
from harness.trace import WINDOW, reduce_intervals
from reference.decoder import Spec

MS = 1_000_000   # ns


def test_busy_gaps_and_spans():
    spans = [(WINDOW, 0, 100 * MS), ("pb.admit", 0, 60 * MS),
             ("pb.prefill", 10 * MS, 50 * MS)]
    device = [("gemm", 10 * MS, 30 * MS), ("fa_forward_kernel<float, 64>",
                                          25 * MS, 40 * MS),
              ("Memcpy HtoD", 45 * MS, 50 * MS), ("late", 99 * MS, 120 * MS)]
    r = reduce_intervals(spans, device)
    assert r.window_s == pytest.approx(0.1)
    # Union: 10–40, 45–50, 99–100 → 36 ms.
    assert r.busy_s == pytest.approx(0.036)
    # Gaps: 0–10 (admit open, prefill opens at 10: mid 5 → admit),
    # 40–45 (prefill), 50–99 (mid 74.5: no span but the window).
    assert r.idle_by_span == pytest.approx({"pb.admit": 0.010,
                                            "pb.prefill": 0.005,
                                            WINDOW: 0.049})
    assert [n for n, _ in r.kernels] == ["gemm",
                                         "fa_forward_kernel<float, 64>",
                                         "late"]
    assert r.breakdown()["device_ops"][0] == ["gemm", pytest.approx(0.02)]


def _ctx(**kw):
    spec = Spec(layers=2, d_model=64, heads=4, kv_heads=2, head_dim=16,
                d_ff=128, vocab=500, padded_vocab=512, tied=True,
                rope_theta=1e4, eps=1e-5)
    base = dict(kind="prefill", spec=spec, prompts=[100, 200],
                queue_ms=[3.0, 1.0, 2.0], steps=0, batch=2, seq_len=32)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_readers():
    reading = types.SimpleNamespace(
        window_s=2.0, busy_s=1.5,
        kernels=[("fa_forward_kernel<float, 16>", 0.001)] * 3
        + [("gemm", 0.1)])
    ctx = _ctx(reading=reading)
    assert main.reader("queue_ms_p50.prefill")(ctx) == 2.0
    assert main.reader("device_idle_pct.prefill")(ctx) == pytest.approx(25.0)
    assert main.reader("device_idle_pct.train")(ctx) is None
    work = flops.prefill_flops(ctx.spec, 100) + flops.prefill_flops(
        ctx.spec, 200)
    assert main.reader("mfu.prefill")(ctx) == pytest.approx(
        100 * work / (2.0 * 165e12))
    # 4 launches expected (2 layers × 2 prompts), 3 recorded at 1 ms.
    bound = 2 * (flops.b4_bound_s(ctx.spec, 100)
                 + flops.b4_bound_s(ctx.spec, 200))
    assert main.reader("b4_roofline.prefill")(ctx) == pytest.approx(
        100 * bound / 0.004)
    train = _ctx(kind="train", reading=reading, steps=2)
    assert main.reader("kernels_per_step.train")(train) == 2.0
    assert main.reader("mfu.train")(train) == pytest.approx(
        100 * 2 * flops.train_step_flops(train.spec, 2, 32) / (2.0 * 165e12))
    assert main.reader("mfu.prefill")(_ctx(reading=None)) is None
