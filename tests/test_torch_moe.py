"""The port's mixture-of-experts layer against the reference, on the CPU.

The same weights and tokens, drawn with numpy from a seed, go through
``repro.models.mlp`` and ``repro_torch.models.mlp``. The smoke configs of
olmoe-1b-7b (8 experts, top 2) and grok-1-314b (4 experts, top 2) route
512 tokens at capacity factors 100 (nothing drops), 1.25 (the default)
and 0.25 (many assignments drop), and through a zero router, where every
logit ties and ``jax.lax.top_k`` picks experts 0 to k-1.

Tolerances, with their reasons:

* the expert each assignment goes to, and the token in every slot of every
  expert's batch (which is where a drop shows), equal: integer decisions on
  the same f32 router logits, and rows copied, not summed;
* outputs 1e-5: f32 expert products of width 64-128 on values of order 1,
  summed in another order than XLA's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.models import mlp as ref_mlp
from repro_torch.configs import get_smoke
from repro_torch.models import mlp

TOL = 1e-5
TOKENS = 512


def _weights(cfg, rng, zero_router=False):
    """Router (d, E) and experts as numpy f32, of order-1 outputs."""
    d, e = cfg.d_model, cfg.num_experts
    f = cfg.moe_d_ff or cfg.d_ff
    w = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
         "wi": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "wg": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "wo": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    if zero_router:
        w["router"] = np.zeros((d, e))
    return {k: v.astype(np.float32) for k, v in w.items()}


def _pair(arch, seed, zero_router=False, dtype=torch.float32):
    """(reference config, its params, port config, the port's MoE)."""
    ref_cfg, cfg = ref_get_smoke(arch), get_smoke(arch)
    w = _weights(cfg, np.random.default_rng(seed), zero_router)
    layer = mlp.MoE(cfg, None, dtype, "meta").to_empty(device="cpu")
    with torch.no_grad():
        for name, value in w.items():
            getattr(layer, name).copy_(torch.from_numpy(value))
    return ref_cfg, {k: jnp.asarray(v) for k, v in w.items()}, cfg, layer


class _Batches:
    """Records the (E, C, d) expert batch every ``_experts_ffn`` call gets."""

    def __init__(self, monkeypatch, module):
        self.seen = []
        inner = module._experts_ffn

        def record(p, xin):
            self.seen.append(np.asarray(xin, np.float32)
                             if not torch.is_tensor(xin)
                             else xin.float().numpy())
            return inner(p, xin)

        monkeypatch.setattr(module, "_experts_ffn", record)


def _drops(idx, cfg, c):
    """Dropped assignments of expert choices ``idx`` (T, k) at capacity
    ``c``: an assignment is kept while its expert has fewer than ``c``
    earlier ones (token order), as the stable sort ranks them."""
    flat = np.asarray(idx).reshape(-1)
    seen = np.zeros(cfg.num_experts, np.int64)
    dropped = 0
    for ex in flat:
        dropped += seen[ex] >= c
        seen[ex] += 1
    return int(dropped)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "grok-1-314b"])
@pytest.mark.parametrize("factor", [100.0, 1.25, 0.25])
@pytest.mark.parametrize("impl", ["sort", "einsum"])
def test_moe_matches_reference(arch, factor, impl, monkeypatch):
    ref_cfg, params, cfg, layer = _pair(arch, seed=int(factor * 4))
    x = np.random.default_rng(1).standard_normal(
        (TOKENS, cfg.d_model)).astype(np.float32)
    ref_fn = {"sort": ref_mlp.moe_sort, "einsum": ref_mlp.moe_einsum}[impl]
    fn = {"sort": mlp.moe_sort, "einsum": mlp.moe_einsum}[impl]

    _, ref_idx = ref_mlp._router(params, jnp.asarray(x), ref_cfg)
    gates, idx = mlp._router(layer, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    assert gates.dtype == torch.float32

    c = mlp._capacity(TOKENS, cfg, factor)
    assert c == ref_mlp._capacity(TOKENS, ref_cfg, factor)
    dropped = _drops(idx, cfg, c)
    if factor == 100.0:
        assert dropped == 0
    if factor == 0.25:
        assert dropped > 0

    ref_batches = _Batches(monkeypatch, ref_mlp)
    batches = _Batches(monkeypatch, mlp)
    want = np.asarray(ref_fn(params, jnp.asarray(x), ref_cfg, factor))
    got = fn(layer, torch.from_numpy(x), cfg, factor)
    assert got.dtype == torch.float32 and got.shape == (TOKENS, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # Every slot of every expert holds the same token (or none) on both
    # sides: the same assignments kept, the same ones dropped.
    (ref_xin,), (xin,) = ref_batches.seen, batches.seen
    assert xin.shape == ref_xin.shape == (cfg.num_experts, c, cfg.d_model)
    np.testing.assert_array_equal(xin, ref_xin)
    # A token all of whose assignments dropped gets exactly nothing.
    row_of = {row.tobytes(): t for t, row in enumerate(x)}
    kept = {row_of[row.tobytes()] for row in xin.reshape(-1, cfg.d_model)
            if row.tobytes() in row_of}
    lost = np.setdiff1d(np.arange(TOKENS), sorted(kept))
    assert len(lost) > 0 or factor > 1
    assert np.all(got.numpy()[lost] == 0) and np.all(want[lost] == 0)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "grok-1-314b"])
def test_zero_router_ties_pick_the_lowest_experts(arch, monkeypatch):
    """Every logit ties: both sides send every token to experts 0..k-1
    with equal gates, so at factor 1.25 the later tokens drop."""
    ref_cfg, params, cfg, layer = _pair(arch, seed=3, zero_router=True)
    x = np.random.default_rng(2).standard_normal(
        (TOKENS, cfg.d_model)).astype(np.float32)
    gates, idx = mlp._router(layer, torch.from_numpy(x), cfg)
    ref_gates, ref_idx = ref_mlp._router(params, jnp.asarray(x), ref_cfg)
    k = cfg.experts_per_tok
    assert (idx.numpy() == np.arange(k)).all()
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(ref_gates),
                               rtol=0, atol=TOL)
    c = mlp._capacity(TOKENS, cfg, 1.25)
    assert _drops(idx, cfg, c) == k * (TOKENS - c)
    for impl in ("sort", "einsum"):
        want = np.asarray(getattr(ref_mlp, f"moe_{impl}")(
            params, jnp.asarray(x), ref_cfg, 1.25))
        got = getattr(mlp, f"moe_{impl}")(layer, torch.from_numpy(x), cfg,
                                          1.25).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        assert np.all(got[c:] == 0) and np.any(got[:c] != 0)


@pytest.mark.parametrize("impl", ["sort", "einsum", "ep_local"])
def test_token_chunks_match_reference(impl):
    """``moe`` over (B, S, d) with a token chunk smaller than B·S that
    does not divide it: each chunk routes alone, the last one at a whole
    chunk's capacity, as the reference's padded one."""
    ref_cfg, params, cfg, layer = _pair("olmoe-1b-7b", seed=5)
    x = np.random.default_rng(4).standard_normal(
        (3, 50, cfg.d_model)).astype(np.float32)
    want = np.asarray(ref_mlp.moe(params, jnp.asarray(x), ref_cfg,
                                  impl=impl, capacity_factor=0.25,
                                  token_chunk=64))
    got = mlp.moe(layer, torch.from_numpy(x), cfg, impl=impl,
                  capacity_factor=0.25, token_chunk=64)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    # Chunking changes which assignments drop: not the one-call result.
    whole = mlp.moe(layer, torch.from_numpy(x), cfg, impl=impl,
                    capacity_factor=0.25, token_chunk=1 << 16)
    assert not torch.allclose(whole, got, rtol=0, atol=TOL)


@pytest.mark.parametrize("impl", ["sort", "einsum"])
def test_last_chunk_routes_only_its_real_rows(impl):
    """A short last chunk routes its own rows at a whole chunk's
    capacity: equal to the chunk filled up with zero rows and cut (the
    reference's form), while the assignments counted are the real
    tokens' alone."""
    from repro_torch import spans
    _, _, cfg, layer = _pair("olmoe-1b-7b", seed=9)
    # 600 rows in the last chunk drop at its own capacity (64 slots) and
    # at a whole chunk's (96), but not the same assignments.
    t, chunk = 1624, 1024
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(
        (t, cfg.d_model)).astype(np.float32))
    fn = getattr(mlp, f"moe_{impl}")
    padded = torch.cat([x, torch.zeros((2 * chunk - t, cfg.d_model))])
    want = torch.cat([fn(layer, xi, cfg, 0.25)
                      for xi in padded.split(chunk)])[:t]
    assert not torch.equal(fn(layer, x[chunk:], cfg, 0.25), want[chunk:])
    for grad in (False, True):          # the plain and checkpointed loops
        spans.clear()
        spans.enable()
        try:
            with torch.set_grad_enabled(grad):
                got = mlp._chunked(fn, layer, x, cfg, 0.25, chunk, 0)
        finally:
            spans.disable()
        assert torch.equal(got, want)
        if impl == "sort":
            assert (spans.counters()["moe.assignments"]
                    == t * cfg.experts_per_tok)
    spans.clear()


def test_token_chunks_are_checkpointed_under_grad():
    """Under grad the chunk loop runs through ``torch.utils.checkpoint``
    and the gradient equals the unchunked layer's where nothing drops."""
    _, _, cfg, layer = _pair("grok-1-314b", seed=6)
    for p in layer.parameters():
        p.requires_grad_(True)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, 40, cfg.d_model)).astype(np.float32))
    grads = []
    for chunk in (1 << 16, 40):
        layer.zero_grad()
        mlp.moe(layer, x, cfg, capacity_factor=100.0,
                token_chunk=chunk).square().sum().backward()
        grads.append({n: p.grad.clone() for n, p in layer.named_parameters()
                      if n != "router"})
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name],
                                   rtol=1e-5, atol=1e-5)


def test_bf16_experts_keep_an_f32_router():
    _, _, cfg, layer = _pair("olmoe-1b-7b", seed=8, dtype=torch.bfloat16)
    assert layer.router.dtype == torch.float32
    assert layer.wi.dtype == torch.bfloat16
    x = torch.randn(1, 9, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0)).to(torch.bfloat16)
    y = mlp.moe(layer, x, cfg)
    assert y.dtype == torch.bfloat16 and torch.isfinite(y.float()).all()
    with pytest.raises(ValueError, match="not one of"):
        mlp.moe(layer, x, cfg, impl="dense")
