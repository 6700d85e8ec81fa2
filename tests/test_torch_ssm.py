"""The port's Mamba2 / SSD block (``repro_torch/models/ssm.py``) against
the reference's, on the CPU.

Inputs are drawn with numpy from a seed; ``A_log`` and ``dt_bias`` are
drawn away from their init constants (0), so a spread of decays is seen.
T = 21 is not a multiple of the chunk, so ``ssd_chunked`` pads, and its
initial state is not zero.

Tolerances: 1e-5 absolute plus 1e-5 relative on SSD outputs and states,
which reach ~30 (sums over a chunk of products of order 1, f32
throughout, einsums summed in another order); 1e-5 on the block's
outputs and conv states (f32 products of width 64 and 128); the chained
decode steps against the full-sequence block 1e-4 (the chunked and the
stepwise forms of the same recurrence, T = 21).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.models import ssm as ref_ssm
from repro.models.common import KeyGen
from repro.models.sharding import ShardingPlan
from repro_torch.configs import get_smoke
from repro_torch.models import ssm

TOL = 1e-5
B, T, H, P, N = 2, 21, 3, 8, 6


def _close(got, want, tol=TOL, rtol=0.0):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=tol)


def _ssd_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, H, P)).astype(np.float32)
    a_log = -rng.uniform(0.0, 3.0, (B, T, H)).astype(np.float32)
    bv = rng.standard_normal((B, T, N)).astype(np.float32)
    cv = rng.standard_normal((B, T, N)).astype(np.float32)
    s0 = rng.standard_normal((B, H, N, P)).astype(np.float32)
    return x, a_log, bv, cv, s0


@pytest.mark.parametrize("chunk,init", [(8, True), (16, False), (64, True)])
def test_ssd_chunked_matches_reference(chunk, init):
    x, a_log, bv, cv, s0 = _ssd_inputs(chunk)
    ry, rs = ref_ssm.ssd_chunked(
        jnp.asarray(x), jnp.asarray(a_log), jnp.asarray(bv), jnp.asarray(cv),
        chunk=chunk, init_state=jnp.asarray(s0) if init else None)
    y, s = ssm.ssd_chunked(
        torch.from_numpy(x), torch.from_numpy(a_log), torch.from_numpy(bv),
        torch.from_numpy(cv), chunk=chunk,
        init_state=torch.from_numpy(s0) if init else None)
    assert y.shape == (B, T, H, P) and s.shape == (B, H, N, P)
    assert torch.isfinite(y).all()
    _close(y, ry, rtol=TOL)
    _close(s, rs, rtol=TOL)


def test_ssd_step_chained_equals_ssd_chunked():
    """The decode recurrence step by step gives the chunked form's outputs
    and final state, from the same initial state."""
    x, a_log, bv, cv, s0 = (torch.from_numpy(a) for a in _ssd_inputs(7))
    y, s = ssm.ssd_chunked(x, a_log, bv, cv, chunk=8, init_state=s0)
    state = s0
    for t in range(T):
        state, yt = ssm.ssd_step(state, x[:, t], torch.exp(a_log[:, t]),
                                 bv[:, t], cv[:, t])
        _close(yt, y[:, t].numpy(), 1e-4)
    _close(state, s.numpy(), 1e-4)
    rs, ry = ref_ssm.ssd_step(*(jnp.asarray(a.numpy()) for a in (
        s0, x[:, 0], torch.exp(a_log[:, 0]), bv[:, 0], cv[:, 0])))
    got_s, got_y = ssm.ssd_step(s0, x[:, 0], torch.exp(a_log[:, 0]),
                                bv[:, 0], cv[:, 0])
    _close(got_s, rs)
    _close(got_y, ry)


@pytest.mark.parametrize("t", [1, 2, 5])
def test_causal_conv_matches_reference(t):
    """Including decode's t = 1 < K−1, whose new state is the last K−1
    rows of state ++ xs."""
    rng = np.random.default_rng(t)
    xs = rng.standard_normal((B, t, 10)).astype(np.float32)
    w = rng.standard_normal((ssm.CONV_K, 10)).astype(np.float32)
    st = rng.standard_normal((B, ssm.CONV_K - 1, 10)).astype(np.float32)
    for state in (st, None):
        ro, rn = ref_ssm._causal_conv(jnp.asarray(xs), jnp.asarray(w),
                                      None if state is None
                                      else jnp.asarray(state))
        o, n = ssm._causal_conv(torch.from_numpy(xs), torch.from_numpy(w),
                                None if state is None
                                else torch.from_numpy(state))
        _close(o, ro)
        _close(n, rn, 0.0)


@pytest.fixture(scope="module")
def mamba():
    cfg = ref_get_smoke("zamba2-2.7b")
    tree = {k: np.array(p.value) for k, p in ref_ssm.init_mamba(
        cfg, KeyGen(jax.random.PRNGKey(0)), jnp.float32,
        ShardingPlan.null()).items()}
    rng = np.random.default_rng(9)
    for name in ("A_log", "dt_bias"):
        tree[name] = rng.uniform(-1.0, 1.0, tree[name].shape).astype(
            np.float32)
    pcfg = get_smoke("zamba2-2.7b")
    mod = ssm.Mamba(pcfg, None, torch.float32, "meta").to_empty(device="cpu")
    assert {n for n, _ in mod.named_parameters()} == set(tree)
    with torch.no_grad():
        for name, value in tree.items():
            getattr(mod, name).copy_(torch.from_numpy(value))
    return cfg, pcfg, {k: jnp.asarray(v) for k, v in tree.items()}, mod


def _cache(cfg, rng):
    d_in, h, n = ssm.ssm_dims(cfg)
    conv = rng.standard_normal((B, ssm.CONV_K - 1, d_in)).astype(np.float32)
    st = rng.standard_normal((B, h, n, cfg.ssm_head_dim)).astype(np.float32)
    return conv, st


def test_mamba_block_and_step_match_reference(mamba):
    cfg, pcfg, jp, mod = mamba
    rng = np.random.default_rng(10)
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    conv, st = _cache(pcfg, rng)
    ro, rc = ref_ssm.mamba_block(jp, cfg, jnp.asarray(x), ref_ssm.MambaCache(
        conv=jnp.asarray(conv), ssm=jnp.asarray(st)), chunk=8)
    o, c = ssm.mamba_block(mod, pcfg, torch.from_numpy(x), ssm.MambaCache(
        conv=torch.from_numpy(conv), ssm=torch.from_numpy(st)), chunk=8)
    _close(o, ro)
    _close(c.conv, rc.conv)
    _close(c.ssm, rc.ssm)
    ro, rc = ref_ssm.mamba_step(jp, cfg, jnp.asarray(x[:, :1]),
                                ref_ssm.MambaCache(conv=jnp.asarray(conv),
                                                   ssm=jnp.asarray(st)))
    o, c = ssm.mamba_step(mod, pcfg, torch.from_numpy(x[:, :1]),
                          ssm.MambaCache(conv=torch.from_numpy(conv),
                                         ssm=torch.from_numpy(st)))
    _close(o, ro)
    _close(c.conv, rc.conv)
    _close(c.ssm, rc.ssm)


def test_mamba_step_chained_equals_mamba_block(mamba):
    """T one-token steps from the block's empty cache give the block's
    outputs and final cache."""
    _, pcfg, _, mod = mamba
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal((B, T, pcfg.d_model)).astype(
        np.float32))
    out, cache = ssm.mamba_block(mod, pcfg, x, chunk=8)
    step = ssm.init_mamba_cache(pcfg, B)
    for t in range(T):
        o, step = ssm.mamba_step(mod, pcfg, x[:, t:t + 1], step)
        _close(o, out[:, t:t + 1].numpy(), 1e-4)
    _close(step.conv, cache.conv.numpy())
    _close(step.ssm, cache.ssm.numpy(), 1e-4)
