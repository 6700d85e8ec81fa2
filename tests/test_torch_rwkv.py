"""The port's RWKV6 block (``repro_torch/models/rwkv.py``) against the
reference's, on the CPU.

Inputs are drawn with numpy from a seed; the bonus ``u`` and the decay
``w0`` are drawn away from their init constants (0 and −2), so the bonus
term and a spread of decays are both seen, and the initial wkv state is
not zero. T = 21 is not a multiple of any chunk, so ``rwkv_chunked`` pads.

Tolerances: 1e-5 on outputs and states of order 1 for the evaluators (f32
throughout, the reference's einsums summed in another order); 1e-5 for the
time and channel mix, whose projections are f32 products of width 64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.models import rwkv as ref_rwkv
from repro.models.common import KeyGen
from repro.models.sharding import ShardingPlan
from repro_torch.configs import get_smoke
from repro_torch.models import rwkv

TOL = 1e-5
B, T, H, N = 2, 21, 3, 8


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=tol)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, N)).astype(np.float32)
               for _ in range(3))
    # log w in [-e, 0): what _projections' clamp gives.
    logw = -np.exp(rng.uniform(-8.0, 1.0, (B, T, H, N))).astype(np.float32)
    u = (0.5 * rng.standard_normal((H, N))).astype(np.float32)
    state = rng.standard_normal((B, H, N, N)).astype(np.float32)
    return r, k, v, logw, u, state


def _both(fn, ref_fn, arrays, **kw):
    want = ref_fn(*(jnp.asarray(a) for a in arrays), **kw)
    got = fn(*(torch.from_numpy(a) for a in arrays), **kw)
    return got, want


def test_rwkv_scan_matches_reference():
    (o, s), (ro, rs) = _both(rwkv.rwkv_scan, ref_rwkv.rwkv_scan, _inputs(0))
    assert o.shape == (B, T, H, N) and s.shape == (B, H, N, N)
    _close(o, ro)
    _close(s, rs)


@pytest.mark.parametrize("chunk", [16, 8])
def test_rwkv_chunked_matches_reference_and_the_scan(chunk):
    arrays = _inputs(1)
    (o, s), (ro, rs) = _both(rwkv.rwkv_chunked, ref_rwkv.rwkv_chunked,
                             arrays, chunk=chunk)
    _close(o, ro)
    _close(s, rs)
    so, ss = rwkv.rwkv_scan(*(torch.from_numpy(a) for a in arrays))
    _close(o, so.numpy(), 1e-4)
    _close(s, ss.numpy(), 1e-4)


def test_rwkv_chunked_refuses_chunks_past_32():
    arrays = [torch.from_numpy(a) for a in _inputs(2)]
    with pytest.raises(ValueError, match="chunk=32"):
        rwkv.rwkv_chunked(*arrays, chunk=64)
    rwkv.rwkv_chunked(*arrays, chunk=32)


@pytest.fixture(scope="module")
def mixes():
    """The reference's smoke time and channel mix with ``u`` and ``w0``
    moved off their init values, and the port's holding the same."""
    cfg = ref_get_smoke("rwkv6-1.6b")
    kg = KeyGen(jax.random.PRNGKey(0))
    plan = ShardingPlan.null()
    rng = np.random.default_rng(3)
    tm = {k: np.array(p.value) for k, p in
          ref_rwkv.init_rwkv_time_mix(cfg, kg, jnp.float32, plan).items()}
    tm["u"] = (0.5 * rng.standard_normal(tm["u"].shape)).astype(np.float32)
    tm["w0"] = rng.uniform(-3.0, -0.5, tm["w0"].shape).astype(np.float32)
    cm = {k: np.array(p.value) for k, p in
          ref_rwkv.init_rwkv_channel_mix(cfg, kg, jnp.float32, plan).items()}
    port = []
    pcfg = get_smoke("rwkv6-1.6b")
    for cls, tree in ((rwkv.RWKVTimeMix, tm), (rwkv.RWKVChannelMix, cm)):
        mod = cls(pcfg, None, torch.float32, "meta").to_empty(device="cpu")
        assert {n for n, _ in mod.named_parameters()} == set(tree)
        with torch.no_grad():
            for name, value in tree.items():
                getattr(mod, name).copy_(torch.from_numpy(value))
        port.append(mod)
    return cfg, pcfg, tm, cm, port[0], port[1]


@pytest.mark.parametrize("impl", ["chunked", "scan"])
def test_time_mix_matches_reference(mixes, impl):
    cfg, pcfg, tm, _, ptm, _ = mixes
    rng = np.random.default_rng(4)
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    prev = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    h, n = rwkv.rwkv_dims(pcfg)
    state = rng.standard_normal((B, h, n, n)).astype(np.float32)
    ro, rc, rs = ref_rwkv.rwkv_time_mix(
        {k: jnp.asarray(v) for k, v in tm.items()}, cfg, jnp.asarray(x),
        jnp.asarray(prev), jnp.asarray(state), impl=impl)
    o, c, s = rwkv.rwkv_time_mix(ptm, pcfg, torch.from_numpy(x),
                                 torch.from_numpy(prev),
                                 torch.from_numpy(state), impl=impl)
    _close(o, ro)
    _close(c, rc, 0.0)
    _close(s, rs)


def test_channel_mix_and_cache_match_reference(mixes):
    cfg, pcfg, _, cm, _, pcm = mixes
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, T, cfg.d_model)).astype(np.float32)
    prev = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ro, rc = ref_rwkv.rwkv_channel_mix(
        {k: jnp.asarray(v) for k, v in cm.items()}, cfg, jnp.asarray(x),
        jnp.asarray(prev))
    o, c = rwkv.rwkv_channel_mix(pcm, pcfg, torch.from_numpy(x),
                                 torch.from_numpy(prev))
    _close(o, ro)
    _close(c, rc, 0.0)
    want = ref_rwkv.init_rwkv_cache(cfg, 3, jnp.bfloat16)
    got = rwkv.init_rwkv_cache(pcfg, 3, torch.bfloat16)
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        assert not g.any()
