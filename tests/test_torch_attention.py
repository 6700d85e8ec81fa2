"""Kernel B4 and the attention module of the port against the reference.

The port's plain B4 (``repro_torch.kernels.ref.attention_ref``, what the
CUDA kernel must compute) is held against the reference's Pallas kernel in
interpret mode (``repro.kernels.ops.flash_attention``, as
``tests/test_kernels.py`` runs it) and against the reference's oracle, at
that test's shapes. The model-level functions (``rms_norm``,
``apply_rope``, ``attention`` with ``return_kv``, ``decode_attention``) are
held against their ``repro.models`` namesakes on the same numpy inputs,
with weights carried across by ``repro_torch.models.weights``. The CUDA
kernel itself runs only on the card (``tests/test_torch_cuda.py``).

Tolerances: f32 2e-5 and bf16 2e-2 for B4, those of the reference's own
kernel test (``tests/test_kernels.py``): the sums run in another order, and
a bf16 output may round one unit apart. Model functions in f32: 1e-5 (a
few f32 products and sums in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.models import RunConfig
from repro.models import attention as ref_attention
from repro.models import build_model as ref_build_model
from repro.models import common as ref_common
from repro.models.sharding import ShardingPlan
from repro_torch.configs import get_smoke
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import attention, common
from repro_torch.models.weights import from_reference_params

# The reference's kernel test shapes (tests/test_kernels.py).
SHAPES = [
    (1, 4, 4, 128, 128, 64, True, "float32"),
    (2, 4, 2, 128, 128, 64, True, "float32"),     # GQA
    (1, 8, 1, 256, 256, 64, True, "bfloat16"),    # MQA bf16
    (2, 4, 4, 128, 384, 64, True, "float32"),     # kv longer (decode-ish)
    (1, 2, 2, 192, 192, 32, False, "float32"),    # non-causal, ragged
    (1, 9, 3, 130, 130, 64, True, "float32"),     # odd sizes (padding)
    (1, 4, 4, 64, 64, 128, True, "bfloat16"),     # big head dim
]
# Head dims 80 (zamba2-2.7b) and 160 (stablelm-12b), which the reference's
# kernel takes and the CUDA kernel has instances for.
WIDE_SHAPES = [
    (1, 4, 2, 100, 100, 80, True, "float32"),
    (1, 4, 2, 100, 100, 80, True, "bfloat16"),
    (1, 2, 2, 70, 150, 160, True, "float32"),
    (1, 2, 1, 64, 64, 160, False, "bfloat16"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(b, h, kh, sq, sk, d, dtype, seed):
    """q, k, v from numpy, rounded to ``dtype`` once, as both sides see
    them: (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, h, sq, d), (b, kh, sk, d), (b, kh, sk, d))]
    tdt = getattr(torch, dtype)
    ts = [torch.from_numpy(a).to(tdt) for a in arrays]
    js = [jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))
          for t in ts]
    return js, ts


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("b,h,kh,sq,sk,d,causal,dtype", SHAPES + WIDE_SHAPES)
def test_plain_flash_attention_matches_reference(b, h, kh, sq, sk, d,
                                                 causal, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(b, h, kh, sq, sk, d, dtype,
                                   seed=sq + sk + d)
    fa.reset_launch_counts()
    got = fa.flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert fa.launches["flash_attention"] == 0     # CPU: the plain version
    assert torch.equal(got, ref.attention_ref(q, k, v, causal=causal))
    pallas = ref_ops.flash_attention(jq, jk, jv, causal=causal)
    oracle = ref_ref.attention_ref(jq, jk, jv, causal=causal)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=0, atol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), rtol=0, atol=tol)


def test_flash_attention_rejects_what_the_kernel_does_not_take():
    """On the CPU the plain version takes any head dim, as the reference's
    kernel does; only the card refuses a head dim without a kernel
    instance (``tests/test_torch_cuda.py``)."""
    _, (q, k, v) = _qkv(1, 4, 2, 16, 16, 64, "float32", seed=0)
    q48, k48, v48 = (t[..., :48].contiguous() for t in (q, k, v))
    assert 48 not in fa.HEAD_DIMS
    assert torch.equal(fa.flash_attention(q48, k48, v48),
                       ref.attention_ref(q48, k48, v48))
    with pytest.raises(ValueError, match="without a key"):
        fa.flash_attention(q, k[:, :, :8], v[:, :, :8], causal=True)
    with pytest.raises(ValueError, match="no keys"):
        fa.flash_attention(q, k[:, :, :0], v[:, :, :0], causal=False)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="dtype"):
        fa.flash_attention(q, k.to(torch.bfloat16), v)
    # Non-causal with Sk < Sq is fine: every row sees every key.
    out = fa.flash_attention(q, k[:, :, :8], v[:, :, :8], causal=False)
    assert out.shape == q.shape


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: to nearest, ties
    away from zero, keeping 10 of the 23 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm_tf32(a, b):
    return _tf32(a) @ _tf32(b)


def _tf32_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """The top 19 bits of an f32, which a TF32 MMA reads of an operand."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """The kernel's split product: hi = tf32(x) rounded, lo = x - hi read
    by the MMA toward zero, and lo*hi + hi*lo + hi*hi with f32 sums (lo*lo
    dropped)."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32_toward_zero(a - ah), _tf32_toward_zero(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _attention_with(mm, q, k, v):
    """Causal GQA attention whose two products go through ``mm``."""
    group = q.shape[1] // k.shape[1]
    kr = k.repeat_interleave(group, dim=1)
    vr = v.repeat_interleave(group, dim=1)
    s = mm(q * (1.0 / q.shape[-1] ** 0.5), kr.transpose(-1, -2))
    mask = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
    p = torch.softmax(torch.where(mask, s, torch.full_like(s, ref.NEG_INF)),
                      dim=-1)
    return mm(p, vr)


def test_tf32_split_keeps_the_f32_tolerance():
    """The numerical scheme of the f32 tensor-core kernel, emulated on the
    CPU at a serving shape (smollm-135m heads, 1,024 tokens, causal): three
    TF32 products per f32 product stay within the f32 tolerance 2e-5 of
    the plain version, and one TF32 product does not, which is why the
    kernel splits. This tests the scheme, not the CUDA kernel."""
    _, (q, k, v) = _qkv(1, 9, 3, 1024, 1024, 64, "float32", seed=11)
    assert torch.equal(_tf32(torch.tensor([1 + 2**-11, -(1 + 2**-11),
                                           1 + 2**-12])),
                       torch.tensor([1 + 2**-10, -(1 + 2**-10), 1.0]))
    assert torch.equal(_tf32_toward_zero(torch.tensor([1 + 2**-11 + 2**-12,
                                                       -(1 + 2**-10)])),
                       torch.tensor([1.0, -(1 + 2**-10)]))
    want = ref.attention_ref(q, k, v, causal=True)
    err3 = (_attention_with(_mm_3xtf32, q, k, v) - want).abs().max().item()
    err1 = (_attention_with(_mm_tf32, q, k, v) - want).abs().max().item()
    assert err3 < TOL["float32"]
    assert err1 > TOL["float32"]


@pytest.fixture(scope="module", params=[False, True],
                ids=["plain", "qk_norm"])
def smoke_pair(request):
    """The smoke config's reference params (f32), with and without
    qk-norm, and the port model holding the same weights."""
    jcfg = dataclasses.replace(ref_get_smoke("smollm-135m"),
                               qk_norm=request.param)
    jmodel = ref_build_model(jcfg, plan=ShardingPlan.null(),
                             rc=RunConfig(attn_impl="pallas"),
                             param_dtype=jnp.float32)
    params, _ = jmodel.init(jax.random.PRNGKey(3))
    params_np = jax.tree.map(np.asarray, params)
    cfg = dataclasses.replace(get_smoke("smollm-135m"), qk_norm=request.param)
    model = from_reference_params(cfg, params_np, device="cpu")
    return jcfg, params, model


def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = np.arange(7, dtype=np.int32)
    np.testing.assert_allclose(
        common.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)).numpy(),
        np.asarray(ref_common.rms_norm(jnp.asarray(x), jnp.asarray(scale))),
        rtol=0, atol=1e-5)
    np.testing.assert_array_equal(common.rope_frequencies(16, 1e4),
                                  ref_common.rope_frequencies(16, 1e4))
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              theta).numpy(),
            np.asarray(ref_common.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                             theta)),
            rtol=0, atol=1e-5)


def test_attention_with_kv_matches_reference(smoke_pair):
    jcfg, params, model = smoke_pair
    cfg = model.cfg
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    pos = np.arange(24, dtype=np.int32)
    p0 = jax.tree.map(lambda a: a[0], params["blocks"]["attn"])
    want = ref_attention.attention(p0, jcfg, ShardingPlan.null(),
                                   jnp.asarray(x), jnp.asarray(pos),
                                   impl="pallas", return_kv=True)
    got = attention.attention(model.blocks[0].attn, cfg, torch.from_numpy(x),
                              torch.from_numpy(pos), impl="pallas",
                              return_kv=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)


def test_decode_attention_matches_reference(smoke_pair):
    """One decode step at position 9 of a 16-slot bf16 cache whose first 9
    positions are filled: same output, same cache written in place."""
    jcfg, params, model = smoke_pair
    cfg = model.cfg
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    shape = (2, 16, cfg.num_kv_heads, cfg.head_dim)
    ck = np.zeros(shape, np.float32)
    cv = np.zeros(shape, np.float32)
    ck[:, :9] = rng.standard_normal((2, 9) + shape[2:])
    cv[:, :9] = rng.standard_normal((2, 9) + shape[2:])
    tk = torch.from_numpy(ck).to(torch.bfloat16)
    tv = torch.from_numpy(cv).to(torch.bfloat16)
    jk = jnp.asarray(tk.float().numpy()).astype(jnp.bfloat16)
    jv = jnp.asarray(tv.float().numpy()).astype(jnp.bfloat16)
    p0 = jax.tree.map(lambda a: a[0], params["blocks"]["attn"])
    want = ref_attention.decode_attention(p0, jcfg, ShardingPlan.null(),
                                          jnp.asarray(x), jnp.int32(9),
                                          jk, jv)
    got = attention.decode_attention(model.blocks[0].attn, cfg,
                                     torch.from_numpy(x), 9, tk, tv)
    assert got.k is tk and got.v is tv                 # updated in place
    np.testing.assert_allclose(got.out.numpy(), np.asarray(want.out),
                               rtol=0, atol=1e-5)
    for g, w in ((tk, want.k), (tv, want.v)):
        np.testing.assert_array_equal(g.float().numpy(), _np(w))
