"""The four other model families against the reference on the CPU:
rwkv6-1.6b (ssm), zamba2-2.7b (hybrid), whisper-base (encdec) and
llama-3.2-vision-90b (vlm).

Each smoke model is the reference's ``init`` (``jax.random``, f32
weights) with the leaves that start at constants moved off them in the
reference's tree before converting (the cross-attention ``gate``, RWKV's
``u`` and ``w0``, Mamba's ``A_log`` and ``dt_bias``), so the cross path,
the bonus term and the decays are all seen; the port holds the same
weights (``from_reference_params``). The reference runs with
``RunConfig(attn_impl="pallas")`` (its Pallas kernel in interpret mode,
its oracle for ragged non-causal shapes); the port's prefill runs its
plain B4 on the CPU. Stub embeddings are drawn from the seed, not zeros.

Tolerances, with their reasons:

* forward hidden states, encoder output and prefill logits 1e-4: a few
  f32 layers of the smoke model, every sum in another order, on values of
  order 1;
* with f32 caches, every cache leaf after prefill and after 4 decode
  steps, and every decode step's logits, 1e-4: the same f32 arithmetic,
  nothing rounded to bf16;
* with the served bf16 caches, every bf16 leaf after prefill within one
  bf16 unit (``2⁻⁷·|x|``, plus 1e-6 where the f32 originals straddle
  zero), the f32 leaves (wkv and SSD states) 1e-4, and 4 decode steps'
  logits 1e-2: decode reads bf16 carries (keys and values, Mamba conv
  states, RWKV token shifts) which each package rounds from f32 values
  summed in another order, so one of them can land on the other side of a
  bf16 unit (relative 2⁻⁸) and, through the recurrence, move later logits
  of order 3 by ~1e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke as ref_get_smoke
from repro.models import RunConfig as RefRunConfig
from repro.models import build_model as ref_build_model
from repro.models.sharding import ShardingPlan
from repro.models.transformer import encode as ref_encode
from repro_torch.configs import ARCH_NAMES, get_config, get_smoke
from repro_torch.models import build_model
from repro_torch.models.transformer import RunConfig, encode
from repro_torch.models.weights import (from_numpy, from_reference_params,
                                        stacked_shapes)

FAMILY_ARCHS = ["rwkv6-1.6b", "zamba2-2.7b", "whisper-base",
                "llama-3.2-vision-90b"]
TOL = 1e-4
BF16_DECODE_TOL = 1e-2
PROMPT, CACHE_LEN, STEPS = 11, 16, 4


def _perturb(tree, rng):
    """Move the leaves that start at constants off them, in place."""
    for key, value in tree.items():
        if isinstance(value, dict):
            _perturb(value, rng)
        elif key == "gate":
            tree[key] = rng.uniform(0.3, 1.2, value.shape).astype(value.dtype)
        elif key == "u":
            tree[key] = (0.5 * rng.standard_normal(value.shape)).astype(
                value.dtype)
        elif key == "w0":
            tree[key] = rng.uniform(-3.0, -0.5, value.shape).astype(
                value.dtype)
        elif key in ("A_log", "dt_bias"):
            tree[key] = rng.uniform(-1.0, 1.0, value.shape).astype(
                value.dtype)
    return tree


@pytest.fixture(scope="module", params=FAMILY_ARCHS)
def family(request):
    """(reference model, its params, port model, prompt, reference batch,
    port stub inputs) for one family's smoke config."""
    arch = request.param
    jcfg = ref_get_smoke(arch)
    jmodel = ref_build_model(jcfg, plan=ShardingPlan.null(),
                             rc=RefRunConfig(attn_impl="pallas"),
                             param_dtype=jnp.float32)
    params, _ = jmodel.init(jax.random.PRNGKey(0))
    tree = _perturb(jax.tree.map(np.array, params),
                    np.random.default_rng(3))
    model = from_reference_params(get_smoke(arch), tree, device="cpu")
    rng = np.random.default_rng(0)
    prompt = rng.integers(2, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    batch, stubs = {"tokens": jnp.asarray(prompt)}, {}
    for fam, key, n in (("encdec", "audio_embeds", jcfg.encoder_seq),
                        ("vlm", "image_embeds", jcfg.num_image_tokens)):
        if jcfg.family == fam:
            emb = rng.standard_normal((2, n, jcfg.d_model)).astype(np.float32)
            batch[key], stubs[key] = jnp.asarray(emb), torch.from_numpy(emb)
    return (jmodel, jax.tree.map(jnp.asarray, tree), model,
            torch.from_numpy(prompt).long(), batch, stubs)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               rtol=0, atol=tol)


def _host(a) -> torch.Tensor:
    return from_numpy(np.asarray(a), torch.float32)


def _caches_match(caches, jcaches, tol=TOL):
    """Every leaf of the reference's caches in the port's, with its shape
    and dtype: f32 leaves within ``tol``, bf16 leaves within one unit."""
    assert set(caches) == set(jcaches)
    for name, want in jcaches.items():
        got = caches[name]
        assert tuple(got.shape) == tuple(want.shape), name
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype), name
        want = _host(want)
        if got.dtype == torch.bfloat16:
            unit = 2.0 ** -7 * torch.maximum(got.float().abs(), want.abs())
            assert ((got.float() - want).abs() <= unit + 1e-6).all(), name
        else:
            _close(got.numpy(), want.numpy(), tol)


def test_forward_and_encode_match_reference(family):
    jmodel, params, model, prompt, batch, stubs = family
    _close(model(prompt, **stubs).numpy(), jmodel.forward(params, batch))
    if model.cfg.family == "encdec":
        want = ref_encode(params, jmodel.cfg, jmodel.plan, jmodel.rc, batch)
        for impl in ("naive", "pallas"):
            got = encode(model, model.cfg, RunConfig(attn_impl=impl),
                         stubs["audio_embeds"])
            _close(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(family, dtype):
    """Prefill logits and every cache leaf, then 4 decode steps with
    their logits, at the cache dtype."""
    jmodel, params, model, prompt, batch, stubs = family
    jdt, dt = getattr(jnp, dtype), getattr(torch, dtype)
    want, jcaches = jmodel.prefill(params, batch, cache_len=CACHE_LEN,
                                   cache_dtype=jdt)
    got, caches = model.prefill(prompt, cache_len=CACHE_LEN, cache_dtype=dt,
                                **stubs)
    assert got.dtype == torch.float32 and got.shape == (
        2, model.cfg.padded_vocab)
    _close(got.numpy(), want)
    _caches_match(caches, jcaches)
    rng = np.random.default_rng(1)
    for step in range(STEPS):
        tok = rng.integers(2, model.cfg.vocab_size, (2,)).astype(np.int32)
        want, jcaches = jmodel.decode_step(params, jnp.asarray(tok), jcaches,
                                           jnp.int32(PROMPT + step))
        got, caches = model.decode_step(torch.from_numpy(tok).long(), caches,
                                        PROMPT + step)
        _close(got.numpy(), want, TOL if dtype == "float32"
               else BF16_DECODE_TOL)
    if dtype == "float32":
        _caches_match(caches, jcaches)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_full_width_on_meta_matches_reference_shapes(arch):
    """The published widths, allocated nowhere: every reference leaf of
    ``jax.eval_shape`` of its ``init_model`` has the port's shape (grouped
    stacks with both leading axes), and the count is the leaves' sum."""
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    model = build_model(cfg, device="meta")
    vals, _ = ref_build_model(ref_cfg, param_dtype=jnp.float32
                              ).abstract_params()
    leaves = jax.tree_util.tree_flatten_with_path(vals)[0]
    ref_shapes = {tuple(k.key for k in path): tuple(leaf.shape)
                  for path, leaf in leaves}
    assert stacked_shapes(model) == ref_shapes
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s)) for s in ref_shapes.values())
    dtypes = {name: p.dtype for name, p in build_model(
        cfg, device="meta", dtype=torch.bfloat16).named_parameters()}
    f32 = {n for n, d in dtypes.items() if d == torch.float32}
    assert f32 == {n for n in dtypes if n.rsplit(".", 1)[-1] in (
        "w0", "w_a", "w_b", "u", "A_log", "D", "dt_bias")}


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_count_is_the_reference_formula(arch):
    """``param_count`` equals the reference's at ``config()`` and
    ``smoke()``, with its analytic mismatches (the ssm, hybrid, encdec
    and vlm branches do not count the tree's leaves, ROADMAP §C)."""
    for getter, ref_getter in ((get_config, ref_get_config),
                               (get_smoke, ref_get_smoke)):
        cfg, ref = getter(arch), ref_getter(arch)
        assert cfg.param_count() == ref.param_count()
        assert (cfg.attention_free, cfg.subquadratic) == (
            ref.attention_free, ref.subquadratic)
    held = sum(p.numel() for p in build_model(get_smoke(arch),
                                              device="meta").parameters())
    extra = held - get_smoke(arch).param_count()
    want = {"rwkv6-1.6b": 9024, "zamba2-2.7b": 384, "whisper-base": 130,
            "llama-3.2-vision-90b": -24768}
    assert extra == want.get(arch, get_smoke(arch).d_model), arch


def test_stub_inputs_are_required_by_name():
    for arch, key in (("whisper-base", "audio_embeds"),
                      ("llama-3.2-vision-90b", "image_embeds")):
        model = build_model(get_smoke(arch), device="cpu")
        tokens = torch.zeros((1, 4), dtype=torch.long)
        for call in (lambda: model(tokens),
                     lambda: model.prefill(tokens, cache_len=8),
                     lambda: model.loss({"tokens": tokens,
                                         "labels": tokens})):
            with pytest.raises(ValueError, match=key):
                call()


def test_vlm_gate_at_init_adds_nothing():
    """A fresh VLM's cross layers start with ``tanh(0) = 0``: the image
    embeddings cannot move its logits until the gate moves."""
    cfg = get_smoke("llama-3.2-vision-90b")
    model = build_model(cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        2, cfg.vocab_size, (1, 7))).long()
    images = [torch.randn(1, cfg.num_image_tokens, cfg.d_model,
                          generator=torch.Generator().manual_seed(s))
              for s in (0, 1)]
    a, b = (model.prefill(tokens, image_embeds=img)[0] for img in images)
    assert torch.equal(a, b)
    with torch.no_grad():
        for layer in model.cross_layers:
            layer.xattn.gate.fill_(0.5)
    c = model.prefill(tokens, image_embeds=images[0])[0]
    assert not torch.equal(a, c)


def test_run_config_fields_by_family():
    """``rwkv_impl`` is read by ssm only, ``ssd_chunk`` by hybrid only,
    and the prefill honours them as the reference does."""
    RunConfig(rwkv_impl="scan").check("ssm")
    RunConfig(ssd_chunk=16).check("hybrid")
    for fam in ("dense", "moe", "hybrid", "encdec", "vlm"):
        with pytest.raises(ValueError, match="rwkv_impl the ssm"):
            RunConfig(rwkv_impl="scan").check(fam)
    for fam in ("dense", "moe", "ssm", "encdec", "vlm"):
        with pytest.raises(ValueError, match="ssd_chunk the hybrid"):
            RunConfig(ssd_chunk=16).check(fam)
    # Every family runs on a mesh (ROADMAP 18d-2): the ssm family takes
    # one in its RunConfig and builds its blocks on it.
    from test_torch_sharding_families import check_meta_build_on_mesh
    RunConfig(mesh=object()).check("ssm")
    check_meta_build_on_mesh("rwkv6-1.6b", "model")
    cfg = get_smoke("rwkv6-1.6b")
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        2, cfg.vocab_size, (1, 21))).long()
    base = build_model(cfg, device="cpu")
    scan = build_model(cfg, device="cpu", rc=RunConfig(rwkv_impl="scan"))
    scan.load_state_dict(base.state_dict())
    (lc, cc), (ls, cs) = base.prefill(tokens), scan.prefill(tokens)
    _close(ls.numpy(), lc.numpy())
    _close(cs["state"].numpy(), cc["state"].numpy())
    zcfg = get_smoke("zamba2-2.7b")
    z64 = build_model(zcfg, device="cpu")
    z16 = build_model(zcfg, device="cpu", rc=RunConfig(ssd_chunk=16))
    z16.load_state_dict(z64.state_dict())
    long = torch.from_numpy(np.random.default_rng(5).integers(
        2, zcfg.vocab_size, (1, 37))).long()
    _close(z16.prefill(long)[0].numpy(), z64.prefill(long)[0].numpy())
    assert dataclasses.asdict(RunConfig()) == dataclasses.asdict(
        RefRunConfig())
