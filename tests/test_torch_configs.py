"""The five dense and MoE configurations beyond smollm-135m, against the
reference on the CPU.

qwen3-8b (qk-norm), granite-3-2b (tied, vocabulary 49,155), stablelm-12b
(head dim 160), olmoe-1b-7b (64 experts, top 8) and grok-1-314b (8 experts,
top 2): the registry and the configs equal the reference's, every
full-width model on ``meta`` has the reference's leaf shapes and parameter
count, and each smoke model serves like the reference's smoke model with
the same weights (prefill, teacher-forced decode and ``ContinuousBatcher``
through ``tests/test_torch_lm.py``'s checks, at its tolerances: prefill
1e-4, decode 1e-3, caches equal, or for MoE one bf16 unit apart after the
first layer).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as REF_ARCH_NAMES
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke as ref_get_smoke
from repro.models import RunConfig as RefRunConfig
from repro.models import build_model as ref_build_model
from repro.models.sharding import ShardingPlan
from repro_torch import configs
from repro_torch.configs import get_config, get_smoke
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models.transformer import RunConfig
from repro_torch.models.weights import from_reference_params, stacked_shapes
from test_torch_lm import (DECODE_TOL, PREFILL_TOL, _close, check_batcher,
                           check_prefill_and_decode, reference_pair)

NEW_ARCHS = ["qwen3-8b", "granite-3-2b", "stablelm-12b", "olmoe-1b-7b",
             "grok-1-314b"]


def test_registry_holds_every_dense_and_moe_config():
    """Every reference architecture is registered, of every family, with
    the reference's fields; nothing waits to be ported."""
    assert set(configs.ARCH_NAMES) == set(NEW_ARCHS) | {"smollm-135m"} | {
        "rwkv6-1.6b", "zamba2-2.7b", "whisper-base", "llama-3.2-vision-90b"}
    assert set(configs.ARCH_NAMES) == set(REF_ARCH_NAMES)
    for name in configs.ARCH_NAMES:
        for getter, ref_getter in ((get_config, ref_get_config),
                                   (get_smoke, ref_get_smoke)):
            port, ref = getter(name), ref_getter(name)
            for field in port.__dataclass_fields__:
                assert getattr(port, field) == getattr(ref, field), \
                    (name, field)
            assert port.padded_vocab == ref.padded_vocab
            assert port.param_count() == ref.param_count()
    assert get_config("granite-3-2b").padded_vocab == 49408
    assert configs.NOT_PORTED == {}


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_full_width_on_meta_matches_reference_shapes(arch):
    """The published widths, allocated nowhere: every reference leaf of
    ``jax.eval_shape`` of its ``init_model`` has the port's shape, and the
    count is the reference's ``param_count`` plus the final norm."""
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    model = build_model(cfg, device="meta")
    vals, _ = ref_build_model(ref_cfg, param_dtype=jnp.float32
                              ).abstract_params()
    leaves = jax.tree_util.tree_flatten_with_path(vals)[0]
    ref_shapes = {tuple(k.key for k in path): tuple(leaf.shape)
                  for path, leaf in leaves}
    assert stacked_shapes(model) == ref_shapes
    n = sum(p.numel() for p in model.parameters())
    assert n == ref_cfg.param_count() + cfg.d_model
    if cfg.num_experts:
        assert ("blocks", "moe", "router") in ref_shapes
        assert all(b.moe.router.dtype == torch.float32 for b in
                   build_model(cfg, device="meta",
                               dtype=torch.bfloat16).blocks)


@pytest.fixture(scope="module", params=NEW_ARCHS)
def new_pair(request):
    return reference_pair(request.param)


def test_smoke_prefill_and_decode_match_reference(new_pair):
    check_prefill_and_decode(*new_pair)


def test_smoke_batcher_serves_like_reference(new_pair):
    check_batcher(*new_pair)


def test_moe_run_config_reaches_prefill_and_decode():
    """An MoE model's ``RunConfig`` drives its serving entry points: the
    einsum dispatch at capacity 0.25 over chunks of 128 tokens (a
    200-token prompt, so the last chunk is padded and assignments drop)
    gives the reference's logits under the same ``RunConfig``, and not the
    default's; decode reads ``moe_impl`` too."""
    fields = dict(moe_impl="einsum", moe_capacity=0.25, moe_token_chunk=128)
    jmodel = ref_build_model(ref_get_smoke("olmoe-1b-7b"),
                             plan=ShardingPlan.null(),
                             rc=RefRunConfig(attn_impl="pallas", **fields),
                             param_dtype=jnp.float32)
    params, _ = jmodel.init(jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, params)

    def port(**rc):
        return from_reference_params(get_smoke("olmoe-1b-7b"), tree,
                                     device="cpu", rc=RunConfig(**rc))

    model = port(**fields)
    prompt = torch.from_numpy(np.random.default_rng(2).integers(
        2, 512, (1, 200)).astype(np.int32)).long()
    want, jcaches = jmodel.prefill(params, {"tokens": jnp.asarray(prompt)},
                                   cache_len=208)
    got, caches = model.prefill(prompt, cache_len=208)
    _close(got.numpy(), want, PREFILL_TOL)
    other, _ = port().prefill(prompt, cache_len=208)
    assert not torch.allclose(other, got, rtol=0, atol=PREFILL_TOL)
    tok = np.array([7], np.int32)
    want, _ = jmodel.decode_step(params, jnp.asarray(tok), jcaches,
                                 jnp.int32(200))
    got, _ = model.decode_step(torch.from_numpy(tok).long(), caches, 200)
    _close(got.numpy(), want, DECODE_TOL)
    with pytest.raises(ValueError, match="not one of"):
        port(moe_impl="gather").decode_step(torch.from_numpy(tok).long(),
                                            caches, 200)


def test_run_config_moe_fields_belong_to_the_moe_family():
    moe_fields = (dict(moe_impl="einsum"), dict(moe_impl="ep_local"),
                  dict(moe_capacity=2.0), dict(moe_token_chunk=16))
    for fields in moe_fields:
        RunConfig(**fields).check("moe")
        with pytest.raises(ValueError, match="not read by the dense"):
            RunConfig(**fields).check("dense")
    for fields in (dict(rwkv_impl="scan"), dict(ssd_chunk=16)):
        for family in ("dense", "moe"):
            with pytest.raises(ValueError, match=f"not read by the {family}"):
                RunConfig(**fields).check(family)
    # A mesh is read by every family (each shards, ROADMAP 18d-2); the
    # VLM builds its blocks on a model axis of two ranks.
    from test_torch_sharding_families import check_meta_build_on_mesh
    for family in ("dense", "moe"):
        RunConfig(mesh=object()).check(family)
    for family in ("ssm", "hybrid", "encdec", "vlm"):
        RunConfig().check(family)
        with pytest.raises(ValueError, match=f"not read by the {family}"):
            RunConfig(moe_impl="einsum").check(family)
        RunConfig(mesh=object()).check(family)
    check_meta_build_on_mesh("llama-3.2-vision-90b", "model")
    build_model(get_smoke("olmoe-1b-7b"), device="meta",
                rc=RunConfig(moe_impl="einsum"))
    with pytest.raises(ValueError, match="not read by the dense"):
        build_model(get_smoke("qwen3-8b"), device="meta",
                    rc=RunConfig(moe_capacity=2.0))
    for family in ("ssm", "hybrid", "encdec", "vlm"):
        cfg = dataclasses.replace(get_smoke("olmoe-1b-7b"), family=family)
        ref = dataclasses.replace(ref_get_smoke("olmoe-1b-7b"), family=family)
        assert cfg.param_count() == ref.param_count()
    with pytest.raises(ValueError, match="unknown model family"):
        dataclasses.replace(get_smoke("olmoe-1b-7b"),
                            family="diffusion").param_count()


def test_serve_launcher_takes_every_arch(capsys):
    """``--arch`` takes every registered architecture; smoke MoE, RWKV and
    hybrid models serve every request on the CPU, with the reference
    launcher's run settings where the family reads them; whisper and the
    VLM are refused before anything is built, with the reason the
    reference's launcher fails on them (their prefill reads stub
    embeddings the batcher does not carry); without ``--device`` on a
    machine with no CUDA the launcher raises rather than run on the CPU."""
    for arch in ("olmoe-1b-7b", "granite-3-2b", "rwkv6-1.6b", "zamba2-2.7b"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu",
                    "--requests", "5"])
        assert capsys.readouterr().out.startswith("served 5 requests")
    assert serve.run_config(get_smoke("rwkv6-1.6b")) == RunConfig(
        rwkv_impl="scan")
    assert serve.run_config(get_smoke("zamba2-2.7b")) == RunConfig(
        ssd_chunk=16)
    assert serve.run_config(get_smoke("qwen3-8b")) == RunConfig()
    for arch, key in (("whisper-base", "audio_embeds"),
                      ("llama-3.2-vision-90b", "image_embeds")):
        with pytest.raises(ValueError, match=f"KeyError: '{key}'"):
            serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit):
        serve.main(["--arch", "no-such-arch", "--smoke", "--device", "cpu"])
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "olmoe-1b-7b", "--smoke"])
