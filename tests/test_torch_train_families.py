"""Training the four other families against the reference, on the CPU:
rwkv6-1.6b (ssm, both evaluators), zamba2-2.7b (hybrid, ``ssd_chunk``
16), whisper-base (encdec) and llama-3.2-vision-90b (vlm).

Same inputs on both sides: the reference's ``init`` (``jax.random``, f32
weights) with the leaves that start at constants moved off them (the
cross-attention ``gate``, RWKV's ``u`` and ``w0``, Mamba's ``A_log`` and
``dt_bias``), carried into the port (``from_reference_params``), and
batches drawn with numpy from a seed, stub embeddings included (the
launchers feed zeros; drawn ones reach the cross paths). The run
configuration is each launcher's at smoke size (``launch.train.
run_config``: naive attention, ``rwkv_impl`` "scan", ``ssd_chunk`` 16),
plus the ``chunked`` attention that full-size training runs (cross and
non-causal under grad) and ``rwkv_chunked``.

Tolerances, with their reasons (those of ``tests/test_torch_train.py``,
whose smollm cases they extend to every family):

* loss 1e-5 relative and every gradient within 1e-4 of its leaf's
  gradient norm: f32 sums in another order through a few layers, the
  recurrences (scan, chunked RWKV, chunked SSD) included;
* two ``make_train_step`` steps, each from the reference's state: loss
  1e-5 and ``grad_norm`` 1e-4 relative, ``lr`` exactly; params and
  moments within 1e-4 of each leaf's largest value on all but 1e-3 of the
  elements and every element within what one flipped rounding can move it
  (Adam's first update is the sign of a gradient: up to 2 lr);
* the training launchers' losses 1e-4 relative over 3 steps resumed from
  the reference's checkpoint (the reference test's bound for smollm);
* a fail-and-resume run, checkpoints across the packages: bit for bit.
"""

import dataclasses
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as ref_get_smoke
from repro.launch import train as ref_train
from repro.models import RunConfig as RefRunConfig
from repro.models import build_model as ref_build_model
from repro.models.sharding import ShardingPlan
from repro.train import checkpoint as ref_ckpt
from repro.train import optimizer as ref_opt
from repro.train import train_step as ref_step
from repro_torch.configs import get_smoke
from repro_torch.launch import train as port_train
from repro_torch.models import build_model, weights
from repro_torch.train import checkpoint, optimizer
from repro_torch.train import train_step as port_step
from repro_torch.train.fault import SimulatedFailure

FAMILY_ARCHS = ["rwkv6-1.6b", "zamba2-2.7b", "whisper-base",
                "llama-3.2-vision-90b"]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-4
LAUNCH_TOL = 1e-4
B, S = 2, 24
# Loss-and-gradient cases: (arch, RunConfig fields over the launcher's).
CASES = {
    "rwkv6_scan": ("rwkv6-1.6b", {}),
    "rwkv6_chunked": ("rwkv6-1.6b", {"rwkv_impl": "chunked"}),
    "zamba2": ("zamba2-2.7b", {}),
    "whisper": ("whisper-base", {}),
    "whisper_chunked": ("whisper-base", {"attn_impl": "chunked"}),
    "vlm": ("llama-3.2-vision-90b", {}),
    "vlm_chunked": ("llama-3.2-vision-90b", {"attn_impl": "chunked"}),
}
# The reference launcher's settings (src/repro/launch/train.py), at
# smoke size.
REF_LAUNCH_RC = dict(attn_impl="naive", ssd_chunk=16, rwkv_impl="scan")


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


def _ref_rc(fields):
    return RefRunConfig(**{**REF_LAUNCH_RC, "loss_chunk": min(256, S),
                           **fields})


def _port_rc(arch, fields):
    rc = port_train.run_config(get_smoke(arch), True, S)
    return dataclasses.replace(rc, **fields)


@functools.lru_cache(maxsize=None)
def _ref_tree(arch, perturb=True):
    """The reference smoke params of ``arch`` as numpy, constants moved
    off their init where ``perturb``."""
    jmodel = ref_build_model(ref_get_smoke(arch), plan=ShardingPlan.null(),
                             rc=_ref_rc({}), param_dtype=jnp.float32)
    params, _ = jmodel.init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.array, params)
    return _perturb(tree, np.random.default_rng(3)) if perturb else tree


def _pair(arch, fields, perturb=True):
    """(reference model, its params, a fresh port model with them)."""
    tree = _ref_tree(arch, perturb)
    jmodel = ref_build_model(ref_get_smoke(arch), plan=ShardingPlan.null(),
                             rc=_ref_rc(fields), param_dtype=jnp.float32)
    model = weights.from_reference_params(get_smoke(arch), tree,
                                          device="cpu",
                                          rc=_port_rc(arch, fields))
    return jmodel, jax.tree.map(jnp.asarray, tree), model


def _batch(cfg, seed):
    """Tokens, labels (a tenth ignored) and the family's stub input,
    drawn from ``seed``: (reference batch, port batch)."""
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
              "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    arrays = {k: v.astype(np.int32) for k, v in arrays.items()}
    arrays["labels"][rng.random((B, S)) < 0.1] = -1
    for fam, key, n in (("encdec", "audio_embeds", cfg.encoder_seq),
                        ("vlm", "image_embeds", cfg.num_image_tokens)):
        if cfg.family == fam:
            arrays[key] = rng.standard_normal((B, n, cfg.d_model)).astype(
                np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _ref_flat(state):
    keys, vals, _ = ref_ckpt._flatten_with_paths(jax.tree.map(np.asarray,
                                                              state))
    return dict(zip(keys, vals))


def _loss_and_grads(model, batch):
    named = dict(model.named_parameters())
    for p in named.values():
        p.requires_grad_(True)
    loss = model.loss(batch)
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    return loss, weights.stacked_arrays(".params", grads)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_every_gradient_match_reference(case):
    arch, fields = CASES[case]
    jmodel, params, model = _pair(arch, fields)
    jbatch, batch = _batch(model.cfg, seed=11)
    want, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(params, jbatch)
    got, grads = _loss_and_grads(model, batch)
    assert abs(got.item() - float(want)) <= LOSS_TOL * abs(float(want))
    jflat = _ref_flat(jgrads)
    assert {".params/" + k for k in jflat} == set(grads)
    for key, jg in jflat.items():
        g = grads[".params/" + key]
        assert np.isfinite(g).all(), key
        assert np.abs(g - jg).max() <= GRAD_TOL * max(
            np.linalg.norm(jg), 1e-6), key


def test_vlm_gate_at_zero_takes_its_gradient():
    """The cross layers' ``tanh(gate)`` at its init, zero: the output of
    each cross path is zero, yet the gate's gradient (tanh'(0) = 1) is the
    reference's and not zero; the cross-attention weights' are zero."""
    arch = "llama-3.2-vision-90b"
    jmodel, params, model = _pair(arch, {}, perturb=False)
    jbatch, batch = _batch(model.cfg, seed=12)
    want, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(params, jbatch)
    got, grads = _loss_and_grads(model, batch)
    assert abs(got.item() - float(want)) <= LOSS_TOL * abs(float(want))
    key = ".params/['cross_layers']/['xattn']/['gate']"
    jg = np.asarray(jgrads["cross_layers"]["xattn"]["gate"])
    assert np.abs(grads[key]).min() > 0
    assert np.abs(grads[key] - jg).max() <= GRAD_TOL * np.linalg.norm(jg)
    assert not grads[".params/['cross_layers']/['xattn']/['wq']"].any()


def _carry(state, jstate):
    step = weights.load_train_state_arrays(
        _ref_flat(jstate), state.params, state.opt.mu, state.opt.nu,
        state.err)
    return state._replace(opt=state.opt._replace(step=step))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_two_train_steps_match_reference(arch):
    """Two steps of each package's ``make_train_step``, each from the
    reference's state carried into the port."""
    jmodel, params, model = _pair(arch, {})
    oc = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    joc, poc = ref_opt.OptConfig(**oc), optimizer.OptConfig(**oc)
    jstate = ref_step.TrainState(params=params,
                                 opt=ref_opt.opt_init(params, joc), err=None)
    jfn = jax.jit(ref_step.make_train_step(jmodel, joc))
    state = port_step.init_train_state(model, poc)
    fn = port_step.make_train_step(model, poc)
    for i in range(2):
        state = _carry(state, jstate)
        jbatch, batch = _batch(model.cfg, seed=20 + i)
        jstate, jm = jfn(jstate, jbatch)
        state, m = fn(state, batch)
        assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_TOL * abs(
            float(jm["loss"])), i
        assert abs(float(m["grad_norm"]) - float(jm["grad_norm"])) <= \
            STEP_TOL * float(jm["grad_norm"]), i
        assert float(m["lr"]) == float(jm["lr"])
        lr = float(jm["lr"])
        got, want = checkpoint._arrays(state), _ref_flat(jstate)
        assert got.keys() == want.keys()
        for key, w in want.items():
            if key == weights.STEP_KEY:
                assert int(got[key]) == int(w) == i + 1
                continue
            scale = max(1e-3, float(np.abs(w).max()))
            bound = (2.0 * lr * 1.001 if key.startswith(".params")
                     else scale * STEP_TOL)
            diff = np.abs(got[key] - w)
            assert diff.max() <= bound + 1e-6 * scale, key
            assert (diff > STEP_TOL * scale).mean() <= 1e-3, key


LAUNCH = dict(smoke=True, seq_len=16, global_batch=2, ckpt_every=3, seed=0,
              log_every=100, dedup=False)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_launcher_matches_reference_and_checkpoints_cross(arch, tmp_path):
    """The reference's launcher trains 6 steps, checkpointing at 3; the
    port's resumes from its step-3 checkpoint (the reference's weights,
    moments and step) and continues its losses; the port's step-6
    checkpoint restores in the reference bit for bit."""
    want = ref_train.run(arch, steps=6, ckpt_dir=str(tmp_path / "ref"),
                         resume=False, fail_at=None, **LAUNCH)
    shutil.copytree(tmp_path / "ref" / "step_00000003",
                    tmp_path / "port" / "step_00000003")
    got = port_train.run(arch, steps=6, ckpt_dir=str(tmp_path / "port"),
                         resume=True, fail_at=None, device="cpu", **LAUNCH)
    np.testing.assert_allclose(got["losses"], want["losses"][3:],
                               rtol=LAUNCH_TOL, atol=0)
    jmodel = ref_build_model(ref_get_smoke(arch), plan=ShardingPlan.null(),
                             rc=_ref_rc({}), param_dtype=jnp.float32)
    template = ref_step.init_train_state(jmodel, jax.random.PRNGKey(1),
                                         ref_opt.OptConfig())
    back, manifest = ref_ckpt.restore_checkpoint(tmp_path / "port",
                                                 template)
    assert manifest["step"] == 6
    with np.load(tmp_path / "port" / "step_00000006" / "arrays.npz") as f:
        for key, value in _ref_flat(back).items():
            np.testing.assert_array_equal(value, f[key])


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_launcher_fail_and_resume_is_bitwise(arch, tmp_path):
    common = dict(LAUNCH, steps=6, device="cpu")
    whole = port_train.run(arch, ckpt_dir=None, resume=False, fail_at=None,
                           **common)
    with pytest.raises(SimulatedFailure):
        port_train.run(arch, ckpt_dir=str(tmp_path), resume=False,
                       fail_at=3, **common)
    out = port_train.run(arch, ckpt_dir=str(tmp_path), resume=True,
                         fail_at=None, **common)
    assert out["losses"] == whole["losses"][3:]
    assert np.isfinite(whole["losses"]).all()


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_reference_checkpoint_restores_in_the_port_and_back(arch, tmp_path):
    """Grouped stacks (``mamba_groups``, ``self_groups``: index (g, j)),
    cross layers and the encoder, both ways, bit for bit."""
    jmodel = ref_build_model(ref_get_smoke(arch), plan=ShardingPlan.null(),
                             rc=_ref_rc({}), param_dtype=jnp.float32)
    jstate = ref_step.init_train_state(jmodel, jax.random.PRNGKey(5),
                                       ref_opt.OptConfig(),
                                       ref_step.StepConfig(
                                           compress_cross_pod=True))
    jstate = jstate._replace(
        params=jax.tree.map(jnp.asarray, _ref_tree(arch)),
        opt=jstate.opt._replace(mu=jax.tree.map(lambda p: p * 0.5,
                                                jstate.params),
                                step=jnp.int32(9)),
        err=jax.tree.map(lambda p: p * 0.25, jstate.params))
    ref_ckpt.save_checkpoint(tmp_path / "ref", 9, jstate)
    model = build_model(get_smoke(arch), device="cpu",
                        rc=_port_rc(arch, {}))
    state = port_step.init_train_state(
        model, optimizer.OptConfig(),
        port_step.StepConfig(compress_cross_pod=True))
    restored, manifest = checkpoint.restore_checkpoint(tmp_path / "ref",
                                                       state)
    assert manifest["step"] == 9 and restored.opt.step == 9
    got = checkpoint._arrays(restored)
    want = _ref_flat(jstate)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)
    checkpoint.save_checkpoint(tmp_path / "port", 9, restored)
    back, _ = ref_ckpt.restore_checkpoint(tmp_path / "port", jstate)
    for k, v in _ref_flat(back).items():
        np.testing.assert_array_equal(v, want[k])


@pytest.mark.parametrize("arch", FAMILY_ARCHS + ["smollm-135m",
                                                 "olmoe-1b-7b"])
def test_launcher_run_config_is_the_references(arch):
    """The port's training launcher builds the reference launcher's
    ``RunConfig``, each field only for the family that reads it; for
    zamba2 (``ssd_chunk`` 16, not the default 64) the loss of a smoke batch
    is the reference's at the same weights."""
    cfg = get_smoke(arch)
    for smoke, seq in ((True, 16), (False, 1024)):
        rc = port_train.run_config(cfg, smoke, seq)
        want = dict(attn_impl="naive" if smoke else "chunked",
                    loss_chunk=min(256, seq), ssd_chunk=16,
                    rwkv_impl="scan" if smoke else "chunked")
        read = ("attn_impl", "loss_chunk") + rc.FAMILY_FIELDS.get(
            cfg.family, ())
        for field, value in want.items():
            expect = value if field in read else getattr(RefRunConfig(),
                                                         field)
            assert getattr(rc, field) == expect, (arch, smoke, field)
    if arch == "zamba2-2.7b":
        assert port_train.run_config(get_smoke(arch), True, S).ssd_chunk == 16
        jmodel, params, model = _pair(arch, {})
        jbatch, batch = _batch(model.cfg, seed=13)
        want = float(jmodel.loss(params, jbatch))
        with torch.no_grad():
            got = float(model.loss(batch))
        assert abs(got - want) <= LOSS_TOL * abs(want)
