"""The port's launchers, checkpoints and examples against the
reference, on the CPU.

The training launcher: a reference checkpoint resumed by the port continues
the reference's loss trajectory within 1e-4 relative (f32 sums in another
order over five AdamW steps); the port's own fail-and-resume run equals
its uninterrupted run bit for bit; the dedup pipeline's batches are equal.
Checkpoints: the keys are the reference's (derived from its
``_flatten_with_paths``), arrays round trip exactly in both directions, a
tampered array raises. Also B4's gradient guard on the CPU and
``RunConfig``'s fields.

The reference's dry run sets ``XLA_FLAGS`` (512 host devices) when it is
imported, so it runs in a subprocess of its own. Round counts, phases,
edge counts, the degree cap and both per-round byte counts must be equal:
the ranks are the reference's bit for bit and the bytes are counted from
the same all-reduce sizes the reference's HLO carries.

Each example runs with ``--device cpu``; where its reference counterpart
prints the same lines from the same integer results (quickstart, forests,
dedup), the lines must be equal.
"""

import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

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
from repro_torch.core import executor
from repro_torch.examples import (batch_serving, dedup_pipeline,
                                  forest_clustering, quickstart,
                                  serve_decode, train_smollm)
from repro_torch.kernels import measure
from repro_torch.launch import cluster_dryrun
from repro_torch.launch import train as port_train
from repro_torch.models import build_model, weights
from repro_torch.models.transformer import RunConfig
from repro_torch.train import checkpoint, optimizer
from repro_torch.train import train_step as port_step
from repro_torch.train.fault import SimulatedFailure

ROOT = Path(__file__).resolve().parents[1]
EQUAL_KEYS = ("n", "m", "lambda", "delta", "threshold", "high_degree",
              "depth_raw", "depth_capped", "phases",
              "bytes_per_round_unpacked", "bytes_per_round_packed",
              "variants_total_collective_bytes")


def _reference_dryrun(**kw):
    code = ("import json; from repro.launch.cluster_dryrun import run; "
            f"print(json.dumps(run(**{kw!r}), default=float))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cluster_dryrun_equals_reference():
    kw = dict(n=1024, attach=4, chips=8)
    want = _reference_dryrun(**kw)
    got = json.loads(json.dumps(cluster_dryrun.run(**kw, device="cpu"),
                                default=float))
    assert got.keys() == want.keys()
    for k in EQUAL_KEYS:
        assert got[k] == want[k], k
    assert got["bytes_per_round_unpacked"] == 8 * 8200
    assert got["bytes_per_round_packed"] == 8 * 5125
    # The time model: H100 link and operation rates only.
    for name, total in got["variants_total_collective_bytes"].items():
        assert got["t_collective_s"][name] == total / (
            8 * measure.NVLINK_BYTES_PER_S)
    assert got["t_compute_s"] == 4.0 * got["m"] * got["depth_raw"] / (
        8 * measure.NON_TENSOR_OPS_PER_S)
    assert got["per_device_bytes"] == cluster_dryrun.per_device_bytes(
        1024, -(-2 * got["m"] // 8))


def test_cluster_dryrun_link_rate_and_cli(tmp_path, capsys):
    assert cluster_dryrun.link_bytes_per_s(8) == measure.NVLINK_BYTES_PER_S
    assert cluster_dryrun.link_bytes_per_s(9) == \
        measure.INFINIBAND_BYTES_PER_S
    out = tmp_path / "d.json"
    assert cluster_dryrun.main(["--n", "512", "--attach", "3", "--chips",
                                "256", "--device", "cpu", "--out",
                                str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["bytes_per_round_packed"] == 256 * 5 * 513
    assert json.loads(capsys.readouterr().out) == rec


def _lines(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue().splitlines()


def _reference_lines(name):
    """The reference example's printed lines (up to a failure of its own:
    its distributed engine's ``shard_map`` call fails on this jax)."""
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        mod = __import__(name)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            try:
                mod.main()
            except TypeError as exc:
                assert "check_rep" in str(exc)
        return buf.getvalue().splitlines()
    finally:
        sys.path.remove(str(ROOT / "examples"))
        sys.modules.pop(name, None)


@pytest.mark.parametrize("name,module", [
    ("quickstart", quickstart), ("forest_clustering", forest_clustering),
    ("dedup_pipeline", dedup_pipeline)])
def test_examples_print_the_reference_lines(name, module):
    got = _lines(module.main, ["--device", "cpu"])
    want = _reference_lines(name)
    assert want and got[:len(want)] == want
    assert len(got) == {"quickstart": 5}.get(name, len(want))


@pytest.fixture
def program_registry():
    """The example fills the process-wide program registry to capacity;
    put it back after, so later tests of this process see what they would
    see alone."""
    with executor._cache_lock:
        saved = executor._program_cache.copy()
    yield
    with executor._cache_lock:
        executor._program_cache.clear()
        executor._program_cache.update(saved)


def test_batch_serving_example_serves_every_request(program_registry):
    lines = _lines(batch_serving.main, ["--device", "cpu"])
    served = [ln for ln in lines if ln.startswith("served ")]
    assert len(served) == 6 and all("served 100 queries" in ln
                                    for ln in served)
    assert lines[-1].startswith("steal pricing: {'steals_accepted'")


def test_serve_decode_example():
    lines = _lines(serve_decode.main, ["--device", "cpu"])
    assert lines[1].startswith("prefills=8 decode_steps=")
    assert len([ln for ln in lines if ln.startswith("  req ")]) == 3


def test_train_smollm_example(tmp_path):
    lines = _lines(train_smollm.main, ["--device", "cpu", "--steps", "3",
                                       "--ckpt-dir", str(tmp_path)])
    assert lines[0].startswith("step     0 loss")
    assert lines[-1].startswith("trained 3 steps: loss ")


def _ref_flat(state):
    """The reference's checkpoint keys and arrays of a state."""
    keys, vals, _ = ref_ckpt._flatten_with_paths(jax.tree.map(np.asarray,
                                                              state))
    return dict(zip(keys, vals))


def _ref_model():
    return ref_build_model(ref_get_smoke("smollm-135m"),
                           plan=ShardingPlan.null(), param_dtype=jnp.float32)


def test_flash_attention_guard_condition_on_the_cpu():
    """B4's card path refuses what ``refuses_grad`` flags (checked on the
    card in tests/test_torch_cuda_train.py); the CPU's plain version keeps its
    gradient."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = (torch.randn(1, 2, 9, 16) for _ in range(3))
    assert not fa.refuses_grad(q, k, v)
    k.requires_grad_(True)
    assert fa.refuses_grad(q, k, v)
    with torch.no_grad():
        assert not fa.refuses_grad(q, k, v)
    out = fa.flash_attention(q, k, v)
    (grad,) = torch.autograd.grad(out.sum(), (k,))
    assert grad.shape == k.shape and torch.isfinite(grad).all()


def test_run_config_keeps_the_reference_fields_and_refuses_other_families():
    assert [f.name for f in dataclasses.fields(RunConfig)] == \
        [f.name for f in dataclasses.fields(RefRunConfig)]
    assert dataclasses.asdict(RunConfig()) == dataclasses.asdict(
        RefRunConfig())
    RunConfig(attn_impl="naive", remat=True, loss_chunk=7).check("dense")
    for bad in (dict(moe_impl="einsum"), dict(ssd_chunk=16),
                dict(rwkv_impl="scan"), dict(moe_capacity=2.0)):
        with pytest.raises(ValueError, match="not read by the dense"):
            build_model(get_smoke("smollm-135m"), device="meta",
                        rc=RunConfig(**bad))
    model = build_model(get_smoke("smollm-135m"), device="cpu",
                        rc=RunConfig(attn_impl="flash"),
                        generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="'flash' is not one of"):
        model.loss({"tokens": torch.zeros((1, 4), dtype=torch.int32),
                    "labels": torch.zeros((1, 4), dtype=torch.int32)})
    # Every family is ported: the ssm family reads rwkv_impl, and the
    # training launcher trains all four other families with the fields
    # each reads (tests/test_torch_train_families.py holds them to the
    # reference).
    RunConfig().check("ssm")
    RunConfig(rwkv_impl="scan").check("ssm")
    for arch in ("rwkv6-1.6b", "zamba2-2.7b", "whisper-base",
                 "llama-3.2-vision-90b"):
        cfg = get_smoke(arch)
        port_train.run_config(cfg, True, 8).check(cfg.family)
        out = port_train.run(arch, smoke=True, steps=1, ckpt_dir=None,
                             resume=False, fail_at=None, seq_len=8,
                             global_batch=2, dedup=False, device="cpu")
        assert len(out["losses"]) == 1 and np.isfinite(out["losses"]).all()


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _port_state(compress=False, seed=0):
    model = build_model(get_smoke("smollm-135m"), device="cpu",
                        generator=torch.Generator().manual_seed(seed))
    oc = optimizer.OptConfig()
    state = port_step.init_train_state(
        model, oc, port_step.StepConfig(compress_cross_pod=compress))
    gen = torch.Generator().manual_seed(seed + 1)
    for part in (state.opt.mu, state.opt.nu) + (
            (state.err,) if compress else ()):
        for t in part.values():
            t.copy_(torch.rand(t.shape, generator=gen))
    return state._replace(opt=state.opt._replace(step=7))


@pytest.mark.parametrize("compress", [False, True])
def test_checkpoint_keys_are_the_references(compress):
    jmodel = _ref_model()
    jstate = ref_step.init_train_state(
        jmodel, jax.random.PRNGKey(0), ref_opt.OptConfig(),
        ref_step.StepConfig(compress_cross_pod=compress))
    keys, _, _ = ref_ckpt._flatten_with_paths(jstate)
    state = _port_state(compress)
    assert sorted(weights.train_state_keys(state.params, compress)) == \
        sorted(keys)
    assert sorted(checkpoint._arrays(state)) == sorted(keys)


def test_checkpoint_round_trip_in_the_port(tmp_path):
    state = _port_state(compress=True, seed=3)
    want = {k: v.copy() for k, v in checkpoint._arrays(state).items()}
    path = checkpoint.save_checkpoint(tmp_path, 7, state, extra={"a": 1})
    assert path.name == "step_00000007"
    assert not list(tmp_path.glob("*.tmp"))
    other = _port_state(compress=True, seed=9)
    restored, manifest = checkpoint.restore_checkpoint(tmp_path, other)
    assert manifest["step"] == 7 and manifest["extra"] == {"a": 1}
    assert restored.opt.step == 7
    got = checkpoint._arrays(restored)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v)


def test_checkpoint_bf16_state_round_trips(tmp_path):
    model = build_model(get_smoke("smollm-135m"), device="cpu")
    oc = optimizer.OptConfig(state_dtype="bfloat16")
    state = port_step.init_train_state(model, oc)
    for t in state.opt.mu.values():
        t.copy_(torch.randn(t.shape))
    want = {n: t.clone() for n, t in state.opt.mu.items()}
    checkpoint.save_checkpoint(tmp_path, 1, state)
    for t in state.opt.mu.values():
        t.zero_()
    checkpoint.restore_checkpoint(tmp_path, state)
    for n, t in state.opt.mu.items():
        assert t.dtype == torch.bfloat16 and torch.equal(t, want[n])


def test_reference_checkpoint_restores_in_the_port_and_back(tmp_path):
    jmodel = _ref_model()
    jstate = ref_step.init_train_state(jmodel, jax.random.PRNGKey(5),
                                       ref_opt.OptConfig(),
                                       ref_step.StepConfig())
    jstate = jstate._replace(opt=jstate.opt._replace(
        mu=jax.tree.map(lambda p: p * 0.5, jstate.params),
        step=jnp.int32(12)))
    ref_ckpt.save_checkpoint(tmp_path / "ref", 12, jstate)
    state = _port_state()
    restored, manifest = checkpoint.restore_checkpoint(tmp_path / "ref",
                                                       state)
    assert manifest["step"] == 12 and restored.opt.step == 12
    got = checkpoint._arrays(restored)
    for k, v in _ref_flat(jstate).items():
        np.testing.assert_array_equal(got[k], v)

    # The port's checkpoint of what it restored restores in the reference.
    checkpoint.save_checkpoint(tmp_path / "port", 12, restored)
    template = ref_step.init_train_state(jmodel, jax.random.PRNGKey(0),
                                         ref_opt.OptConfig(),
                                         ref_step.StepConfig())
    back, manifest = ref_ckpt.restore_checkpoint(tmp_path / "port", template)
    assert manifest["step"] == 12
    for k, v in _ref_flat(back).items():
        np.testing.assert_array_equal(v, got[k])


def test_tampered_checkpoint_raises_and_prune_keeps_the_newest(tmp_path):
    state = _port_state()
    for step in (1, 2, 3, 4):
        checkpoint.save_checkpoint(tmp_path, step, state)
    assert checkpoint.latest_step(tmp_path) == 4
    checkpoint.prune_checkpoints(tmp_path, keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == \
        ["step_00000003", "step_00000004"]
    arrays = dict(np.load(tmp_path / "step_00000004" / "arrays.npz"))
    key = ".params/['embed']"
    arrays[key] = arrays[key].copy()
    arrays[key].flat[0] += 1.0
    np.savez(tmp_path / "step_00000004" / "arrays.npz", **arrays)
    with pytest.raises(IOError, match="corruption"):
        checkpoint.restore_checkpoint(tmp_path, state)
    checkpoint.restore_checkpoint(tmp_path, state, step=3)
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_checkpoint(tmp_path / "none", state)


# ---------------------------------------------------------------------------
# the training launcher, end to end
# ---------------------------------------------------------------------------

COMMON = dict(arch="smollm-135m", smoke=True, seq_len=32, global_batch=4,
              ckpt_every=5, seed=0, log_every=100)


def test_launcher_resumes_a_reference_checkpoint(tmp_path):
    """The reference trains 10 steps, checkpointing at 5; the port resumes
    from its step-5 checkpoint and continues its loss trajectory."""
    want = ref_train.run(steps=10, ckpt_dir=str(tmp_path / "ref"),
                         resume=False, fail_at=None, dedup=False, **COMMON)
    shutil.copytree(tmp_path / "ref" / "step_00000005",
                    tmp_path / "port" / "step_00000005")
    got = port_train.run(steps=10, ckpt_dir=str(tmp_path / "port"),
                         resume=True, fail_at=None, dedup=False,
                         device="cpu", **COMMON)
    np.testing.assert_allclose(got["losses"], want["losses"][5:], rtol=1e-4,
                               atol=0)
    # ... and the port's step-10 checkpoint restores in the reference.
    model = ref_build_model(ref_get_smoke("smollm-135m"),
                            param_dtype=jnp.float32)
    template = ref_step.init_train_state(model, jax.random.PRNGKey(0),
                                         ref_opt.OptConfig())
    _, manifest = ref_ckpt.restore_checkpoint(tmp_path / "port", template)
    assert manifest["step"] == 10


def test_launcher_fail_and_resume_is_bitwise(tmp_path):
    whole = port_train.run(steps=15, ckpt_dir=None, resume=False,
                           fail_at=None, dedup=False, device="cpu", **COMMON)
    with pytest.raises(SimulatedFailure):
        port_train.run(steps=15, ckpt_dir=str(tmp_path), resume=False,
                       fail_at=10, dedup=False, device="cpu", **COMMON)
    out = port_train.run(steps=15, ckpt_dir=str(tmp_path), resume=True,
                         fail_at=None, dedup=False, device="cpu", **COMMON)
    assert out["losses"] == whole["losses"][10:]
    assert len(out["step_s"]) == 5


def test_launcher_pipeline_with_dedup_equals_reference():
    cfg, jcfg = get_smoke("smollm-135m"), ref_get_smoke("smollm-135m")
    got = port_train.build_pipeline(cfg, 32, 4, dedup=True, seed=1,
                                    device="cpu")
    want = ref_train.build_pipeline(jcfg, 32, 4, dedup=True, seed=1)
    assert got.num_sequences == want.num_sequences
    for step in (0, 1, 7, 1000):
        g, w = got.batch_at(step), want.batch_at(step)
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_launcher_main_trains_with_dedup_and_refuses_cuda_without_it(tmp_path,
                                                                    capsys):
    port_train.main(["--smoke", "--steps", "2", "--seq-len", "16",
                     "--global-batch", "2", "--ckpt-every", "1",
                     "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    assert "step     0 loss" in capsys.readouterr().out
    assert checkpoint.latest_step(tmp_path) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_train.run(steps=1, ckpt_dir=None, resume=False, fail_at=None,
                           dedup=False, **COMMON)
