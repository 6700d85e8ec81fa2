"""The four other families on a mesh (ROADMAP 18d-2) against the
reference's unsharded model, on the CPU: rwkv6-1.6b (ssm), zamba2-2.7b
(hybrid), whisper-base (encdec) and llama-3.2-vision-90b (vlm), served
and trained.

Each smoke model is the reference's ``init`` (``jax.random``, f32 weights)
with the leaves that start at constants moved off them (the cross
``gate``, RWKV's ``u`` and ``w0``, Mamba's ``A_log`` and ``dt_bias``), so
the cross paths, the bonus term and the decays are seen and the gate takes
a gradient; each rank loads its blocks (``shard_params``,
``from_reference_params(plan=, mesh=)``). Tokens, labels and the stub
embeddings are drawn with numpy from a seed. The meshes, (data, model):
(1, 2) and (2, 1) in a spawned group of 2 gloo processes, (2, 2) in one of
4, over a ``FileStore``, started together; each writes its results to
files that the tests below read (``tests/test_torch_sharding.py``'s
layout). The spawned processes import this module, whose reference imports
are made inside the tests, so they load no jax. Serving runs the
reference's default evaluators (``rwkv_chunked``, ``ssd_chunk`` 64);
training ``chunked`` attention (the cross and non-causal kind under grad),
``rwkv_chunked`` and ``ssd_chunk`` 4 (two chunks of the 8 tokens), on both
sides.

Tolerances, with their reasons:

* serving, f32 weights and f32 caches: prefill logits, every cache leaf
  gathered after prefill and after 4 teacher-forced decode steps, and
  each decode step's logits within 1e-4 of the reference, as the
  families' f32-cache tests hold them (``tests/test_torch_families.py``):
  the row-parallel all-reduces, the split mean squares of the mixers'
  norms and the split softmax sum in another order;
* the loss of one batch within 1e-5 relative and every leaf's gradient,
  gathered and summed over data, within 1e-4 of its leaf's gradient norm
  (``tests/test_torch_train_families.py``'s bounds): f32 sums in another
  order through the recurrences; the VLM's gate takes its whole gradient
  once, neither one rank's part nor the sum over the ranks;
* two chained ``make_train_step`` steps against the reference's
  unsharded step, with ``tests/test_torch_sharding.py``'s bounds: loss
  1e-5 and ``grad_norm`` 1e-4 relative, ``lr`` exactly; the gathered
  params and moments within 1e-4 of each leaf's largest value on all but
  1e-3 of the elements and every element within what one flipped rounding
  can move it (a parameter by 2 lr a step: Adam's first update is the sign
  of a tiny gradient); for zamba2 step 2's ``grad_norm`` and the moments
  within 1e-3 (``STEP_TOL``: its unsharded port is already 1.07e-4 and
  1.3e-4 from the reference there, the flipped signs of step 1 moving step
  2's gradients);
* a checkpoint saved from the shards: every array equal, byte for byte,
  to an unsharded save of the gathered state;
* on the meta device, every family builds on a one-axis mesh of two
  ranks with each parameter the block ``local_block`` gives its
  ``param_specs`` entry, exactly.
"""

import functools
import json
import os
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from repro_torch.configs import get_smoke
from repro_torch.launch.mesh import make_mesh, standin_mesh
from repro_torch.models import build_model, common, parallel, weights
from repro_torch.models.sharding import local_block, resolve_plan
from repro_torch.models.transformer import RunConfig
from repro_torch.models.weights import (from_reference_params,
                                        reference_key, reference_path,
                                        shard_params)
from repro_torch.train import train_step as port_step
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.optimizer import OptConfig, sharded_axes
from test_torch_sharding import _flat, _unflat

ARCHS = ("rwkv6-1.6b", "zamba2-2.7b", "whisper-base", "llama-3.2-vision-90b")
MESHES = {"1x2": (1, 2), "2x1": (2, 1), "2x2": (2, 2)}
CASES = [(a, m) for a in ARCHS for m in MESHES]
TOL = 1e-4
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
PROMPT, CACHE_LEN, DECODE_STEPS = 11, 16, 4
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 8, 2
TRAIN_OC = dict(lr=1e-3, warmup_steps=2, total_steps=10)
# Training's RunConfig fields, each family's own (RunConfig.check).
TRAIN_RC = {"ssm": dict(attn_impl="chunked", rwkv_impl="chunked"),
            "hybrid": dict(attn_impl="chunked", ssd_chunk=4)}
STUBS = {"encdec": "audio_embeds", "vlm": "image_embeds"}
# The bound of step 2's grad_norm (relative) and of a moment after it
# (relative to its leaf's largest value), by family; GRAD_TOL where not
# given. zamba2's smoke gradients (norm ~35) move where step 1's Adam
# update flipped the sign of a tiny gradient, so even its unsharded port
# is 1.07e-4 (grad_norm) and 1.3e-4 (moments) from the reference after
# the two steps, sharding aside; its first step and every leaf's gradient
# are held to GRAD_TOL.
STEP_TOL = {"hybrid": 1e-3}


def _train_fields(arch):
    return TRAIN_RC.get(get_smoke(arch).family, dict(attn_impl="chunked"))


def _case_id(arch, mesh):
    return f"{arch}-{mesh}"


@functools.lru_cache(maxsize=None)
def _ref():
    """The reference's modules (jax), imported on first use."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke as ref_get_smoke
    from repro.models import RunConfig as RefRunConfig
    from repro.models import build_model as ref_build_model
    from repro.models.sharding import ShardingPlan
    from repro.train import checkpoint, optimizer, train_step
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, get_smoke=ref_get_smoke, RunConfig=RefRunConfig,
        build_model=ref_build_model, ShardingPlan=ShardingPlan,
        checkpoint=checkpoint, optimizer=optimizer, train_step=train_step)


# -- inputs -------------------------------------------------------------------


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


def _ref_model(arch, fields=()):
    r = _ref()
    return r.build_model(r.get_smoke(arch), plan=r.ShardingPlan.null(),
                         rc=r.RunConfig(**dict(fields)),
                         param_dtype=r.jnp.float32)


@functools.lru_cache(maxsize=None)
def _ref_tree(arch):
    """The reference smoke params of ``arch`` as numpy, constants moved."""
    r = _ref()
    params, _ = _ref_model(arch).init(r.jax.random.PRNGKey(0))
    return _perturb(r.jax.tree.map(np.array, params),
                    np.random.default_rng(3))


def _stub(cfg, rng, batch):
    key = STUBS.get(cfg.family)
    if key is None:
        return {}
    n = cfg.encoder_seq if key == "audio_embeds" else cfg.num_image_tokens
    return {key: rng.standard_normal((batch, n, cfg.d_model)).astype(
        np.float32)}


def _serving_inputs(cfg):
    rng = np.random.default_rng(1)
    prompt = rng.integers(2, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    forced = rng.integers(2, cfg.vocab_size,
                          (DECODE_STEPS, 2)).astype(np.int32)
    return prompt, forced, _stub(cfg, rng, 2)


def _train_batch(cfg, step):
    rng = np.random.default_rng([17, step])
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S)),
             "labels": rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S))}
    batch = {k: v.astype(np.int32) for k, v in batch.items()}
    batch["labels"][rng.random((TRAIN_B, TRAIN_S)) < 0.2] = -1
    batch.update(_stub(cfg, rng, TRAIN_B))
    return batch


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# -- the spawned ranks -------------------------------------------------------


def _sharded(arch, axes, root, fields=None):
    cfg = get_smoke(arch)
    mesh = make_mesh(axes)
    plan = resolve_plan(cfg, None, axes)
    with np.load(os.path.join(root, f"tree_{arch}.npz")) as f:
        tree = _unflat(f)
    return from_reference_params(cfg, shard_params(cfg, tree, plan, mesh),
                                 device="cpu", plan=plan, mesh=mesh,
                                 rc=RunConfig(mesh=mesh, **(fields or {})))


def _serve(arch, axes, root):
    """Prefill, every cache gathered, 4 teacher-forced decode steps."""
    model = _sharded(arch, axes, root)
    cfg = model.cfg
    prompt, forced, stubs = _serving_inputs(cfg)
    out = {"local_numel": sum(p.numel() for p in model.parameters())}
    parallel.reset_counts()
    logits, caches = model.prefill(
        torch.from_numpy(prompt).long(), cache_len=CACHE_LEN,
        cache_dtype=torch.float32, **_torch_batch(stubs))
    out["counts"] = np.array([parallel.counts[k]["calls"]
                              for k in parallel.KINDS])
    out["logits_0"] = logits.numpy()
    specs = model.cache_specs()
    for name, c in caches.items():
        # A copy: decode writes the caches in place, and a leaf whole on
        # this rank gathers to itself.
        out[f"cache_0_{name}"] = model.layout.gather_spec(
            c, specs[name]).numpy().copy()
    for step, tok in enumerate(forced):
        logits, caches = model.decode_step(torch.from_numpy(tok).long(),
                                           caches, PROMPT + step)
        out[f"logits_{step + 1}"] = logits.numpy()
    for name, c in caches.items():
        out[f"cache_{DECODE_STEPS}_{name}"] = model.layout.gather_spec(
            c, specs[name]).numpy()
    return out


def _train(arch, axes, root, tag):
    """One batch's loss and every gradient (summed over data, gathered);
    then 2 chained train steps, the final state gathered and saved as a
    checkpoint from the shards."""
    model = _sharded(arch, axes, root, _train_fields(arch))
    cfg, layout = model.cfg, model.layout
    specs = model.param_specs()
    out = {}
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    loss, grads = port_step._value_and_grad(
        model, params, _torch_batch(_train_batch(cfg, 0)))
    batch_axes = layout.axes("batch")
    grads = port_step._reduce_over_data(grads, {
        n: tuple(a for a in batch_axes if a not in sharded_axes(layout, s))
        for n, s in specs.items()}, layout)
    out["grad_loss"] = np.asarray(float(loss))
    out.update(weights.stacked_arrays(".grads", {
        n: layout.gather_spec(g.contiguous(), specs[n])
        for n, g in grads.items()}))

    oc = OptConfig(**TRAIN_OC)
    state = port_step.init_train_state(model, oc)
    step_fn = port_step.make_train_step(model, oc)
    for i in range(TRAIN_STEPS):
        parallel.reset_counts()
        state, m = step_fn(state, _torch_batch(_train_batch(cfg, i)))
        if i == 0:
            out["counts"] = np.array([parallel.counts[k]["calls"]
                                      for k in parallel.KINDS])
        for k in ("loss", "grad_norm", "lr"):
            out[f"{k}_{i}"] = np.asarray(float(m[k]))
    for part, tensors in (("params", state.params), ("mu", state.opt.mu),
                          ("nu", state.opt.nu)):
        for name, t in tensors.items():
            out[f"{part}:{name}"] = layout.gather_spec(t.detach(),
                                                       specs[name]).numpy()
    out["state_numel"] = np.asarray(sum(
        t.numel() for part in (state.params, state.opt.mu, state.opt.nu)
        for t in part.values()))
    save_checkpoint(os.path.join(root, f"ckpt_{tag}"), TRAIN_STEPS, state,
                    layout=layout)
    return out


def _worker(rank, world, store, root):
    torch.set_num_threads(1)     # small shapes; the ranks share the cores
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        for arch, mesh in CASES:
            data, nmodel = MESHES[mesh]
            if data * nmodel != world:
                continue
            axes = {"data": data, "model": nmodel}
            tag = _case_id(arch, mesh)
            np.savez(os.path.join(root, f"serve_{tag}_{rank}.npz"),
                     **_serve(arch, axes, root))
            np.savez(os.path.join(root, f"train_{tag}_{rank}.npz"),
                     **_train(arch, axes, root, tag))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Writes the reference trees, runs the 2- and 4-rank groups once and
    computes the reference's side while they run; the result directory."""
    root = str(tmp_path_factory.mktemp("sharding_families"))
    for arch in ARCHS:
        np.savez(os.path.join(root, f"tree_{arch}.npz"),
                 **_flat(_ref_tree(arch)))
    groups = [tmp.spawn(_worker, args=(world, os.path.join(
        root, f"store{world}"), root), nprocs=world, join=False)
        for world in (2, 4)]
    try:
        for arch in ARCHS:
            _ref_serving(arch)
            _ref_grads(arch)
            _ref_train(arch)
    finally:
        for group in groups:
            while not group.join():
                pass
    return root


# -- the reference's side -----------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_serving(arch):
    """The reference's unsharded prefill and decode: the logits of each
    call, the caches after prefill and after the last step (numpy)."""
    r = _ref()
    jnp = r.jnp
    jmodel = _ref_model(arch)
    params = r.jax.tree.map(jnp.asarray, _ref_tree(arch))
    prompt, forced, stubs = _serving_inputs(get_smoke(arch))
    batch = {"tokens": jnp.asarray(prompt),
             **{k: jnp.asarray(v) for k, v in stubs.items()}}
    logits, caches = jmodel.prefill(params, batch, cache_len=CACHE_LEN,
                                    cache_dtype=jnp.float32)
    out = {"logits_0": np.asarray(logits)}
    out.update({f"cache_0_{k}": np.asarray(v) for k, v in caches.items()})
    for step, tok in enumerate(forced):
        logits, caches = jmodel.decode_step(params, jnp.asarray(tok), caches,
                                            jnp.int32(PROMPT + step))
        out[f"logits_{step + 1}"] = np.asarray(logits)
    out.update({f"cache_{DECODE_STEPS}_{k}": np.asarray(v)
                for k, v in caches.items()})
    return out


def _ref_flat(tree):
    r = _ref()
    keys, vals, _ = r.checkpoint._flatten_with_paths(
        r.jax.tree.map(np.asarray, tree))
    return dict(zip(keys, vals))


@functools.lru_cache(maxsize=None)
def _ref_grads(arch):
    """The reference's unsharded loss of batch 0 and its gradient, by
    checkpoint key."""
    r = _ref()
    jmodel = _ref_model(arch, tuple(sorted(_train_fields(arch).items())))
    params = r.jax.tree.map(r.jnp.asarray, _ref_tree(arch))
    batch = {k: r.jnp.asarray(v)
             for k, v in _train_batch(get_smoke(arch), 0).items()}
    loss, grads = r.jax.jit(r.jax.value_and_grad(jmodel.loss))(params, batch)
    return float(loss), _ref_flat(grads)


@functools.lru_cache(maxsize=None)
def _ref_train(arch):
    """The reference's unsharded ``make_train_step``, 2 chained steps:
    each step's metrics and the final state's flat leaves."""
    r = _ref()
    jmodel = _ref_model(arch, tuple(sorted(_train_fields(arch).items())))
    params = r.jax.tree.map(r.jnp.asarray, _ref_tree(arch))
    oc = r.optimizer.OptConfig(**TRAIN_OC)
    state = r.train_step.TrainState(params=params,
                                    opt=r.optimizer.opt_init(params, oc),
                                    err=None)
    step = r.jax.jit(r.train_step.make_train_step(jmodel, oc))
    metrics = []
    for i in range(TRAIN_STEPS):
        batch = {k: r.jnp.asarray(v)
                 for k, v in _train_batch(get_smoke(arch), i).items()}
        state, m = step(state, batch)
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
    return metrics, _ref_flat(state)


# -- the spawned cases against the reference --------------------------------


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=tol, err_msg=what)


def _state_close(got, want, key, bound, tol, scale):
    """Every element within ``bound``, and all but 1e-3 of them within
    ``tol`` of the leaf's largest value (``tests/test_torch_sharding.py``'s
    check, at the family's ``tol``)."""
    scale = max(1e-3, scale)
    diff = np.abs(np.asarray(got, np.float32) - want)
    assert diff.max() <= bound + 1e-6 * scale, key
    assert (diff > tol * scale).mean() <= 1e-3, key


def _ranks(spawned, kind, arch, mesh):
    data, nmodel = MESHES[mesh]
    return [np.load(os.path.join(spawned, f"{kind}_{_case_id(arch, mesh)}_"
                                 f"{rank}.npz"))
            for rank in range(data * nmodel)]


def _whole_numel(arch):
    return sum(v.size for v in _flat(_ref_tree(arch)).values())


@pytest.mark.parametrize("arch,mesh", CASES)
def test_sharded_family_serving_matches_unsharded_reference(spawned, arch,
                                                            mesh):
    """Prefill logits, every cache leaf gathered after prefill and after
    4 decode steps, and each step's logits, on every rank; a rank holds
    less than the whole model and issued collectives."""
    want = _ref_serving(arch)
    for got in _ranks(spawned, "serve", arch, mesh):
        assert int(got["local_numel"]) < _whole_numel(arch)
        assert int(got["counts"].sum()) > 0
        assert set(want) <= set(got.files)
        for key, w in want.items():
            assert got[key].shape == w.shape, key
            _close(got[key], w, key)


@pytest.mark.parametrize("arch,mesh", CASES)
def test_sharded_family_gradients_match_reference(spawned, arch, mesh):
    """One batch's loss and every leaf's gradient, summed over data and
    gathered, against ``jax.value_and_grad`` of the reference's unsharded
    loss: the recurrences' (``rwkv_chunked``, ``ssd_chunked``), the
    encoder's through the cross-attention, and the VLM's gate, whose
    gradient is whole once on every rank."""
    loss, want = _ref_grads(arch)
    for got in _ranks(spawned, "train", arch, mesh):
        assert abs(float(got["grad_loss"]) - loss) <= LOSS_TOL * abs(loss)
        keys = {k for k in got.files if k.startswith(".grads/")}
        assert keys == {".grads/" + k for k in want}
        for key, jg in want.items():
            g = got[".grads/" + key]
            assert np.isfinite(g).all(), key
            assert np.abs(g - jg).max() <= GRAD_TOL * max(
                np.linalg.norm(jg), 1e-6), key
        if arch == "llama-3.2-vision-90b":
            gate = got[".grads/['cross_layers']/['xattn']/['gate']"]
            assert np.abs(gate).min() > 0


@pytest.mark.parametrize("arch,mesh", CASES)
def test_sharded_family_train_step_matches_reference(spawned, arch, mesh):
    """Two chained steps: loss, grad_norm and lr of each, and the params
    and moments after the last, gathered on every rank, against the
    reference's unsharded step; a step's collective counts the same on
    every rank."""
    metrics, want = _ref_train(arch)
    prefix = {"params": ".params", "mu": ".opt/.mu", "nu": ".opt/.nu"}
    lr_sum = sum(m["lr"] for m in metrics)
    counts = None
    n_leaves = len(dict(build_model(get_smoke(arch),
                                    device="meta").named_parameters()))
    tol = STEP_TOL.get(get_smoke(arch).family, GRAD_TOL)
    for got in _ranks(spawned, "train", arch, mesh):
        for i, m in enumerate(metrics):
            assert abs(float(got[f"loss_{i}"]) - m["loss"]) <= \
                LOSS_TOL * abs(m["loss"]), i
            assert abs(float(got[f"grad_norm_{i}"]) - m["grad_norm"]) <= \
                (GRAD_TOL if i == 0 else tol) * m["grad_norm"], i
            assert float(got[f"lr_{i}"]) == m["lr"]
        c = tuple(int(n) for n in got["counts"])
        assert counts is None or c == counts
        counts = c
        n_keys = 0
        for key in got.files:
            if ":" not in key:
                continue
            part, name = key.split(":")
            path, idx = reference_path(name)
            w = want[reference_key(prefix[part], path)][idx]
            bound = 2.0 * lr_sum * 1.001 if part == "params" else max(
                1e-3, float(np.abs(w).max())) * tol
            _state_close(got[key], w, key, bound, tol,
                         scale=float(np.abs(w).max()))
            n_keys += 1
        assert n_keys == 3 * n_leaves


@pytest.mark.parametrize("arch,mesh", CASES)
def test_sharded_family_checkpoint_equals_unsharded_save(spawned, arch, mesh,
                                                         tmp_path):
    """The checkpoint saved from the shards (rank 0 writes the gathered
    leaves): an unsharded port model restores it to rank 0's gathered
    state, every array equals an unsharded save of that state byte for
    byte, and a rank held less than the whole state."""
    cfg = get_smoke(arch)
    path = Path(spawned) / f"ckpt_{_case_id(arch, mesh)}"
    got = _ranks(spawned, "train", arch, mesh)[0]
    model = build_model(cfg, device="cpu")
    state = port_step.init_train_state(model, OptConfig(**TRAIN_OC))
    state, manifest = restore_checkpoint(path, state)
    assert manifest["step"] == TRAIN_STEPS == state.opt.step
    whole = 0
    for part, tensors in (("params", state.params), ("mu", state.opt.mu),
                          ("nu", state.opt.nu)):
        for name, t in tensors.items():
            np.testing.assert_array_equal(t.detach().numpy(),
                                          got[f"{part}:{name}"])
            whole += t.numel()
    assert int(got["state_numel"]) < whole
    save_checkpoint(tmp_path / "whole", TRAIN_STEPS, state)
    step = f"step_{TRAIN_STEPS:08d}"
    assert (json.loads((path / step / "manifest.json").read_text())
            == json.loads((tmp_path / "whole" / step / "manifest.json")
                          .read_text()))
    with np.load(path / step / "arrays.npz") as a, \
            np.load(tmp_path / "whole" / step / "arrays.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k


# -- on the meta device, in this process --------------------------------------


def check_meta_build_on_mesh(arch, axis, coord=1, size=2):
    """Build ``arch``'s smoke config on the meta device on a one-axis
    stand-in mesh ``{axis: size}`` at ``coord`` (``launch.mesh.
    standin_mesh``: no process group): its layout holds the plan and the
    coordinates, and every parameter the block of its whole leaf that
    ``local_block`` gives its ``param_specs`` entry. Returns the model."""
    cfg = get_smoke(arch)
    axes = {axis: size}
    plan = resolve_plan(cfg, None, axes)
    model = build_model(cfg, device="meta", plan=plan,
                        mesh=standin_mesh(axes, {axis: coord}))
    assert model.layout is not None and model.plan is plan
    assert model.layout.coords == {axis: coord}
    whole = dict(build_model(cfg, device="meta").named_parameters())
    specs = model.param_specs()
    split = 0
    for name, p in model.named_parameters():
        block = local_block(whole[name].shape, specs[name], axes,
                            {axis: coord})
        assert tuple(p.shape) == tuple(s.stop - s.start for s in block), name
        split += tuple(p.shape) != tuple(whole[name].shape)
    assert split > 0
    return model


@pytest.mark.parametrize("axis", ["model", "data"])
@pytest.mark.parametrize("arch", ARCHS)
def test_family_builds_on_a_mesh_with_its_blocks(arch, axis):
    check_meta_build_on_mesh(arch, axis)


def test_mixers_refuse_heads_that_do_not_divide():
    """The RWKV and Mamba2 mixers run whole heads on each rank: a head
    count that does not divide over the ``ff`` axes is refused, naming
    them."""
    layout = types.SimpleNamespace(span=lambda axes: 8,
                                   index=lambda axes: 3)
    assert common.head_block(None, (), 5, "x") == (0, 5)
    assert common.head_block(layout, ("model",), 16, "x") == (6, 2)
    with pytest.raises(ValueError, match="4 heads do not divide"):
        common.head_block(layout, ("model",), 4, "the RWKV time mix")


def test_every_family_takes_a_mesh_in_its_run_config():
    for arch in ARCHS:
        RunConfig(mesh=object()).check(get_smoke(arch).family)
