"""Sharding (ROADMAP 18d) against the reference, on the CPU.

The port's plan (``models/sharding.py``), its spec trees (``param_specs``,
``cache_specs``), sharded serving on ``torch.distributed`` meshes of gloo
processes, ``moe_ep_local`` and the checkpoint's re-layout on restore,
each held to ``repro``. Weights and inputs are drawn with numpy or
``jax.random`` from a seed and cross as numpy (``from_reference_params``,
``shard_params``). The multi-rank cases run in two spawned groups (2 and 4
processes, gloo over a ``FileStore``) that write their results to files;
the tests below read them. The spawned processes import this module,
whose reference imports are made inside the tests (:func:`_ref`), so they
load no jax.

Tolerances, with their reasons:

* the plan, the spec trees and the cache specs equal, entry for entry;
* sharded serving (f32 weights, f32 caches, prefill logits, every cache
  leaf gathered, 4 teacher-forced decode steps) within 1e-4 of the
  reference's unsharded model, as the families' f32-cache tests hold
  them: the row-parallel all-reduces and the split softmax sum in another
  order;
* ``moe_ep_local`` outputs and gradients (x and the expert weights)
  within 1e-4: f32 expert products of width 64 summed in another order,
  on outputs of order 1; the dropped assignments equal (an integer
  decision on the same f32 logits);
* a restore onto a mesh keeps exactly each leaf's block; on a one-rank
  mesh the restore and the ``sort`` serving path are bit-equal to the
  unsharded ones;
* ``set_matmul_reduce_dtype('bf16')``: bit-equal to the reference's
  ``linear`` on one device;
* the sharded train step (2 chained steps from the reference's weights,
  plain and with ``accum_steps=2`` and ``compress_cross_pod=True``)
  against the reference's unsharded ``make_train_step``, with the bounds
  of ``tests/test_torch_train.py``: loss 1e-5 and ``grad_norm`` 1e-4
  relative (1e-3 with compression, where a value near a half quantum may
  round either way), ``lr`` exactly; the gathered params and moments
  within 1e-4 of each leaf's largest value on all but 1e-3 of the elements
  (1e-2 with compression) and every element within what one flipped
  rounding can move it (a parameter by 2 lr a step: Adam's first update is
  the sign of a tiny gradient; a moment with compression by a quantum);
  the gradients are summed over the ranks in another order than on one
  device;
* a checkpoint saved from a sharded state: every array equal, byte for
  byte, to an unsharded save of the gathered state.
"""

import functools
import os
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from repro_torch.configs import ARCH_NAMES, get_config, get_smoke
from repro_torch.configs.base import SHAPES
from repro_torch.launch.mesh import (make_mesh, make_production_mesh,
                                     make_smoke_mesh)
from repro_torch.models import build_model, common, mlp, parallel
from repro_torch.models.decoding import cache_specs
from repro_torch.models.sharding import (ShardingPlan, local_block,
                                         resolve_plan)
from repro_torch.models.transformer import RunConfig
from repro_torch.models.weights import (from_reference_params,
                                        gather_params, reference_specs,
                                        shard_params)
from repro_torch.train.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (StepConfig, init_train_state,
                                          make_train_step)

TOL = 1e-4
PROMPT, CACHE_LEN, DECODE_STEPS = 11, 16, 4
MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 2}, {"data": 1, "model": 4}, {"data": 4},
          {"model": 2})
EXPERT_MODES = ("auto", "ep", "tp")

# Sharded serving cases: (arch, data, model, RunConfig fields, expert mode).
# ep_local runs at capacity 100, where nothing drops, so it computes the
# reference's unsharded function; its drops are held below.
SERVING = {
    "qwen3_1x4": ("qwen3-8b", 1, 4, {}, "auto"),
    "qwen3_2x2": ("qwen3-8b", 2, 2, {}, "auto"),
    "smollm_1x2": ("smollm-135m", 1, 2, {}, "auto"),
    "olmoe_sort_1x2": ("olmoe-1b-7b", 1, 2, {"moe_impl": "sort"}, "auto"),
    "olmoe_ep_local_1x2": ("olmoe-1b-7b", 1, 2,
                           {"moe_impl": "ep_local", "moe_capacity": 100.0},
                           "auto"),
    "grok_tp_1x2": ("grok-1-314b", 1, 2, {}, "tp"),
}
# Sharded training cases: (arch, data, model, RunConfig fields, expert
# mode), each trained plain and with accumulation and compression
# (TRAIN_VARIANTS: accum_steps, compress_cross_pod). ep_local at capacity
# 100 computes the reference's unsharded function (nothing drops).
TRAIN = {
    "smollm_1x2": ("smollm-135m", 1, 2, {}, "auto"),
    "smollm_2x1": ("smollm-135m", 2, 1, {}, "auto"),
    "qwen3_2x2": ("qwen3-8b", 2, 2, {}, "auto"),
    "olmoe_sort_1x2": ("olmoe-1b-7b", 1, 2, {"moe_impl": "sort"}, "auto"),
    "olmoe_einsum_1x2": ("olmoe-1b-7b", 1, 2, {"moe_impl": "einsum"},
                         "auto"),
    "olmoe_ep_local_1x2": ("olmoe-1b-7b", 1, 2,
                           {"moe_impl": "ep_local", "moe_capacity": 100.0},
                           "auto"),
    "grok_tp_1x2": ("grok-1-314b", 1, 2, {}, "tp"),
}
TRAIN_VARIANTS = {"plain": (1, False), "accum_compress": (2, True)}
TRAIN_OC = dict(lr=1e-3, warmup_steps=2, total_steps=10)
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 8, 2
EP_TOKENS = 64
EP_CASES = {"1x2": (1, 2), "2x2": (2, 2)}
EP_FACTORS = (100.0, 0.25)
RESTORE_ARCH = "qwen3-8b"


@functools.lru_cache(maxsize=None)
def _ref():
    """The reference's modules (jax), imported on first use."""
    import jax
    import jax.numpy as jnp

    from repro.configs import base, get_config, get_smoke
    from repro.models import RunConfig, build_model, common, mlp, sharding
    from repro.train import checkpoint, optimizer, train_step
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, SHAPES=base.SHAPES, get_config=get_config,
        get_smoke=get_smoke, RunConfig=RunConfig, build_model=build_model,
        common=common, mlp=mlp, sharding=sharding, checkpoint=checkpoint,
        optimizer=optimizer, train_step=train_step)


# -- the plan and the spec trees --------------------------------------------


def _ref_plan(cfg, shape, mesh, mode):
    try:
        return _ref().sharding.resolve_plan(cfg, shape, mesh, mode)
    except ValueError as e:
        return e


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_resolve_plan_matches_reference(arch):
    """Every mesh, shape (and none) and expert mode, on the published and
    the smoke config: the same axes, or the same ValueError."""
    ref = _ref()
    for port_cfg, ref_cfg in ((get_config(arch), ref.get_config(arch)),
                              (get_smoke(arch), ref.get_smoke(arch))):
        for mesh in MESHES:
            for shape in (None,) + tuple(SHAPES):
                for mode in EXPERT_MODES:
                    want = _ref_plan(ref_cfg, shape and ref.SHAPES[shape],
                                     mesh, mode)
                    if isinstance(want, ValueError):
                        with pytest.raises(ValueError, match=str(want)):
                            resolve_plan(port_cfg, shape and SHAPES[shape],
                                         mesh, mode)
                        continue
                    got = resolve_plan(port_cfg, shape and SHAPES[shape],
                                       mesh, mode)
                    assert got.axes == want.axes, (mesh, shape, mode)
                    assert got.active == want.active


def _ref_specs(tree):
    """A reference spec tree as {path tuple: spec tuple}."""
    jax = _ref().jax
    flat = jax.tree_util.tree_leaves_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {tuple(k.key for k in path): tuple(spec) for path, spec in flat}


def _spec_pair(arch, full, mesh, shape=None):
    r = _ref()
    ref_cfg = r.get_config(arch) if full else r.get_smoke(arch)
    cfg = get_config(arch) if full else get_smoke(arch)
    ref = r.build_model(ref_cfg, plan=r.sharding.resolve_plan(
        ref_cfg, shape and r.SHAPES[shape], mesh))
    plan = resolve_plan(cfg, shape and SHAPES[shape], mesh)
    return ref, build_model(cfg, device="meta"), plan


@pytest.mark.parametrize("full", [True, False], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_match_abstract_params(arch, full):
    """Leaf for leaf, at full width on (data 16, model 16) (nothing is
    allocated on either side) and at smoke size on (data 2, model 2)."""
    mesh = MESHES[0] if full else MESHES[2]
    ref, model, plan = _spec_pair(arch, full, mesh,
                                  "decode_32k" if full else None)
    want = _ref_specs(ref.abstract_params()[1])
    assert reference_specs(model, plan) == want
    assert set(model.param_specs(plan)) == {
        n for n, _ in model.named_parameters()}


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k", None])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_cache_specs_match_abstract_caches(arch, shape):
    """Every family's cache specs on the production mesh, for the decode
    shapes (long_500k frees the data axes for the sequence) and none."""
    ref, model, plan = _spec_pair(arch, True, MESHES[0], shape)
    want = _ref_specs(ref.abstract_caches(2, 64)[1])
    assert {(k,): v for k, v in model.cache_specs(plan).items()} == want
    assert cache_specs(model.cfg, plan) == model.cache_specs(plan)


def test_local_block_takes_axes_row_major():
    sizes = {"pod": 2, "data": 2, "model": 3}
    coords = {"pod": 1, "data": 0, "model": 2}
    # ('pod', 'data') row-major: index 1·2 + 0 = 2 of 4 blocks of 8 rows.
    assert local_block((32, 9), (("pod", "data"), "model"), sizes,
                       coords) == (slice(16, 24), slice(6, 9))
    assert local_block((5, 4, 3), (None, "data"), sizes, coords) == (
        slice(0, 5), slice(0, 2), slice(0, 3))
    with pytest.raises(ValueError, match="does not divide"):
        local_block((10,), ("model",), sizes, coords)


def test_build_model_refuses_what_it_cannot_shard():
    cfg = get_smoke("qwen3-8b")
    plan = resolve_plan(cfg, None, {"data": 1, "model": 2})
    with pytest.raises(ValueError, match="both an active plan and a mesh"):
        build_model(cfg, device="meta", plan=plan)
    with pytest.raises(ValueError, match="both an active plan and a mesh"):
        build_model(cfg, device="meta", mesh=object())
    # Every family shards now (ROADMAP 18d-2): each builds its blocks on a
    # model axis of two ranks, as param_specs lays them out.
    from test_torch_sharding_families import check_meta_build_on_mesh
    for arch in ("rwkv6-1.6b", "zamba2-2.7b", "whisper-base",
                 "llama-3.2-vision-90b"):
        check_meta_build_on_mesh(arch, "model")
    # The null plan is the unsharded model.
    model = build_model(cfg, device="meta", plan=ShardingPlan.null())
    assert model.layout is None and not model.plan.active
    # ep_local without a mesh is moe_sort, as in the reference.
    x = torch.randn(1, 7, get_smoke("olmoe-1b-7b").d_model)
    layer = mlp.MoE(get_smoke("olmoe-1b-7b"), torch.Generator().manual_seed(0),
                    torch.float32, "cpu")
    assert torch.equal(
        mlp.moe(layer, x, get_smoke("olmoe-1b-7b"), impl="ep_local"),
        mlp.moe(layer, x, get_smoke("olmoe-1b-7b"), impl="sort"))


def test_matmul_reduce_dtype_bf16_matches_reference_linear():
    jnp, ref_common = _ref().jnp, _ref().common
    rng = np.random.default_rng(0)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 128)) / 16).astype(np.float32)
    xj, wj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    xt = torch.from_numpy(x).bfloat16()
    wt = torch.from_numpy(w).bfloat16()
    try:
        ref_common.set_matmul_reduce_dtype("bf16")
        common.set_matmul_reduce_dtype("bf16")
        want = np.asarray(ref_common.linear(xj, wj).astype(jnp.float32))
        got = common.linear(xt, wt)
        assert common.reduce_dtype(torch.bfloat16) == torch.bfloat16
        assert common.reduce_dtype(torch.float32) == torch.float32
    finally:
        ref_common.set_matmul_reduce_dtype("f32")
        common.set_matmul_reduce_dtype("f32")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    with pytest.raises(ValueError, match="f32 or bf16"):
        common.set_matmul_reduce_dtype("f16")


# -- the reference's side of the spawned cases -----------------------------


def _ref_tree(arch, seed=0):
    """The reference smoke model of ``arch`` (f32 weights from
    ``jax.random``, naive attention) and its params as numpy."""
    r = _ref()
    jmodel = r.build_model(r.get_smoke(arch),
                           plan=r.sharding.ShardingPlan.null(),
                           rc=r.RunConfig(attn_impl="naive",
                                          moe_capacity=100.0),
                           param_dtype=r.jnp.float32)
    params, _ = jmodel.init(r.jax.random.PRNGKey(seed))
    return jmodel, params, r.jax.tree.map(np.asarray, params)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _unflat(arrays):
    tree: dict = {}
    for key in arrays.files if hasattr(arrays, "files") else arrays:
        node = tree
        *path, leaf = key.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = np.asarray(arrays[key])
    return tree


def _serving_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    prompt = rng.integers(2, cfg.vocab_size, (2, PROMPT)).astype(np.int32)
    forced = rng.integers(2, cfg.vocab_size,
                          (DECODE_STEPS, 2)).astype(np.int32)
    return prompt, forced


def _ep_inputs(cfg, seed=7):
    rng = np.random.default_rng(seed)
    d, e = cfg.d_model, cfg.num_experts
    f = cfg.moe_d_ff or cfg.d_ff
    w = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
         "wi": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "wg": rng.standard_normal((e, d, f)) / np.sqrt(d),
         "wo": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.standard_normal((EP_TOKENS, d)).astype(np.float32)
    r = rng.standard_normal((EP_TOKENS, d)).astype(np.float32)
    return w, x, r


def _write_inputs(root):
    """The reference trees of every arch the spawned cases serve, and a
    saved unsharded checkpoint of the restore case."""
    for arch in {c[0] for c in SERVING.values()}:
        _, _, tree = _ref_tree(arch)
        np.savez(os.path.join(root, f"tree_{arch}.npz"), **_flat(tree))
    model = build_model(get_smoke(RESTORE_ARCH), device="cpu",
                        generator=torch.Generator().manual_seed(5))
    state = init_train_state(model, OptConfig())
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for t in list(state.opt.mu.values()) + list(state.opt.nu.values()):
            t.copy_(torch.rand(t.shape, generator=g))
    save_checkpoint(os.path.join(root, "ckpt"), 3, state)


# -- the spawned ranks -------------------------------------------------------


def _serve(arch, axes, fields, mode, root):
    """One sharded serving case on this rank: logits and whole caches."""
    cfg = get_smoke(arch)
    mesh = make_mesh(axes)
    plan = resolve_plan(cfg, None, axes, mode)
    rc = RunConfig(mesh=mesh, **fields)
    with np.load(os.path.join(root, f"tree_{arch}.npz")) as f:
        tree = _unflat(f)
    model = from_reference_params(cfg, shard_params(cfg, tree, plan, mesh),
                                  device="cpu", rc=rc, plan=plan, mesh=mesh)
    out = {"local_numel": sum(p.numel() for p in model.parameters())}
    back = gather_params(model)
    out["gather_err"] = max(float(np.abs(v - _flat(tree)[k]).max())
                            for k, v in _flat(back).items())
    prompt, forced = _serving_inputs(cfg, 1)
    parallel.reset_counts()
    logits, caches = model.prefill(torch.from_numpy(prompt).long(),
                                   cache_len=CACHE_LEN,
                                   cache_dtype=torch.float32)
    out["collectives"] = parallel.snapshot()["all_reduce"]["calls"]
    out["logits_0"] = logits.numpy()
    specs = model.cache_specs()
    for name, c in caches.items():
        out[f"cache_0_{name}"] = model.layout.gather_spec(c, specs[name]
                                                          ).numpy()
    for step, tok in enumerate(forced):
        logits, caches = model.decode_step(torch.from_numpy(tok).long(),
                                           caches, PROMPT + step)
        out[f"logits_{step + 1}"] = logits.numpy()
    for name, c in caches.items():
        out[f"cache_{DECODE_STEPS}_{name}"] = model.layout.gather_spec(
            c, specs[name]).numpy()
    return out


def _ep_local(axes, root):
    """``moe_ep_local`` on this rank at each factor, with gradients."""
    cfg = get_smoke("olmoe-1b-7b")
    mesh = make_mesh(axes)
    plan = resolve_plan(cfg, None, axes)
    layout = parallel.Layout(plan, mesh)
    w, x, r = _ep_inputs(cfg)
    rows = layout.rows(EP_TOKENS)
    out = {}
    for cf in EP_FACTORS:
        ww = types.SimpleNamespace(
            router=torch.from_numpy(w["router"]),
            **{k: layout.local(torch.from_numpy(w[k]),
                               plan.P("experts", None, None)
                               ).requires_grad_(True)
               for k in ("wi", "wg", "wo")})
        xt = torch.from_numpy(x[rows]).requires_grad_(True)
        y = mlp.moe_ep_local(ww, xt, cfg, cf, layout)
        (y * torch.from_numpy(r[rows])).sum().backward()
        out[f"y_{cf}"] = layout.all_gather(y.detach(), ("data",), 0).numpy()
        out[f"dx_{cf}"] = layout.all_gather(xt.grad, ("data",), 0).numpy()
        for k in ("wi", "wg", "wo"):
            g = layout.all_reduce(getattr(ww, k).grad, ("data",))
            out[f"d{k}_{cf}"] = layout.all_gather(g, ("model",), 0).numpy()
    return out


def _train_batch(cfg, step):
    rng = np.random.default_rng([17, step])
    tokens = rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S))
    labels = rng.integers(0, cfg.vocab_size, (TRAIN_B, TRAIN_S))
    labels[rng.random((TRAIN_B, TRAIN_S)) < 0.2] = -1
    return tokens.astype(np.int32), labels.astype(np.int32)


def _train(case, root):
    """One sharded training case on this rank: each variant's metrics and
    the collective counts of its first step, and its state after
    ``TRAIN_STEPS`` steps, gathered; the plain variant's state saved as a
    checkpoint from the shards."""
    arch, data, nmodel, fields, mode = TRAIN[case]
    axes = {"data": data, "model": nmodel}
    cfg = get_smoke(arch)
    mesh = make_mesh(axes)
    plan = resolve_plan(cfg, None, axes, mode)
    rc = RunConfig(mesh=mesh, attn_impl="chunked", **fields)
    with np.load(os.path.join(root, f"tree_{arch}.npz")) as f:
        tree = shard_params(cfg, _unflat(f), plan, mesh)
    out = {}
    for variant, (accum, compress) in TRAIN_VARIANTS.items():
        model = from_reference_params(cfg, tree, device="cpu", rc=rc,
                                      plan=plan, mesh=mesh)
        oc = OptConfig(**TRAIN_OC)
        sc = StepConfig(accum_steps=accum, compress_cross_pod=compress)
        state = init_train_state(model, oc, sc)
        step_fn = make_train_step(model, oc, sc)
        for i in range(TRAIN_STEPS):
            tokens, labels = _train_batch(cfg, i)
            parallel.reset_counts()
            state, m = step_fn(state, {"tokens": torch.from_numpy(tokens),
                                       "labels": torch.from_numpy(labels)})
            if i == 0:
                c = parallel.snapshot()
                out[f"{variant}_counts"] = np.array(
                    [c[k]["calls"] for k in parallel.KINDS])
            for k in ("loss", "grad_norm", "lr"):
                out[f"{variant}_{k}_{i}"] = np.asarray(float(m[k]))
        specs = model.param_specs()
        for part, tensors in (("params", state.params),
                              ("mu", state.opt.mu), ("nu", state.opt.nu)):
            for name, t in tensors.items():
                out[f"{variant}:{part}:{name}"] = model.layout.gather_spec(
                    t.detach(), specs[name]).numpy()
        if variant == "plain":
            out["state_numel"] = np.asarray(sum(
                t.numel() for part in (state.params, state.opt.mu,
                                       state.opt.nu) for t in part.values()))
            save_checkpoint(os.path.join(root, f"ckpt_{case}"), TRAIN_STEPS,
                            state, layout=model.layout)
    return out


def _restore(axes, root):
    """A saved unsharded train state restored onto this rank's blocks."""
    cfg = get_smoke(RESTORE_ARCH)
    mesh = make_mesh(axes)
    plan = resolve_plan(cfg, None, axes)
    model = build_model(cfg, device="cpu", plan=plan, mesh=mesh,
                        generator=torch.Generator().manual_seed(9))
    state = init_train_state(model, OptConfig())
    state, _ = restore_checkpoint(os.path.join(root, "ckpt"), state,
                                  shardings=(plan, mesh))
    out = {"coords": np.array([model.layout.coords[a] for a in axes])}
    for part, tensors in (("params", state.params), ("mu", state.opt.mu),
                          ("nu", state.opt.nu)):
        for name, t in tensors.items():
            out[f"{part}:{name}"] = t.detach().numpy()
    return out


def _worker(rank, world, store, root):
    torch.set_num_threads(1)     # small shapes; the ranks share the cores
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        cases = {}
        for name, (arch, data, model, fields, mode) in SERVING.items():
            if data * model == world:
                cases[f"serve_{name}"] = lambda a=arch, d=data, m=model, \
                    f=fields, e=mode: _serve(a, {"data": d, "model": m},
                                             f, e, root)
        for name, (_, data, model, _, _) in TRAIN.items():
            if data * model == world:
                cases[f"train_{name}"] = lambda c=name: _train(c, root)
        for name, (data, model) in EP_CASES.items():
            if data * model == world:
                axes = {"data": data, "model": model}
                cases[f"ep_{name}"] = lambda a=axes: _ep_local(a, root)
                cases[f"restore_{name}"] = lambda a=axes: _restore(a, root)
        for name, run in cases.items():
            np.savez(os.path.join(root, f"{name}_{rank}.npz"), **run())
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Runs the 2- and 4-rank groups once; their result directory."""
    root = str(tmp_path_factory.mktemp("sharding"))
    _write_inputs(root)
    groups = [tmp.spawn(_worker, args=(world, os.path.join(
        root, f"store{world}"), root), nprocs=world, join=False)
        for world in (2, 4)]
    for group in groups:
        while not group.join():
            pass
    return root


# -- the spawned cases against the reference --------------------------------


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=tol)


@pytest.mark.parametrize("case", list(SERVING))
def test_sharded_serving_matches_unsharded_reference(spawned, case):
    arch, data, model, fields, mode = SERVING[case]
    world = data * model
    jnp = _ref().jnp
    jmodel, params, tree = _ref_tree(arch)
    cfg = get_smoke(arch)
    prompt, forced = _serving_inputs(cfg, 1)
    want, jcaches = jmodel.prefill(params, {"tokens": jnp.asarray(prompt)},
                                   cache_len=CACHE_LEN,
                                   cache_dtype=jnp.float32)
    wants, caches = [want], [jcaches]
    for step, tok in enumerate(forced):
        want, jcaches = jmodel.decode_step(params, jnp.asarray(tok), jcaches,
                                           jnp.int32(PROMPT + step))
        wants.append(want)
    caches.append(jcaches)
    total = sum(v.size for v in _flat(tree).values())
    for rank in range(world):
        got = np.load(os.path.join(spawned, f"serve_{case}_{rank}.npz"))
        # Every rank holds its blocks only, and they gather back whole.
        assert int(got["local_numel"]) < total
        assert float(got["gather_err"]) == 0.0
        assert int(got["collectives"]) > 0
        for step, want in enumerate(wants):
            _close(got[f"logits_{step}"], want)
        for step, jc in zip((0, DECODE_STEPS), caches):
            for name in jc:
                _close(got[f"cache_{step}_{name}"], jc[name])


@functools.lru_cache(maxsize=None)
def _ref_ep_local(cf, data):
    """The reference's moe_ep_local on a one-device mesh (under
    ``jax.set_mesh``), once per data shard of :func:`_ep_inputs`' tokens,
    and its gradient (x, experts) of sum(y · r), summed over the shards:
    (y, dx, {wi, wg, wo: gradient})."""
    r = _ref()
    jax, jnp = r.jax, r.jnp
    cfg = r.get_smoke("olmoe-1b-7b")
    w, x, rr = _ep_inputs(get_smoke("olmoe-1b-7b"))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    plan = r.sharding.resolve_plan(cfg, None, {"data": 1, "model": 1})
    wj = {k: jnp.asarray(v) for k, v in w.items()}

    def loss(wj_, xs, rs):
        y = r.mlp.moe_ep_local(wj_, xs, cfg, cf, plan, mesh)
        return (y * rs).sum(), y

    step = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))
    ys, dxs, dws = [], [], None
    with jax.set_mesh(mesh):
        for xs, rs in zip(np.split(x, data), np.split(rr, data)):
            (_, y), (dw, dx) = step(wj, jnp.asarray(xs), jnp.asarray(rs))
            ys.append(np.asarray(y))
            dxs.append(np.asarray(dx))
            dw = {k: np.asarray(dw[k]) for k in ("wi", "wg", "wo")}
            dws = dw if dws is None else {k: dws[k] + dw[k] for k in dw}
    return np.concatenate(ys), np.concatenate(dxs), dws


def _ep_drops(w, x, cfg, cf, data):
    """Dropped assignments of ep_local at factor ``cf`` (per data shard)
    and of moe_sort over all tokens."""
    logits = x @ w["router"]
    idx = np.argsort(-logits, axis=-1, kind="stable")[:, :cfg.experts_per_tok]

    def drops(ids, c):
        counts = np.bincount(ids.reshape(-1), minlength=cfg.num_experts)
        return int(np.clip(counts - c, 0, None).sum())
    t_loc = x.shape[0] // data
    ep = sum(drops(part, mlp.ep_local_capacity(t_loc, cfg, cf))
             for part in np.split(idx, data))
    return ep, drops(idx, mlp._capacity(x.shape[0], cfg, cf))


@pytest.mark.parametrize("cf", EP_FACTORS)
@pytest.mark.parametrize("case", list(EP_CASES))
def test_moe_ep_local_matches_reference(spawned, case, cf):
    """At 100 (nothing drops) against the reference's moe_sort; at 0.25
    against its moe_ep_local on one device once per data shard, where the
    capacity is per shard and drops differ from moe_sort's."""
    data, model = EP_CASES[case]
    ref = _ref()
    cfg = ref.get_smoke("olmoe-1b-7b")
    w, x, _ = _ep_inputs(get_smoke("olmoe-1b-7b"))
    want, dx, dw = _ref_ep_local(cf, data)
    ep_drops, sort_drops = _ep_drops(w, x, cfg, cf, data)
    if cf == 100.0:
        assert ep_drops == sort_drops == 0
        _close(want, ref.mlp.moe_sort({k: ref.jnp.asarray(v) for k, v in
                                       w.items()}, ref.jnp.asarray(x), cfg,
                                      cf))
    else:
        assert ep_drops > 0 and ep_drops != sort_drops
    for rank in range(data * model):
        got = np.load(os.path.join(spawned, f"ep_{case}_{rank}.npz"))
        _close(got[f"y_{cf}"], want)
        _close(got[f"dx_{cf}"], dx)
        for k in ("wi", "wg", "wo"):
            _close(got[f"d{k}_{cf}"], dw[k])


@pytest.mark.parametrize("case", list(EP_CASES))
def test_restore_lays_out_each_block(spawned, case):
    data, model = EP_CASES[case]
    axes = {"data": data, "model": model}
    with np.load(os.path.join(spawned, "ckpt", "step_00000003",
                              "arrays.npz")) as f:
        saved = {k: f[k] for k in f.files}
    cfg = get_smoke(RESTORE_ARCH)
    plan = resolve_plan(cfg, None, axes)
    meta = build_model(cfg, device="meta")
    specs = meta.param_specs(plan)
    from repro_torch.models.weights import reference_key, reference_path
    prefix = {"params": ".params", "mu": ".opt/.mu", "nu": ".opt/.nu"}
    covered = {}
    for rank in range(data * model):
        got = np.load(os.path.join(spawned, f"restore_{case}_{rank}.npz"))
        coords = dict(zip(axes, got["coords"].tolist()))
        for key in got.files:
            if key == "coords":
                continue
            part, name = key.split(":")
            path, idx = reference_path(name)
            whole = saved[reference_key(prefix[part], path)][idx]
            sl = local_block(whole.shape, specs[name], axes, coords)
            np.testing.assert_array_equal(got[key], whole[sl])
            covered[key] = covered.get(key, 0) + got[key].size
    # Over the ranks, each leaf's blocks cover it once per replica.
    for key, n in covered.items():
        part, name = key.split(":")
        path, idx = reference_path(name)
        size = saved[reference_key(prefix[part], path)][idx].size
        assert n % size == 0 and n >= size


@functools.lru_cache(maxsize=None)
def _ref_train(arch, fields, variant):
    """The reference's unsharded ``make_train_step`` from the same weights:
    each step's (loss, grad_norm, lr) and the final state's flat leaves
    (the checkpoint's keys)."""
    r = _ref()
    jax, jnp = r.jax, r.jnp
    fields = dict(fields)
    if fields.get("moe_impl") == "ep_local":
        fields["moe_impl"] = "sort"   # ep_local without a mesh is sort
    accum, compress = TRAIN_VARIANTS[variant]
    jmodel = r.build_model(r.get_smoke(arch),
                           plan=r.sharding.ShardingPlan.null(),
                           rc=r.RunConfig(attn_impl="chunked", **fields),
                           param_dtype=jnp.float32)
    _, params, _ = _ref_tree(arch)
    oc = r.optimizer.OptConfig(**TRAIN_OC)
    sc = r.train_step.StepConfig(accum_steps=accum,
                                 compress_cross_pod=compress)
    state = r.train_step.TrainState(
        params=params, opt=r.optimizer.opt_init(params, oc),
        err=(jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params)
             if compress else None))
    step = jax.jit(r.train_step.make_train_step(jmodel, oc, sc))
    metrics = []
    cfg = get_smoke(arch)
    for i in range(TRAIN_STEPS):
        tokens, labels = _train_batch(cfg, i)
        state, m = step(state, {"tokens": jnp.asarray(tokens),
                                "labels": jnp.asarray(labels)})
        metrics.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
    keys, vals, _ = r.checkpoint._flatten_with_paths(
        jax.tree.map(np.asarray, state))
    return metrics, dict(zip(keys, vals))


# Collective calls of one plain step (all_reduce, all_gather,
# reduce_scatter), by case, for the smoke smollm-135m (2 layers, tied
# embeddings, one loss chunk). Gathers: the embedding twice (lookup, head)
# and 7 leaves a layer, each reduce-scattered back: 16 and 16. All-reduces
# on (1, 2) (attention replicated, 3 heads; SwiGLU and vocabulary split):
# lookup 1, SwiGLU 1 + 1 a layer (forward, backward), loss chunk 3 twice
# (recomputed) and its hidden states' gradient 1, loss sum and count 2,
# the norms' gradients over data 1, the gradient norm 2 (two sets of
# split axes): 17. On (2, 1) attention is split over model too (a
# one-rank pass-through): + 2 a layer, and the gradient norm needs 1: 20.
TRAIN_COUNTS = {"smollm_1x2": (17, 16, 16), "smollm_2x1": (20, 16, 16)}


def _train_close(got, want, key, bound, share, scale):
    scale = max(1e-3, scale)
    diff = np.abs(np.asarray(got, np.float32) - want)
    assert diff.max() <= bound + 1e-6 * scale, key
    assert (diff > 1e-4 * scale).mean() <= share, key


@pytest.mark.parametrize("variant", list(TRAIN_VARIANTS))
@pytest.mark.parametrize("case", list(TRAIN))
def test_sharded_train_step_matches_unsharded_reference(spawned, case,
                                                        variant):
    """Loss, grad_norm and lr of each step, and the params and moments
    after the last, gathered on every rank, against the reference's
    unsharded step; the collective counts of one step pinned where
    ``TRAIN_COUNTS`` gives them, and the same on every rank."""
    from repro_torch.models.weights import reference_key, reference_path

    arch, data, nmodel, fields, _ = TRAIN[case]
    world = data * nmodel
    metrics, want = _ref_train(arch, tuple(sorted(fields.items())), variant)
    compress = TRAIN_VARIANTS[variant][1]
    prefix = {"params": ".params", "mu": ".opt/.mu", "nu": ".opt/.nu"}
    lr_sum = sum(m["lr"] for m in metrics)
    counts = None
    for rank in range(world):
        got = np.load(os.path.join(spawned, f"train_{case}_{rank}.npz"))
        for i, m in enumerate(metrics):
            assert abs(float(got[f"{variant}_loss_{i}"]) - m["loss"]) <= \
                1e-5 * abs(m["loss"]), (rank, i)
            gtol = 1e-3 if compress else 1e-4
            assert abs(float(got[f"{variant}_grad_norm_{i}"])
                       - m["grad_norm"]) <= gtol * m["grad_norm"], (rank, i)
            assert float(got[f"{variant}_lr_{i}"]) == m["lr"]
        c = tuple(int(n) for n in got[f"{variant}_counts"])
        assert counts is None or c == counts
        counts = c
        n_keys = 0
        for key in got.files:
            if not key.startswith(variant + ":"):
                continue
            _, part, name = key.split(":")
            path, idx = reference_path(name)
            w = want[reference_key(prefix[part], path)][idx]
            bound = 2.0 * lr_sum * 1.001 if part == "params" else (
                max(1e-3, float(np.abs(w).max())) * (2.0 if compress
                                                     else 1e-4))
            _train_close(got[key], w, key, bound,
                         share=1e-2 if compress else 1e-3,
                         scale=float(np.abs(w).max()))
            n_keys += 1
        assert n_keys == 3 * len(dict(build_model(
            get_smoke(arch), device="meta").named_parameters()))
    if variant == "plain" and case in TRAIN_COUNTS:
        assert counts == TRAIN_COUNTS[case], counts


@pytest.mark.parametrize("case", ["smollm_2x1", "qwen3_2x2"])
def test_sharded_checkpoint_equals_unsharded_save(spawned, case, tmp_path):
    """The plain variant's checkpoint, saved from the shards (rank 0
    writes the gathered leaves): the reference's ``restore_checkpoint``
    and an unsharded port model take it, every array equals an unsharded
    save of the same (gathered) state byte for byte, and a rank held less
    than the whole state."""
    r = _ref()
    arch = TRAIN[case][0]
    cfg = get_smoke(arch)
    path = os.path.join(spawned, f"ckpt_{case}")
    got = np.load(os.path.join(spawned, f"train_{case}_0.npz"))
    model = build_model(cfg, device="cpu")
    state = init_train_state(model, OptConfig(**TRAIN_OC))
    state, manifest = restore_checkpoint(path, state)
    assert manifest["step"] == TRAIN_STEPS == state.opt.step
    whole = 0
    with torch.no_grad():
        for part, tensors in (("params", state.params),
                              ("mu", state.opt.mu), ("nu", state.opt.nu)):
            for name, t in tensors.items():
                np.testing.assert_array_equal(t.numpy(),
                                              got[f"plain:{part}:{name}"])
                t.copy_(torch.from_numpy(got[f"plain:{part}:{name}"]))
                whole += t.numel()
    assert int(got["state_numel"]) < whole
    save_checkpoint(tmp_path / "whole", TRAIN_STEPS, state)
    import json
    sharded, plain = (json.loads((p / f"step_{TRAIN_STEPS:08d}" /
                                  "manifest.json").read_text())
                      for p in (Path(path), tmp_path / "whole"))
    assert sharded == plain
    with np.load(Path(path) / f"step_{TRAIN_STEPS:08d}" / "arrays.npz") as a, \
            np.load(tmp_path / "whole" / f"step_{TRAIN_STEPS:08d}" /
                    "arrays.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes(), k
    jmodel = r.build_model(r.get_smoke(arch),
                           plan=r.sharding.ShardingPlan.null(),
                           param_dtype=r.jnp.float32)
    template = r.train_step.init_train_state(
        jmodel, r.jax.random.PRNGKey(0), r.optimizer.OptConfig())
    _, ref_manifest = r.checkpoint.restore_checkpoint(path, template)
    assert ref_manifest["step"] == TRAIN_STEPS


def test_sharded_training_refuses_the_other_families():
    """The four other families train on a mesh since 18d-2 (held to the
    reference in ``tests/test_torch_sharding_families.py``): a mesh in
    their RunConfig is accepted and each builds its ZeRO blocks on a data
    axis of two ranks, as param_specs lays them out."""
    from test_torch_sharding_families import check_meta_build_on_mesh
    for arch in ("rwkv6-1.6b", "zamba2-2.7b", "whisper-base",
                 "llama-3.2-vision-90b"):
        cfg = get_smoke(arch)
        RunConfig(mesh=object()).check(cfg.family)
        check_meta_build_on_mesh(arch, "data", coord=0)


# -- one rank, in this process ------------------------------------------------


@pytest.fixture
def world_one(tmp_path):
    if dist.is_initialized():
        pytest.skip("a process group is already initialised here")
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield tmp_path
    finally:
        dist.destroy_process_group()


def test_one_rank_mesh_is_bit_equal(world_one):
    """On a (1, 1) mesh the sort path gives the unsharded logits bit for
    bit (every collective a counted pass-through), a restore with
    shardings is bit-equal to one without (the port of the reference's
    elastic restore test), and the production mesh refuses this world."""
    axes = {"data": 1, "model": 1}
    mesh = make_mesh(axes)
    assert make_smoke_mesh().mesh_dim_names == ("data",)
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh()
    cfg = get_smoke("olmoe-1b-7b")
    plan = resolve_plan(cfg, None, axes)
    gen = torch.Generator().manual_seed(4)
    sharded = build_model(cfg, device="cpu", plan=plan, mesh=mesh,
                          generator=gen, rc=RunConfig(mesh=mesh))
    plain = build_model(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(4))
    prompt, forced = _serving_inputs(cfg, 2)
    parallel.reset_counts()
    a, ca = sharded.prefill(torch.from_numpy(prompt).long(), cache_len=16)
    counts = parallel.snapshot()
    b, cb = plain.prefill(torch.from_numpy(prompt).long(), cache_len=16)
    assert torch.equal(a, b) and counts["all_reduce"]["calls"] > 0
    a, _ = sharded.decode_step(torch.from_numpy(forced[0]).long(), ca, 11)
    b, _ = plain.decode_step(torch.from_numpy(forced[0]).long(), cb, 11)
    assert torch.equal(a, b)

    state = init_train_state(plain, OptConfig())
    save_checkpoint(world_one / "ckpt", 7, state)
    want = {k: v.detach().clone() for k, v in state.params.items()}
    template = init_train_state(sharded, OptConfig())
    restored, _ = restore_checkpoint(world_one / "ckpt", template,
                                     shardings=(plan, mesh))
    for name, t in restored.params.items():
        assert torch.equal(t, want[name]), name


def test_kv_heads_follow_global_q_heads():
    """Q heads split, kv heads whole: each local q head reads the kv head
    of its global index, a contiguous range where the rank's q heads take
    the kv heads evenly (qwen3's case), else one kv head a q head."""
    from repro_torch.models.attention import _kv_for_heads

    class Rank:
        def __init__(self, i):
            self.i = i

        def axes(self, logical):
            return ("model",)

        def index(self, axes):
            return self.i

    cfg = types.SimpleNamespace(num_heads=12, num_kv_heads=4)
    k = torch.arange(4.0).reshape(1, 1, 4, 1)
    # 4 q heads a rank, groups of 3: rank 0 reads kv 0, 0, 0, 1.
    got, _ = _kv_for_heads(k, k, cfg, Rank(0), 4)
    assert got.flatten().tolist() == [0.0, 0.0, 0.0, 1.0]
    # 6 q heads a rank: rank 1 holds q heads 6-11, kv heads 2 and 3.
    got, _ = _kv_for_heads(k, k, cfg, Rank(1), 6)
    assert got.flatten().tolist() == [2.0, 3.0]
    # Unsharded, or kv split alike: as given.
    assert _kv_for_heads(k, k, cfg, None, 12)[0] is k
    assert _kv_for_heads(k[:, :, :2], k, cfg, Rank(1), 6)[0].shape[2] == 2


@pytest.mark.parametrize("arch", ["smollm-135m", "olmoe-1b-7b"])
def test_one_rank_train_step_is_bit_equal(world_one, arch):
    """On a (1, 1) mesh the sharded train step forms the unsharded one's
    operations (the vocabulary-parallel loss is ``torch.logsumexp``'s
    arithmetic over one rank; every collective a counted pass-through):
    with accumulation and compression, two steps give the same loss,
    grad_norm, parameters and moments bit for bit, and a checkpoint saved
    from the shards holds the unsharded save's arrays."""
    # One thread: the CPU's multithreaded index and scatter gradients add
    # in a varying order, so two unsharded runs could differ.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _one_rank_train_step(world_one, arch)
    finally:
        torch.set_num_threads(threads)


def _one_rank_train_step(world_one, arch):
    axes = {"data": 1, "model": 1}
    mesh = make_mesh(axes)
    cfg = get_smoke(arch)
    plan = resolve_plan(cfg, None, axes)
    oc = OptConfig(**TRAIN_OC)
    sc = StepConfig(accum_steps=2, compress_cross_pod=True)
    runs = []
    for sharded in (False, True):
        kw = dict(plan=plan, mesh=mesh) if sharded else {}
        model = build_model(cfg, device="cpu", rc=RunConfig(
            attn_impl="chunked", loss_chunk=4),
            generator=torch.Generator().manual_seed(3), **kw)
        state = init_train_state(model, oc, sc)
        step_fn = make_train_step(model, oc, sc)
        metrics = []
        parallel.reset_counts()
        for i in range(TRAIN_STEPS):
            tokens, labels = _train_batch(cfg, i)
            state, m = step_fn(state, {"tokens": torch.from_numpy(tokens),
                                       "labels": torch.from_numpy(labels)})
            metrics.append([float(m[k]) for k in ("loss", "grad_norm")])
        counts = parallel.snapshot()
        save_checkpoint(world_one / f"ckpt_{sharded}", TRAIN_STEPS, state,
                        layout=model.layout)
        runs.append((metrics, state, counts))
    (want, plain, none), (got, state, counts) = runs
    assert got == want
    assert all(v["calls"] == 0 for v in none.values())
    assert all(counts[k]["calls"] > 0 for k in parallel.KINDS)
    for part in ("params", "err"):
        for name, t in getattr(state, part).items():
            assert torch.equal(t, getattr(plain, part)[name]), (part, name)
    for part in ("mu", "nu"):
        for name, t in getattr(state.opt, part).items():
            assert torch.equal(t, getattr(plain.opt, part)[name]), name
    with np.load(world_one / "ckpt_True" / "step_00000002" / "arrays.npz") \
            as a, np.load(world_one / "ckpt_False" / "step_00000002" /
                          "arrays.npz") as b:
        assert a.files == b.files
        assert all(a[k].tobytes() == b[k].tobytes() for k in a.files)


def test_opt_state_specs_mirror_the_parameters():
    """The moments take their parameter's spec and the step is replicated,
    as the reference's ``opt_state_specs`` lays out its state."""
    from repro_torch.train.optimizer import opt_state_specs

    r = _ref()
    cfg = get_smoke("qwen3-8b")
    axes = {"data": 2, "model": 2}
    model = build_model(cfg, device="meta")
    specs = model.param_specs(resolve_plan(cfg, None, axes))
    got = opt_state_specs(specs)
    assert got.mu == specs and got.nu == specs and got.step == ()
    assert got.mu is not specs
    jcfg = r.get_smoke("qwen3-8b")
    jmodel = r.build_model(jcfg, plan=r.sharding.resolve_plan(jcfg, None,
                                                              axes))
    want = r.optimizer.opt_state_specs(jmodel.abstract_params()[1])
    assert tuple(want.step) == got.step
    assert _ref_specs(want.mu) == reference_specs(
        model, resolve_plan(cfg, None, axes))
