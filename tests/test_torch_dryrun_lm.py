"""The LM dry run and sweep (``repro_torch.launch.{dryrun,sweep}``, the
abstract trees of ``models/model.py`` and ``train/train_step.py``, the
stand-in mesh) against the reference, on the CPU.

Every comparison is exact (``==``): the grid of cells; for all ten archs
at bf16 the global param bytes, the cache bytes at (128, 32,768), the
AdamW state bytes under the reference's ``POLICY``, the inputs' shapes and
dtypes, the plan on both production meshes and the accumulation clamp; a
rank's blocks on the 16 × 16 and 2 × 16 × 16 stand-in meshes, which a meta
build on that mesh holds; and the collective calls and bytes of the meta
train step on (1, 2) and (2, 1), rank by rank, against a live two-rank
gloo run of the same step (smoke smollm-135m plain, with accumulation and
compression, with remat; smoke olmoe-1b-7b with ``sort`` and
``ep_local``). The live ranks are spawned processes that import this
module, whose reference imports are made inside the tests, so they load
no jax. The reference's ``repro/launch/dryrun.py`` is read as source, not
imported: it sets ``XLA_FLAGS`` for 512 devices at import.
"""

import ast
import functools
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from repro_torch.configs import (ARCH_NAMES, SHAPES, all_cells, get_config,
                                 get_smoke, supports_shape)
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import dryrun, sweep
from repro_torch.launch.mesh import (PRODUCTION_AXES, StandinMesh, make_mesh,
                                     standin_mesh)
from repro_torch.models import build_model, decoding, mlp, parallel
from repro_torch.models.model import tree_bytes
from repro_torch.models.parallel import Layout
from repro_torch.models.sharding import local_block, resolve_plan
from repro_torch.models.transformer import RunConfig
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (StepConfig, abstract_train_state,
                                          init_train_state, make_train_step)

BF16 = torch.bfloat16
CACHE = (128, 32_768)
MESHES = {"pod1": PRODUCTION_AXES[False], "pod2": PRODUCTION_AXES[True]}
# A rank far from the first on each production mesh.
LAST = {"pod1": {"data": 15, "model": 13},
        "pod2": {"pod": 1, "data": 14, "model": 15}}


# -- the reference, read once per arch ----------------------------------------


@functools.lru_cache(maxsize=None)
def _ref_source() -> ast.Module:
    import repro.configs
    return ast.parse((Path(repro.configs.__file__).parents[1] / "launch"
                      / "dryrun.py").read_text())


@functools.lru_cache(maxsize=None)
def _ref_policy() -> dict:
    """The reference's POLICY, evaluated from its source."""
    for node in _ref_source().body:
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", None) == "POLICY":
            return eval(compile(ast.Expression(node.value), "dryrun.py",
                                "eval"), {"dict": dict})
    raise AssertionError("no POLICY in the reference's dry run")


@functools.lru_cache(maxsize=None)
def _ref_result_keys():
    """The keys the reference's ``run_cell`` writes into its result (an
    ``ok`` cell) and into its ``memory``, read from its source."""
    fn = next(n for n in _ref_source().body
              if isinstance(n, ast.FunctionDef) and n.name == "run_cell")
    keys, memory = set(), set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and getattr(
                node.targets[0], "id", None) == "result":
            keys |= {k.value for k in node.value.keys}
        elif isinstance(node, ast.Subscript) and getattr(
                node.value, "id", None) == "result" and isinstance(
                node.ctx, ast.Store):
            keys.add(node.slice.value)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", None) == "update":
            for kw in node.keywords:
                keys.add(kw.arg)
                if kw.arg == "memory":
                    memory = {k.arg for k in kw.value.keywords}
    return keys, memory


def _sds_bytes(tree) -> int:
    import jax
    return sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(tree))


@functools.lru_cache(maxsize=None)
def _ref_arch(arch):
    """The reference's bytes (params, cache, AdamW state under POLICY) and
    input specs of every shape, for ``arch`` at bf16."""
    import jax.numpy as jnp

    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_config
    from repro.models import build_model as ref_build
    from repro.train.optimizer import OptConfig as RefOpt
    from repro.train.train_step import StepConfig as RefStep
    from repro.train.train_step import abstract_train_state as ref_state

    pol = _ref_policy()[arch]
    model = ref_build(ref_config(arch), param_dtype=jnp.bfloat16)
    state, _ = ref_state(model, RefOpt(state_dtype=pol["state_dtype"]),
                         RefStep())
    caches, _ = model.abstract_caches(*CACHE)
    inputs = {s: {k: (tuple(v.shape), str(v.dtype)) for k, v in
                  model.input_specs(REF_SHAPES[s]).items()}
              for s in REF_SHAPES}
    shardings = {s: model.input_shardings(REF_SHAPES[s]) for s in REF_SHAPES}
    return {"params": _sds_bytes(state.params),
            "opt": _sds_bytes(state.opt.mu) * 2,
            "cache": _sds_bytes(caches), "inputs": inputs,
            "shardings": shardings}


def _ref_plan(arch, shape, axes):
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_config
    from repro.models.sharding import resolve_plan as ref_resolve
    return ref_resolve(ref_config(arch), REF_SHAPES[shape], dict(axes))


# -- the grid, the trees, the plans --------------------------------------------


def test_all_cells_equal_the_reference():
    from repro.configs import all_cells as ref_cells
    cells = all_cells()
    assert cells == ref_cells()
    assert len(cells) == 40 and sum(c[2] for c in cells) == 32


def test_policy_is_the_reference_policy():
    assert dryrun.POLICY == _ref_policy()


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_abstract_trees_equal_the_reference(arch):
    """Global param, cache and AdamW state bytes at bf16, and every
    shape's inputs (keys, shapes, dtypes, specs)."""
    want = _ref_arch(arch)
    model = build_model(get_config(arch), device="meta", dtype=BF16)
    assert tree_bytes(model.abstract_params().whole) == want["params"]
    assert tree_bytes(model.abstract_caches(*CACHE).whole) == want["cache"]
    pol = dryrun.POLICY[arch]
    state = abstract_train_state(model, OptConfig(
        state_dtype=pol["state_dtype"]))
    assert tree_bytes(state.whole.opt.mu) * 2 == want["opt"]
    assert tree_bytes(state.whole.params) == want["params"]
    assert state.whole.err is None and state.specs.err is None
    for s, shape in SHAPES.items():
        tree = model.input_specs(shape)
        got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
               for k, v in tree.whole.items()}
        assert got == want["inputs"][s], s
        assert tree.specs == {k: tuple(v) for k, v in
                              want["shardings"][s].items()}, s


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_plans_and_accumulation_clamp_equal_the_reference(arch):
    """The plan of every shape on both production meshes, and the
    reference's clamp of its POLICY accumulation on train_4k."""
    cfg = get_config(arch)
    for name, axes in MESHES.items():
        for s, shape in SHAPES.items():
            want = _ref_plan(arch, s, axes)
            got = resolve_plan(cfg, shape, dict(axes))
            assert got.axes == want.axes, (name, s)
        want = _ref_plan(arch, "train_4k", axes)
        span = 1
        b_ax = want.axes.get("batch")
        for a in ((b_ax,) if isinstance(b_ax, str) else (b_ax or ())):
            span *= axes[a]
        accum = _ref_policy()[arch]["accum"]
        while accum > 1 and (256 // accum) % span != 0:
            accum //= 2
        assert dryrun.clamp_accum(dryrun.POLICY[arch]["accum"], 256,
                                  resolve_plan(cfg, SHAPES["train_4k"],
                                               dict(axes)), axes) == accum


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_rank_blocks_on_the_production_mesh(arch, mesh_name):
    """On the stand-in production mesh, at a rank far from the first: a
    meta build holds ``local_block`` of every whole weight, the abstract
    params' and train state's blocks; ``init_caches`` the abstract
    caches' blocks."""
    axes, coords = MESHES[mesh_name], LAST[mesh_name]
    cfg = get_config(arch)
    shape = SHAPES["decode_32k"]
    mesh = standin_mesh(axes, coords)
    model = build_model(cfg, device="meta", dtype=BF16, plan=resolve_plan(
        cfg, shape, dict(axes)), mesh=mesh)
    assert model.layout.standin and model.layout.coords == coords
    tree = model.abstract_params(mesh=mesh)
    whole = dict(build_model(cfg, device="meta",
                             dtype=BF16).named_parameters())
    split = 0
    for n, p in model.named_parameters():
        block = local_block(whole[n].shape, tree.specs[n], axes, coords)
        want = tuple(sl.stop - sl.start for sl in block)
        assert tuple(p.shape) == tuple(tree.local[n].shape) == want, n
        assert tuple(tree.whole[n].shape) == tuple(whole[n].shape), n
        split += want != tuple(whole[n].shape)
    assert split > 0
    state = abstract_train_state(model, OptConfig(), mesh=mesh)
    assert {n: t.shape for n, t in state.local.opt.nu.items()} == \
        {n: t.shape for n, t in tree.local.items()}
    caches = model.abstract_caches(shape.global_batch, shape.seq_len,
                                   mesh=mesh)
    live = decoding.init_caches(cfg, shape.global_batch, shape.seq_len,
                                device="meta", layout=model.layout)
    assert {n: (t.shape, t.dtype) for n, t in live.items()} == \
        {n: (t.shape, t.dtype) for n, t in caches.local.items()}


# -- the stand-in mesh and the meta forms ---------------------------------------


def test_standin_layout_makes_no_group_and_counts_as_a_live_rank():
    """No process group is initialised here: a Layout on the stand-in
    mesh makes none, each collective returns a live rank's shape and
    counts the same bytes, and a tensor off the meta device is
    refused."""
    assert not dist.is_initialized()
    mesh = standin_mesh(PRODUCTION_AXES[True], {"pod": 1, "data": 2,
                                                "model": 3})
    assert isinstance(mesh, StandinMesh)
    with pytest.raises(RuntimeError, match="no process groups"):
        mesh.get_group("data")
    with pytest.raises(ValueError, match="not a rank"):
        standin_mesh({"data": 2}, {"data": 2})
    cfg = get_smoke("qwen3-8b")
    layout = Layout(resolve_plan(cfg, None, PRODUCTION_AXES[True]), mesh)
    x = torch.empty((4, 32, 6), device="meta")
    parallel.reset_counts()
    assert layout.all_reduce(x, ("model",)).shape == x.shape
    assert layout.all_gather(x, ("pod", "data"), 1).shape == (4, 1024, 6)
    assert layout.reduce_scatter(x, ("data",), 1).shape == (4, 2, 6)
    assert layout.all_reduce(x, ()) is x
    with pytest.raises(ValueError, match="does not divide"):
        layout.reduce_scatter(x, ("data",), 2)
    nbytes = x.numel() * 4
    assert parallel.snapshot() == {
        "all_reduce": {"calls": 2, "bytes": 2 * nbytes},
        "all_gather": {"calls": 1, "bytes": nbytes},
        "reduce_scatter": {"calls": 2, "bytes": 2 * nbytes}}
    for kind, call in (("all_reduce", lambda t: layout.all_reduce(
            t, ("model",))), ("all_gather", lambda t: layout.all_gather(
            t, ("data",), 0)), ("reduce_scatter",
                                lambda t: layout.reduce_scatter(
                                    t, ("data",), 0))):
        with pytest.raises(ValueError, match=f"{kind} on a stand-in mesh"):
            call(torch.zeros(32, 2))


def test_b4_meta_form_counts_apart_from_real_launches():
    """Kernel B4 on meta tensors: the card's checks, an empty output of
    q's shape, one meta launch; the real launch count and the CPU's plain
    version are untouched."""
    fa.reset_launch_counts()
    q = torch.empty((1, 8, 16, 64), device="meta")
    k = torch.empty((1, 2, 16, 64), device="meta")
    o = fa.flash_attention(q, k, torch.empty_like(k))
    assert o.device.type == "meta" and o.shape == q.shape
    assert fa.meta_launches["flash_attention"] == 1
    assert fa.launches["flash_attention"] == 0 and not fa.instance_launches
    with pytest.raises(ValueError, match="no kernel instance"):
        fa.flash_attention(torch.empty((1, 2, 4, 48), device="meta"),
                           torch.empty((1, 2, 4, 48), device="meta"),
                           torch.empty((1, 2, 4, 48), device="meta"))
    with pytest.raises(ValueError, match="q on meta"):
        fa.flash_attention(q, torch.zeros(1, 2, 16, 64),
                           torch.zeros(1, 2, 16, 64))
    g = torch.Generator().manual_seed(0)
    qc = torch.randn((1, 2, 8, 48), generator=g)
    kc = torch.randn((1, 2, 8, 48), generator=g)
    got = fa.flash_attention(qc, kc, kc)
    assert torch.equal(got, fa._ref.attention_ref(qc, kc, kc, causal=True))
    assert fa.meta_launches["flash_attention"] == 1
    fa.reset_launch_counts()
    assert fa.meta_launches["flash_attention"] == 0


def test_expert_counts_are_bincount_off_the_meta_device():
    e = torch.tensor([0, 3, 3, 1, 0, 3])
    assert torch.equal(mlp._expert_counts(e, 5), torch.bincount(e,
                                                                minlength=5))
    m = mlp._expert_counts(e.to("meta"), 5)
    assert m.device.type == "meta" and m.shape == (5,)


# -- run_cell and the sweep -------------------------------------------------------


def _port_keys():
    keys, memory = _ref_result_keys()
    return (keys - {"lower_s", "compile_s"}) | {"meta_step_s",
                                                "b4_launches"}, memory


@pytest.mark.parametrize("shape", list(SHAPES))
def test_run_cell_keeps_the_reference_keys(shape):
    res = dryrun.run_cell("smollm-135m", shape)
    if shape == "long_500k":
        assert res == {"arch": "smollm-135m", "shape": shape,
                       "multi_pod": False, "status": "skipped",
                       "reason": supports_shape(get_config("smollm-135m"),
                                                SHAPES[shape])[1]}
        return
    keys, memory = _port_keys()
    assert res["status"] == "ok" and set(res) == keys
    assert set(res["memory"]) == memory
    m = res["memory"]
    assert m["temp_bytes"] is None
    assert m["per_device_total"] == (m["argument_bytes"] + m["output_bytes"]
                                     - m["alias_bytes"])
    coll = res["collectives"]
    assert set(coll["counts"]) == set(parallel.KINDS)
    assert res["roofline"]["collective_bytes"] == sum(
        coll["bytes"].values()) * 256
    assert res["roofline"]["hlo_flops_raw"] is None
    assert res["chips"] == 256 and res["accum"] == 1
    # B4 runs its meta form once an attention layer a prefill; training
    # takes chunked attention and decode its own.
    assert res["b4_launches"] == (30 if shape == "prefill_32k" else 0)
    if shape == "train_4k":
        assert m["alias_bytes"] > 0 and m["output_bytes"] == \
            m["alias_bytes"] + 12


def test_run_cell_grok_train_on_two_pods():
    """grok-1-314b train_4k on (pod 2, data 16, model 16), sized for the
    first rank: bf16 moments and accumulator as POLICY has them, 2
    microbatches (POLICY's 16 clamps to 8, which test_plans_and_
    accumulation_clamp_equal_the_reference holds; each costs ~4 s of
    meta ops here)."""
    res = dryrun.run_cell("grok-1-314b", "train_4k", multi_pod=True,
                          accum=2)
    keys, memory = _port_keys()
    assert res["status"] == "ok" and set(res) == keys
    assert res["chips"] == 512 and res["accum"] == 2
    assert res["param_bytes"] == _ref_arch("grok-1-314b")["params"]
    assert res["opt_bytes"] == _ref_arch("grok-1-314b")["opt"]
    assert res["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")


def test_sweep_runs_a_cell_in_a_subprocess_and_summarizes(tmp_path,
                                                          monkeypatch,
                                                          capsys):
    monkeypatch.setattr(sweep, "ART", tmp_path / "dryrun_torch")
    res = sweep.run_sweep((False,), only_arch="smollm-135m",
                          only_shape="decode_32k")
    assert [r["status"] for r in res] == ["ok"]
    path = sweep.cell_path("smollm-135m", "decode_32k", False)
    assert path.exists() and json_status(path) == "ok"
    skipped = dryrun.run_cell("qwen3-8b", "long_500k", multi_pod=True)
    lines = sweep.summarize(sweep.load_all() + [skipped]).splitlines()
    assert len(lines) == 4
    assert lines[2].startswith("| qwen3-8b | long_500k | 2x16x16 | skipped")
    assert lines[3].startswith("| smollm-135m | decode_32k | 16x16 | ok |")
    capsys.readouterr()
    sweep.main(["--summarize"])
    assert capsys.readouterr().out.strip() == sweep.summarize(
        sweep.load_all())


def json_status(path) -> str:
    import json
    return json.loads(Path(path).read_text())["status"]


# -- the meta step's collectives against a live gloo run -------------------------

# (arch, RunConfig fields, accum_steps, compress_cross_pod, remat).
LIVE_CASES = {
    "smollm": ("smollm-135m", {}, 1, False, False),
    "smollm_accum_compress": ("smollm-135m", {}, 2, True, False),
    "smollm_remat": ("smollm-135m", {}, 1, False, True),
    "olmoe_sort": ("olmoe-1b-7b", {"moe_impl": "sort"}, 1, False, False),
    "olmoe_ep_local": ("olmoe-1b-7b", {"moe_impl": "ep_local"}, 1, False,
                       False),
}
LIVE_MESHES = ((1, 2), (2, 1))
LIVE_B, LIVE_S = 4, 8


def _live_rc(fields, remat, mesh):
    return RunConfig(attn_impl="chunked", remat=remat,
                     mesh=mesh if fields.get("moe_impl") == "ep_local"
                     else None, **fields)


def _live_worker(rank, world, store, root):
    """One rank of a two-rank gloo group: each case's train step on each
    mesh, its collective counts and coordinates to a file."""
    torch.set_num_threads(1)     # small shapes; the ranks share the cores
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        out = {}
        for data, nmodel in LIVE_MESHES:
            axes = {"data": data, "model": nmodel}
            mesh = make_mesh(axes)
            for name, (arch, fields, accum, compress, remat) in \
                    LIVE_CASES.items():
                cfg = get_smoke(arch)
                model = build_model(
                    cfg, device="cpu", plan=resolve_plan(cfg, None, axes),
                    mesh=mesh, rc=_live_rc(fields, remat, mesh),
                    generator=torch.Generator().manual_seed(3))
                sc = StepConfig(accum_steps=accum, compress_cross_pod=compress)
                state = init_train_state(model, OptConfig(), sc)
                step = make_train_step(model, OptConfig(), sc)
                rng = np.random.default_rng(5)
                batch = {k: torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, (LIVE_B, LIVE_S)).astype(np.int32))
                    for k in ("tokens", "labels")}
                parallel.reset_counts()
                step(state, batch)
                out[f"{name}_{data}x{nmodel}"] = (dict(model.layout.coords),
                                                  parallel.snapshot())
        torch.save(out, os.path.join(root, f"live_{rank}.pt"))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    """The two ranks' records, by rank."""
    root = str(tmp_path_factory.mktemp("dryrun_live"))
    tmp.spawn(_live_worker, args=(2, os.path.join(root, "store"), root),
              nprocs=2, join=True)
    return [torch.load(os.path.join(root, f"live_{r}.pt")) for r in (0, 1)]


@pytest.mark.parametrize("mesh", LIVE_MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("case", list(LIVE_CASES))
def test_meta_step_counts_equal_a_live_gloo_run(live, case, mesh):
    arch, fields, accum, compress, remat = LIVE_CASES[case]
    axes = {"data": mesh[0], "model": mesh[1]}
    for rank, rec in enumerate(live):
        coords, want = rec[f"{case}_{mesh[0]}x{mesh[1]}"]
        got = dryrun.count_train_step(
            get_smoke(arch), axes, LIVE_B, LIVE_S, coords=coords,
            rc=_live_rc(fields, remat, None),
            sc=StepConfig(accum_steps=accum, compress_cross_pod=compress))
        counted = {k: {"calls": got["collectives"]["counts"][k],
                       "bytes": got["collectives"]["bytes"][k]}
                   for k in parallel.KINDS}
        assert counted == want, (rank, coords)
        assert want["all_reduce"]["calls"] > 0
