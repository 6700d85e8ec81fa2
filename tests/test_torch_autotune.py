"""The port's launch-plan autotuner and ELL roofline, on the CPU.

* ``batch_tier`` equals the reference's; the candidate set (default first,
  clamped rows-per-block caps, duplicates of one plan dropped);
* ``TuningCache``: save/load round trip, stale entries ignored for each of
  its four invalidation fields, corrupt files ignored, the port's own env
  var;
* ``resolve_plans`` untuned is None; the program key carries the tuned
  plans and keeps its untuned form otherwise; the cost model's probe
  resolves plans as a run does;
* ``ClusterBatcher.warmup(autotune=True)`` on ``device="cpu"`` fills the
  cache and a second cache loaded from its file makes zero sweeps;
* served results with a tuned cache equal the untuned ones on the sync,
  async and sharded (two ``"cpu"`` devices) executors;
* the ELL roofline: the reference's model tests, and ``ell_kernel_bytes``
  as the kernel table's B1/B2 bound (0.1286 / 0.1277 ms at
  (768, 4096, 32)).

On the CPU the plain versions run whatever the plan, so results compare
the plumbing (resolution, keys, plans built at every launch shape);
``tests/test_torch_cuda.py`` holds every candidate plan to the plain
version on the card. Every output compared is an integer: equality is
exact.
"""

import json
import os

import numpy as np
import pytest

from repro.kernels import autotune as ref_at
from repro.launch import roofline as ref_roofline
from repro_torch.core import (ShardedExecutor, build_graph,
                              correlation_cluster_batch, executor)
from repro_torch.core import rng as trng
from repro_torch.core.api import sample_keys
from repro_torch.core.graph import random_arboric
from repro_torch.core.plan import pack_bucket, plan_graph
from repro_torch.kernels import autotune as at
from repro_torch.kernels import neighbor_min as nm
from repro_torch.kernels.measure import bound_ms, bytes_and_ops
from repro_torch.launch.roofline import (ELL_KERNELS, ell_kernel_bytes,
                                         ell_kernel_flops,
                                         ell_kernel_roofline)
from repro_torch.serve import ClusterBatcher, ClusterRequest, serve_all

CPU = "cpu"


@pytest.fixture(autouse=True)
def fresh_cache(monkeypatch):
    """Every test runs against its own in-memory tuning cache: tuned
    winners are process-global state that would otherwise leak into other
    tests' program keys."""
    monkeypatch.delenv("REPRO_TORCH_TUNING_CACHE", raising=False)
    prev = at.set_tuning_cache(at.TuningCache(path=None))
    yield
    at.set_tuning_cache(prev)
    for bucket in executor.program_cache_info()["pinned"]:
        while executor.program_cache_unpin(tuple(bucket)):
            pass


def _graphs(n_graphs=4, lo=8, hi=30, seed=0, lam=2):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_graphs):
        n = int(rng.integers(lo, hi))
        edges, _ = random_arboric(n, lam, rng)
        out.append(build_graph(n, edges, device=CPU))
    return out


def _packed(graphs, g_pad, k=1):
    plans = [plan_graph(g) for g in graphs]
    keys = [sample_keys(trng.PRNGKey(i), k) for i in range(len(plans))]
    return pack_bucket(plans, keys, k=k, g_pad=g_pad)


def _entry(**changed):
    ident = at.runtime_identity(CPU)
    ident.update(changed)
    return {"route": "l2", "block_rows": None, **ident}


# --- cache mechanics -------------------------------------------------------


def test_batch_tier_equals_reference():
    for b in (0, 1, 2, 3, 5, 8, 63, 64, 65, 1000, 1024, 1025, 10**9):
        assert at.batch_tier(b) == ref_at.batch_tier(b), b
    assert at.MAX_BATCH_TIER == ref_at.MAX_BATCH_TIER
    assert at.KERNELS == ref_at.KERNELS
    assert at.CANDIDATE_BLOCK_ROWS == ref_at.CANDIDATE_BLOCK_ROWS


def test_candidate_set():
    assert at.candidate_blocks(512) == (64, 128, 256, 512)
    assert at.candidate_blocks(128) == (64, 128)
    assert at.candidate_blocks(32) == (32,)
    assert at.candidate_blocks(100, candidates=(48, 512)) == (48, 100)
    assert at.candidate_plans(64, 4096, 32, CPU) == (at.PlanChoice("plain"),)
    # On the card: launch_plan's pick first, then l2, the one-wave staged
    # plan and the capped ones.
    cands = at.candidate_plans(64, 4096, 32, "cuda")
    assert cands[0] == at.default_choice(64, 4096, 32, "cuda") \
        == at.PlanChoice(nm.launch_plan(64, 4096, 32, 4097).route)
    assert [c.name for c in cands] == ["staged", "l2", "staged/64",
                                       "staged/128", "staged/256",
                                       "staged/512"]
    # A small bucket: l2 by default; every staged cap gives the one-wave
    # plan (4 rows a block), so only one staged candidate stays.
    assert [c.name for c in at.candidate_plans(64, 8, 4, "cuda")] == \
        ["l2", "staged"]
    # Odd widths have no staged route.
    assert [c.name for c in at.candidate_plans(3, 999, 7, "cuda")] == ["l2"]
    for c in cands:
        plan = c.launch_plan(64, 4096, 32)
        if c.block_rows is not None:
            assert plan.rows_per_block == c.block_rows
    with pytest.raises(ValueError):
        at.PlanChoice("staged", 64).launch_plan(3, 999, 7)


def test_cache_roundtrip(tmp_path):
    path = str(tmp_path / "tuning.json")
    cache = at.TuningCache(path=path)
    cache.put("neighbor_min", 64, 8, 4, at.PlanChoice("staged", 128),
              device=CPU, meta={"speedup_vs_default": 1.5})
    cache.save()
    loaded = at.TuningCache(path=path)
    assert loaded.get("neighbor_min", 64, 8, 4, device=CPU) == \
        at.PlanChoice("staged", 128)
    assert loaded.hits == 1
    assert loaded.get("neighbor_min", 64, 8, 8, device=CPU) is None
    assert loaded.misses == 1 and loaded.stale == 0
    blob = json.loads(open(path).read())
    assert blob["version"] == 1
    (key, entry), = blob["entries"].items()
    assert key == "cpu/neighbor_min/64x8/b4"
    assert {f: entry[f] for f in at.IDENTITY_FIELDS} == \
        at.runtime_identity(CPU)
    assert entry["kernel_digest"].startswith("libneighbor_min-")
    assert not os.path.exists(f"{path}.tmp.{os.getpid()}")


@pytest.mark.parametrize("field", at.IDENTITY_FIELDS)
def test_cache_stale_entries_ignored(tmp_path, field):
    """The invalidation rule: an entry whose device name, torch version,
    CUDA version or kernel digest is not the running process's is counted
    stale and treated as a miss — ignored, never trusted."""
    path = str(tmp_path / "tuning.json")
    blob = {"version": 1, "entries": {
        "cpu/neighbor_min/64x8/b4": _entry(**{field: "0.0.0-other"}),
        "cpu/label_agree/64x8/b4": _entry(),
    }}
    with open(path, "w") as f:
        json.dump(blob, f)
    cache = at.TuningCache(path=path)
    assert cache.get("neighbor_min", 64, 8, 4, device=CPU) is None
    assert cache.stale == 1 and cache.misses == 1
    assert cache.get("label_agree", 64, 8, 4, device=CPU) == \
        at.PlanChoice("l2")
    assert cache.hits == 1


def test_cache_corrupt_or_foreign_file_ignored(tmp_path):
    path = str(tmp_path / "tuning.json")
    with open(path, "w") as f:
        f.write("{not json")
    cache = at.TuningCache(path=path)        # must not raise
    assert cache.get("neighbor_min", 8, 4, 1, device=CPU) is None
    # The reference's format (block_rows, no route) is not an entry here.
    with open(path, "w") as f:
        json.dump({"version": 1, "entries": {"cpu/neighbor_min/8x4/b1": {
            "block_rows": 8, "backend": "cpu"}}}, f)
    assert at.TuningCache(path=path).load() == 0
    with open(path, "w") as f:
        json.dump({"version": 2, "entries": {
            "cpu/neighbor_min/8x4/b1": _entry()}}, f)
    assert len(at.TuningCache(path=path)) == 0


def test_cache_env_var_path(tmp_path, monkeypatch):
    path = str(tmp_path / "env-tuning.json")
    cache = at.TuningCache(path=path)
    cache.put("label_agree", 32, 4, 2, at.PlanChoice("l2"), device=CPU)
    cache.save()
    monkeypatch.setenv("REPRO_TUNING_CACHE", path)    # the reference's
    assert at.TuningCache().path is None
    monkeypatch.setenv("REPRO_TORCH_TUNING_CACHE", path)
    env_cache = at.TuningCache()
    assert env_cache.path == path
    assert env_cache.get("label_agree", 32, 4, 2, device=CPU) == \
        at.PlanChoice("l2")


def test_host_provenance_and_info():
    prov = at.host_provenance()
    for key in ("torch_version", "cuda_version", "device_kind",
                "device_count", "power_limit", "tuning_cache"):
        assert key in prov
    info = at.tuning_info()
    assert info["entries"] == 0 and info["sweep_log"] == []
    assert info["kernel_digest"] == at.kernel_digest()


# --- resolution and program keys --------------------------------------------


def test_resolve_plans_untuned_is_none():
    assert at.resolve_plans((8, 64, 8), CPU) is None
    at.tuning_cache().put("neighbor_min", 64, 8, 8, at.PlanChoice("l2"),
                          device=CPU)
    # Partial tuning: the untuned kernel takes the default choice.
    assert at.resolve_plans((8, 64, 8), CPU) == (at.PlanChoice("l2"),
                                                 at.PlanChoice("plain"))
    assert at.resolve_plans((16, 64, 8), CPU) is None     # another tier


def _pad_args(b, r, w):
    return (np.full((b, r, w), r, np.int32),
            np.full((b, r + 1), 2**31 - 1, np.int32),
            np.zeros((b, r + 1), bool), np.zeros((b,), np.int32))


def test_program_key_carries_plans():
    args = _pad_args(2, 16, 4)
    shape = (2, 16, 4)
    plans = (at.PlanChoice("staged", 8), at.PlanChoice("l2"))
    before = executor.program_cache_size()
    outs = [executor.run_bucket_program(*args, k=2, device=CPU, plans=p)
            for p in (None, plans, (at.PlanChoice("l2"),) * 2)]
    assert executor.program_cache_size() - before == 3
    for got in outs[1:]:
        for a, b in zip(outs[0], got):
            assert (a == b).all()
    assert executor._program_key(shape, 2) in executor._program_cache
    assert executor._program_key(shape, 2, plans=plans) == \
        (shape, 2, "pivot", "disagree", plans)
    assert executor.program_cache_contains(shape, 2, device=CPU,
                                           plans=plans)
    assert not executor.program_cache_contains(
        shape, 2, device=CPU, plans=(at.PlanChoice("staged"),) * 2)


def test_tuned_cache_drives_run_and_probe():
    """An untuned and a tuned run of one bucket are different keys, and
    the probe (given the device) resolves the tuning cache as the run
    does; without a device it keeps the untuned form."""
    args = _pad_args(2, 24, 4)
    shape = (2, 24, 4)
    executor.run_bucket_program(*args, k=1, device=CPU)
    assert executor.program_cache_contains(shape, 1, device=CPU)
    for kern in at.KERNELS:
        at.tuning_cache().put(kern, 24, 4, at.batch_tier(2),
                              at.PlanChoice("plain"), device=CPU)
    assert not executor.program_cache_contains(shape, 1, device=CPU)
    assert executor.program_cache_contains(shape, 1)
    before = executor.program_cache_size()
    executor.run_bucket_program(*args, k=1, device=CPU)
    assert executor.program_cache_size() - before == 1
    assert executor.program_cache_contains(shape, 1, device=CPU)
    tuned = executor._program_key(shape, 1, plans=(at.PlanChoice("plain"),)
                                  * 2)
    assert tuned in executor._program_cache


def test_cost_model_probe_resolves_like_the_executor():
    g = _graphs(1, lo=20, hi=21, seed=2)[0]
    eng = ClusterBatcher(max_batch=2, policy="cost", max_wait=0.01,
                         device=CPU)
    model = eng.policy.cost_model
    R, W = plan_graph(g).bucket
    bucket = ("pivot", R, W)
    for kern in at.KERNELS:
        at.tuning_cache().put(kern, R, W, 2, at.PlanChoice("plain"),
                              device=CPU)
    args = _pad_args(2, R, W)
    assert model.compile_charge(bucket, 2) > 0
    eng.executor.submit(*args, k=1, track=False).result()
    assert model.compile_charge(bucket, 2) == 0
    assert executor.program_cache_contains((2, R, W), 1, device=CPU)
    eng.close()


# --- sweep and warmup ------------------------------------------------------


def test_sweep_records_winner_and_cache():
    import torch

    graphs = _graphs(2, lo=20, hi=21, seed=3)
    ell, ranks, elig, _m, _pad = _packed(graphs, g_pad=2)
    cache = at.tuning_cache()
    records = at.sweep_bucket(*(torch.from_numpy(a) for a in
                                (ell, ranks, elig)), repeats=1)
    assert [r["kernel"] for r in records] == list(at.KERNELS)
    b, r, w = ell.shape
    tier = at.batch_tier(b)
    for rec in records:
        assert rec["candidates"] == ["plain"] and rec["winner"] == "plain"
        assert rec["equal"] and rec["speedup_vs_default"] == 1.0
        assert cache.get(rec["kernel"], r, w, tier, device=CPU) == \
            at.PlanChoice("plain")
    assert cache.sweeps == 2 and len(cache.sweep_log) == 2
    info = at.tuning_info()
    assert info["sweeps"] == 2 and len(info["sweep_log"]) == 2


def test_warmup_autotune_caches_and_reuses(tmp_path):
    """A sweep per bucket tier fills the cache file; a second warmup
    against a cache loaded from it makes zero sweeps, its hits equal to
    the tuned entries."""
    path = str(tmp_path / "tuning.json")
    graphs = _graphs(3, lo=10, hi=24, seed=1)
    at.set_tuning_cache(at.TuningCache(path=path))
    eng = ClusterBatcher(max_batch=2, num_samples=3, device=CPU)
    eng.warmup(graphs, autotune=True, repeats=1)
    first = at.tuning_cache()
    assert first.sweeps > 0 and first.sweeps == len(first)
    assert os.path.exists(path)
    assert eng.stats.tuning["sweeps"] == first.sweeps
    assert len(eng.stats.tuning["sweep_log"]) == first.sweeps
    swept = {(rec["batch"], rec["R"], rec["W"]) for rec in first.sweep_log}
    assert len(swept) * len(at.KERNELS) == first.sweeps
    # The registry holds the tuned keys the flushes will run.
    for shape in swept:
        assert executor.program_cache_contains(shape, 3, device=CPU)
        assert at.resolve_plans(shape, CPU) is not None

    at.set_tuning_cache(at.TuningCache(path=path))
    second = at.tuning_cache()
    eng2 = ClusterBatcher(max_batch=2, num_samples=3, device=CPU)
    eng2.warmup(graphs, autotune=True, repeats=1)
    assert second.sweeps == 0, "populated cache must skip all sweeps"
    assert second.hits == len(second) == first.sweeps
    assert second.stale == 0 and second.misses == 0
    assert eng.pool.leased == 0 and eng2.pool.leased == 0


# --- results: tuned equals untuned ------------------------------------------


def _serve(graphs, executor_spec):
    eng = ClusterBatcher(max_batch=4, num_samples=3, executor=executor_spec,
                         device=CPU)
    reqs = [ClusterRequest(uid=i, graph=g, key=trng.PRNGKey(i),
                           method="precluster" if i % 3 == 2 else None)
            for i, g in enumerate(graphs)]
    out = {r.uid: r.result for r in serve_all(eng, reqs)}
    return eng, out


@pytest.mark.parametrize("executor_spec", ["sync", "async", "sharded"])
def test_served_results_tuned_equal_untuned(executor_spec):
    graphs = _graphs(9, lo=8, hi=70, seed=7)

    def spec():
        return ShardedExecutor([CPU, CPU]) if executor_spec == "sharded" \
            else executor_spec

    eng, want = _serve(graphs, spec())
    eng.close()
    tuned = ClusterBatcher(max_batch=4, num_samples=3, executor=spec(),
                           device=CPU)
    tuned.warmup(graphs, autotune=True, repeats=1)
    assert tuned.stats.tuning["sweeps"] > 0
    tuned.close()
    # Seed a card route in every tuned tier too, so the launch plans are
    # built at every launch shape (a shard's B included); the CPU's plain
    # versions ignore them.
    cache = at.tuning_cache()
    for key in list(cache._entries):
        _, kernel, rw, tier = key.split("/")
        R, W = (int(x) for x in rw.split("x"))
        cache.put(kernel, R, W, int(tier[1:]), at.PlanChoice("staged", 64),
                  device=CPU)
    eng, got = _serve(graphs, spec())
    for uid, res in want.items():
        assert (got[uid].labels == res.labels).all()
        assert got[uid].cost == res.cost and got[uid].info == res.info
    tuned_keys = [key for key in executor._program_cache
                  if len(key) == 5 and key[4] == (at.PlanChoice("staged",
                                                               64),) * 2]
    assert tuned_keys
    assert eng.pool.leased == 0
    eng.close()


def test_batch_entry_tuned_equals_untuned():
    graphs = _graphs(6, lo=8, hi=40, seed=9)
    keys = [trng.PRNGKey(i) for i in range(len(graphs))]
    want = correlation_cluster_batch(graphs, keys=keys, num_samples=2,
                                     device=CPU)
    for g in graphs:
        R, W = plan_graph(g).bucket
        for tier in (2, 4, 8, 16):
            for kern in at.KERNELS:
                at.tuning_cache().put(kern, R, W, tier, at.PlanChoice("l2"),
                                      device=CPU)
    got = correlation_cluster_batch(graphs, keys=keys, num_samples=2,
                                    device=CPU)
    for a, b in zip(want, got):
        assert (a.labels == b.labels).all() and a.cost == b.cost


# --- the ELL roofline ------------------------------------------------------


def test_ell_kernel_models_scale_and_validate():
    for kern in ELL_KERNELS:
        # Linear in every axis of the swept (B, R, W) volume.
        assert ell_kernel_flops(kern, 8, 64, 8) \
            == 2 * ell_kernel_flops(kern, 4, 64, 8)
        assert ell_kernel_flops(kern, 4, 64, 8) \
            == ref_roofline.ell_kernel_flops(kern, 4, 64, 8)
        assert ell_kernel_bytes(kern, 4, 128, 8) \
            > ell_kernel_bytes(kern, 4, 64, 8)
        assert ell_kernel_bytes(kern, 4, 64, 16) \
            > ell_kernel_bytes(kern, 4, 64, 8)
        # No gathered words: below the reference's TPU count.
        assert ell_kernel_bytes(kern, 4, 64, 8) \
            < ref_roofline.ell_kernel_bytes(kern, 4, 64, 8)
    assert ELL_KERNELS == ref_roofline.ELL_KERNELS
    # neighbor_min reads two state tables, label_agree one.
    assert ell_kernel_bytes("neighbor_min", 4, 64, 8) \
        > ell_kernel_bytes("label_agree", 4, 64, 8)
    with pytest.raises(ValueError):
        ell_kernel_flops("fused_softmax", 4, 64, 8)
    with pytest.raises(ValueError):
        ell_kernel_bytes("fused_softmax", 4, 64, 8)


def test_ell_kernel_roofline_bottleneck_and_dict():
    r = ell_kernel_roofline("neighbor_min", 8, 128, 16)
    assert r.t_model == max(r.t_compute, r.t_memory)
    assert r.bottleneck == "memory"
    slow = ell_kernel_roofline("neighbor_min", 8, 128, 16,
                               peak_flops=1e6, mem_bw=1e15)
    assert slow.bottleneck == "compute"
    d = r.as_dict()
    assert d["shape"] == [8, 128, 16]
    assert d["t_model_s"] == r.t_model
    assert d["bottleneck"] == "memory"


@pytest.mark.parametrize("name,kernel,want_ms", [
    ("neighbor_min_ell_batch", "neighbor_min", 0.1286),
    ("label_agree_ell_batch", "label_agree", 0.1277)])
def test_ell_kernel_bytes_is_the_kernel_table_bound(name, kernel, want_ms):
    shape = (768, 4096, 32)
    nbytes, ops = bytes_and_ops(name, *shape)
    assert nbytes == ell_kernel_bytes(kernel, *shape)
    assert ops == ell_kernel_flops(kernel, *shape)
    ms, by = bound_ms(nbytes, ops)
    assert by == "bytes" and round(ms, 4) == want_ms
    assert ell_kernel_roofline(kernel, *shape).t_model * 1e3 == \
        pytest.approx(ms, rel=1e-12)
