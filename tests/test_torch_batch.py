"""Batch engine of the port ≡ the reference, bit-exactly, on the CPU.

* planning and packing: ``plan_graph`` fields and the ``pack_bucket``
  staging bytes for legacy, prebuilt, mixed and promoted packs;
* the bucket program on identical staged inputs, including a forced cost
  tie that only the first-minimum argmin rule resolves like the reference;
* ``correlation_cluster_batch`` across bucket boundaries (n = R−1, R, R+1)
  for k ∈ {1, 3}: labels, cost, picked sample, depth, the info dict and
  the pack statistics;
* the import guard: no module of the port, nor ``chip_smoke.py``, imports
  ``jax`` or ``repro``.
"""

import ast
import dataclasses
import functools
import importlib
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.core import api as ref_api
from repro.core import graph as ref_graph
from repro.core import plan as ref_plan
from repro.core import programs as ref_programs
from repro_torch.core import api, executor, graph, plan, programs
from repro_torch.core import rng as trng

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
ref_batch = importlib.import_module("repro.core.batch")
batch = importlib.import_module("repro_torch.core.batch")


def _words(key):
    return np.asarray(jax.random.key_data(key))


def from_reference_arrays(ell, ranks, elig, m_edges, device=CPU):
    """The reference's packed numpy staging as port tensors."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (ell, ranks, elig, m_edges))


def _graphs(ns, lam=2, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for n in ns:
        edges, _ = ref_graph.random_arboric(n, lam, rng)
        out.append((n, edges))
    return out


def _pairs(specs):
    return ([ref_graph.build_graph(n, e) for n, e in specs],
            [graph.build_graph(n, e, device=CPU) for n, e in specs])


def _assert_staging_equal(a, b):
    for x, y, name in zip(a, b, ("ell", "ranks", "elig", "m_edges", "pad")):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert x.tobytes() == y.tobytes(), name


def test_plan_graph_fields_match():
    specs = _graphs([5, 30, 70]) + [(40, ref_graph.star(40))]
    rgs, tgs = _pairs(specs)
    for method in ("pivot", "pivot_raw"):
        for rg, tg in zip(rgs, tgs):
            a = ref_plan.plan_graph(rg, method=method)
            b = plan.plan_graph(tg, method=method)
            assert (a.n, a.lam, a.threshold, a.wreq, a.R, a.W) == \
                (b.n, b.lam, b.threshold, b.wreq, b.R, b.W)
            assert (a.eligible == b.eligible).all()
            assert a.canonical_edges.tobytes() == b.canonical_edges.tobytes()
            b.canonical_edges = None
            assert plan.plan_canonical_edges(b).tobytes() == \
                a.canonical_edges.tobytes()


@pytest.mark.parametrize("mode", ["legacy", "prebuilt", "mixed", "promoted"])
@pytest.mark.parametrize("k", [1, 2])
def test_pack_bucket_bytes_match(mode, k):
    specs = _graphs([9, 12, 16, 14, 11], lam=2, seed=k)
    rgs, tgs = _pairs(specs)
    rplans = [ref_plan.plan_graph(g, lam=2) for g in rgs]
    tplans = [plan.plan_graph(g, lam=2) for g in tgs]
    base = [jax.random.PRNGKey(40 + i) for i in range(len(specs))]
    rkeys = [ref_api.sample_keys(key, k) for key in base]
    tkeys = [api.sample_keys(_words(key), k) for key in base]
    if mode == "promoted":
        R, W = (max(p.R for p in rplans) * 2, max(p.W for p in rplans) * 2)
    for i, (rp, tp) in enumerate(zip(rplans, tplans)):
        if mode == "prebuilt" or (mode in ("mixed", "promoted") and i % 2):
            rp.rows = ref_plan.build_packed_rows(rp, rkeys[i])
            tp.rows = plan.build_packed_rows(tp, tkeys[i])
        if mode == "promoted":
            rplans[i] = ref_plan.promote_plan(rp, R, W)
            tplans[i] = plan.promote_plan(tp, R, W)
    buckets = {}
    for i, p in enumerate(tplans):
        buckets.setdefault(p.bucket, []).append(i)
    for members in buckets.values():
        rk = [None if rplans[i].rows is not None else rkeys[i]
              for i in members]
        tk = [None if tplans[i].rows is not None else tkeys[i]
              for i in members]
        a = ref_plan.pack_bucket([rplans[i] for i in members], rk, k=k,
                                 g_pad=8)
        b = plan.pack_bucket([tplans[i] for i in members], tk, k=k, g_pad=8)
        _assert_staging_equal(a, b)
        assert vars(plan.estimate_pack_stats(
            [tplans[i] for i in members], k)) == vars(
            ref_plan.estimate_pack_stats([rplans[i] for i in members], k))


def test_pack_bucket_rejects_mismatched_prebuilt_shape():
    (n, e), = _graphs([10])
    p = plan.plan_graph(graph.build_graph(n, e, device=CPU))
    p.rows = plan.build_packed_rows(p, [trng.PRNGKey(0)])
    with pytest.raises(ValueError):             # rows not relaid out
        plan.pack_bucket([dataclasses.replace(p, R=p.R * 2)], [None], k=1)
    with pytest.raises(ValueError):
        plan.pack_bucket([p], [None], k=2)
    with pytest.raises(ValueError):
        p.rows.promote(p.R // 2, p.W)


def test_bucket_program_with_forced_cost_tie():
    """Samples 1 and 2 of every graph get the same permutation, so their
    costs tie; where sample 0 costs more, only a first-minimum argmin picks
    1 like the reference. Inputs are the reference's staging, converted."""
    specs = _graphs([10, 12, 13, 14, 15, 16, 11, 9], lam=2, seed=5)
    rgs, _ = _pairs(specs)
    plans = [ref_plan.plan_graph(g, lam=2) for g in rgs]
    R, W = max(p.R for p in plans), max(p.W for p in plans)
    plans = [ref_plan.promote_plan(p, R, W) for p in plans]  # one bucket
    k = 3
    keys = [ref_api.sample_keys(jax.random.PRNGKey(i), k)
            for i in range(len(plans))]
    ell, ranks, elig, m_edges, _ = ref_plan.pack_bucket(plans, keys, k=k)
    ranks[2::k] = ranks[1::k]
    expect = jax.jit(functools.partial(
        ref_programs.bucket_impl, k=k, use_kernel=False, block_rows=None,
        program="pivot", objective="disagree"))(ell, ranks, elig, m_edges)
    t = from_reference_arrays(ell, ranks, elig, m_edges)
    got = programs.bucket_impl(*t, k=k)
    for x, y in zip(expect, got):
        assert y.dtype == torch.int32
        assert (np.asarray(x) == y.numpy()).all()
    labels, _ = programs._pivot_rounds_body(*t[:3])
    costs = programs._disagree_cost_pass(t[0], labels, t[3]).reshape(-1, k)
    assert torch.equal(costs[:, 1], costs[:, 2])
    tie_first = (costs[:, 0] > costs[:, 1]) & (got[2] == 1)
    assert bool(tie_first.any()), "no group had its tied minimum after 0"


# n values straddling the R buckets 8, 16, 32: R−1, R, R+1.
BOUNDARY_NS = [7, 8, 9, 15, 16, 17, 31, 32, 33]


@pytest.mark.parametrize("k", [1, 3])
def test_batch_matches_reference_at_bucket_boundaries(k):
    specs = _graphs(BOUNDARY_NS, lam=2, seed=k)
    specs.append((12, ref_graph.star(12)))           # degree cap active
    specs.append((6, np.zeros((0, 2), np.int64)))   # edgeless
    rgs, tgs = _pairs(specs)
    keys = [jax.random.PRNGKey(n + 100 * k) for n, _ in specs]
    lams = [None if i % 2 else 2 for i in range(len(specs))]
    ra, rstats = ref_batch.correlation_cluster_batch(
        rgs, keys=keys, num_samples=k, lams=lams, with_stats=True)
    ta, tstats = batch.correlation_cluster_batch(
        tgs, keys=[_words(x) for x in keys], num_samples=k, lams=lams,
        with_stats=True, device=CPU)
    for a, b in zip(ra, ta):
        assert (a.labels == b.labels).all()
        assert b.labels.dtype == np.int32
        assert a.cost == b.cost and a.info == b.info, (a.info, b.info)
    assert vars(rstats) == vars(tstats)


def test_batch_agrees_with_per_graph_port_and_host_cost():
    specs = _graphs([20, 40, 70], lam=3, seed=9)
    _, tgs = _pairs(specs)
    keys = [trng.PRNGKey(i) for i in range(len(tgs))]
    for method in ("pivot", "pivot_raw"):
        res = batch.correlation_cluster_batch(tgs, keys=keys, method=method,
                                              num_samples=3, device=CPU)
        for g, key, r in zip(tgs, keys, res):
            s = api.correlation_cluster(g, key=key, method=method,
                                        num_samples=3, device=CPU)
            assert (s.labels == r.labels).all() and s.cost == r.cost
            assert s.info["picked_sample"] == r.info["picked_sample"]
            assert s.info["depth"] == r.info["depth"]
            assert r.cost == batch._cost_host(g, r.labels)
    # One key broadcast to every graph, and the default key.
    one = batch.correlation_cluster_batch(tgs, keys=trng.PRNGKey(0),
                                          device=CPU)
    dflt = batch.correlation_cluster_batch(tgs, device=CPU)
    assert all((a.labels == b.labels).all() for a, b in zip(one, dflt))
    assert batch.correlation_cluster_batch([], device=CPU) == []


def test_batch_refuses_what_is_not_ported():
    """Every registered method, objective and executor name of the
    reference resolves; unknown names are refused."""
    g = graph.build_graph(5, ref_graph.path(5), device=CPU)
    assert programs.registered_methods() == \
        ref_programs.registered_methods()
    assert programs.registered_objectives() == \
        ref_programs.registered_objectives()
    with pytest.raises(ValueError, match="supports methods"):
        batch.correlation_cluster_batch([g], method="cliques", device=CPU)
    with pytest.raises(ValueError, match="supports objectives"):
        batch.correlation_cluster_batch([g], objective="nope", device=CPU)
    assert executor.make_executor("async", device=CPU).name == "async"
    sharded = executor.make_executor("sharded", device=CPU)
    assert sharded.name == "sharded" and sharded.devices == [torch.device(CPU)]
    with pytest.raises(ValueError, match="unknown executor"):
        executor.make_executor("nope", device=CPU)
    with pytest.raises(ValueError):
        batch.correlation_cluster_batch([g], num_samples=0, device=CPU)
    p1 = plan.plan_graph(g, method="pivot")
    p2 = plan.plan_graph(g, method="pivot_raw")
    with pytest.raises(ValueError, match="cannot pack methods"):
        executor.pack_and_submit([p1, p2], [[trng.PRNGKey(0)]] * 2, 1,
                                 executor.SyncExecutor(device=CPU))


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)
