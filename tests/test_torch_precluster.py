"""Precluster and the min-max objective of the port ≡ the reference, on the CPU.

* the batch engine's ``'precluster'`` method under both objectives against
  the reference's batch engine, at n = R−1, R, R+1 and k ∈ {1, 3}: labels,
  cost, picked sample, rounds (``depth``) and the info dict;
* the precluster rounds body on the reference's packed inputs against the
  reference's jitted body and the host oracle ``precluster_host``;
* the copied host oracles against the reference's on random λ-arboric and
  clustered graphs;
* per-graph ``correlation_cluster(method='precluster')`` and
  ``minmax_cost`` against the reference;
* the plain agreement pass walked in chunks equal to one walk, and to a
  brute-force count of common neighbours.

Every output compared is an integer: equality is exact.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import api as ref_api
from repro.core import cost as ref_cost
from repro.core import graph as ref_graph
from repro.core import plan as ref_plan
from repro.core import programs as ref_programs
from repro.core.batch import correlation_cluster_batch as ref_batch
from repro.core.mis import random_permutation_ranks as ref_ranks
from repro_torch.core import api, cost, graph, plan, programs
from repro_torch.core.batch import correlation_cluster_batch
from repro_torch.kernels import agreement, ref

CPU = "cpu"


def _words(key):
    return np.asarray(jax.random.key_data(key))


def clustered_edges(n, rng, p_in=0.85, p_out=0.01):
    """Groups of 3–9 vertices, dense inside and sparse across, so that
    many edges pass the agreement test (random sparse graphs have few
    common neighbours and almost no agreement)."""
    cuts = np.cumsum(rng.integers(3, 10, n))
    group = np.searchsorted(cuts, np.arange(n), side="right")
    u, v = np.triu_indices(n, 1)
    same = group[u] == group[v]
    keep = rng.random(len(u)) < np.where(same, p_in, p_out)
    return np.stack([u[keep], v[keep]], axis=1).astype(np.int64)


def _specs(ns, seed):
    rng = np.random.default_rng(seed)
    specs = []
    for i, n in enumerate(ns):
        if i % 3 == 2:
            edges, _ = ref_graph.random_arboric(n, 2, rng)
        else:
            edges = clustered_edges(n, rng)
        specs.append((n, edges))
    return specs


def _results_equal(a, b):
    assert (np.asarray(a.labels) == b.labels).all()
    assert a.cost == b.cost
    assert a.info == b.info, (a.info, b.info)


@pytest.mark.parametrize("objective", ["disagree", "minmax"])
@pytest.mark.parametrize("k", [1, 3])
def test_batch_precluster_matches_reference(k, objective):
    """Bucket boundaries n = R−1, R, R+1 at R = 16 and 64, clustered and
    random graphs, one call per engine."""
    specs = _specs([15, 16, 17, 63, 64, 65], seed=10 * k + len(objective))
    rgs = [ref_graph.build_graph(n, e) for n, e in specs]
    tgs = [graph.build_graph(n, e, device=CPU) for n, e in specs]
    keys = [jax.random.PRNGKey(7 + i) for i in range(len(specs))]
    want = ref_batch(rgs, keys=keys, method="precluster", num_samples=k,
                     objective=objective)
    got = correlation_cluster_batch(tgs, keys=[_words(x) for x in keys],
                                    method="precluster", num_samples=k,
                                    objective=objective, device=CPU)
    for a, b in zip(want, got):
        _results_equal(a, b)
    assert any(r.info["depth"] > 0 for r in got), "no agreement propagated"


def _packed(specs, k, seed):
    rgs = [ref_graph.build_graph(n, e) for n, e in specs]
    plans = [ref_plan.plan_graph(g, method="precluster") for g in rgs]
    R, W = max(p.R for p in plans), max(p.W for p in plans)
    plans = [ref_plan.promote_plan(p, R, W) for p in plans]
    keys = [ref_api.sample_keys(jax.random.PRNGKey(seed + i), k)
            for i in range(len(plans))]
    return plans, keys, ref_plan.pack_bucket(plans, keys, k=k)


@pytest.mark.parametrize("k", [1, 3])
def test_precluster_body_matches_reference_body_and_host(k):
    """On the reference's packed inputs: the port's body equals the
    reference's jitted body and ``precluster_host`` per entry; the minmax
    pass equals the reference's and the host oracle on the kept edges."""
    plans, keys, (ell, ranks, elig, m_edges, _) = _packed(
        _specs([20, 31, 9, 28], seed=3), k, seed=30)
    body = jax.jit(functools.partial(ref_programs._precluster_rounds_body,
                                     use_kernel=False, nm_rows=None))
    want_labels, want_rounds = (np.asarray(x) for x in body(ell, ranks, elig))
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (ell, ranks, elig, m_edges)]
    labels, rounds = programs._precluster_rounds_body(*t[:3])
    assert labels.dtype == rounds.dtype == torch.int32
    assert (labels.numpy() == want_labels).all()
    assert (rounds.numpy() == want_rounds).all()
    want_mm = jax.jit(functools.partial(
        ref_programs._minmax_cost_pass, use_kernel=False, la_rows=None))(
        ell, want_labels, m_edges)
    got_mm = programs._minmax_cost_pass(t[0], labels, t[3])
    assert (got_mm.numpy() == np.asarray(want_mm)).all()
    for gi, p in enumerate(plans):
        for si in range(k):
            b = gi * k + si
            host_labels, host_rounds = programs.precluster_host(
                p.n, p.canonical_edges, p.eligible, ranks[b, : p.n])
            assert (labels[b, : p.n].numpy() == host_labels).all()
            assert rounds[b] == host_rounds
            assert got_mm[b] == programs.minmax_cost_host(
                p.n, p.canonical_edges, host_labels)


@pytest.mark.parametrize("seed", range(4))
def test_host_oracles_are_the_reference_copies(seed):
    rng = np.random.default_rng(seed)
    for n in (1, 12, 40, 90):
        edges = (clustered_edges(n, rng) if n % 2 == 0
                 else ref_graph.random_arboric(n, 1 + seed % 3, rng)[0])
        eligible = rng.random(n) < 0.9
        ranks = rng.permutation(n)
        a = ref_programs.precluster_host(n, edges, eligible, ranks)
        b = programs.precluster_host(n, edges, eligible, ranks)
        assert (a[0] == b[0]).all() and a[1] == b[1]
        labels = rng.integers(0, max(1, n // 3), n)
        assert ref_programs.minmax_cost_host(n, edges, labels) == \
            programs.minmax_cost_host(n, edges, labels)


@pytest.mark.parametrize("k", [1, 3])
def test_per_graph_precluster_and_minmax_match_reference(k):
    rng = np.random.default_rng(k)
    for n, edges in [(40, clustered_edges(40, rng)), (7, np.zeros((0, 2))),
                     (33, ref_graph.random_arboric(33, 2, rng)[0])]:
        rg = ref_graph.build_graph(n, edges)
        tg = graph.build_graph(n, edges, device=CPU)
        key = jax.random.PRNGKey(n)
        a = ref_api.correlation_cluster(rg, method="precluster", key=key,
                                        num_samples=k)
        b = api.correlation_cluster(tg, method="precluster", key=_words(key),
                                    num_samples=k, device=CPU)
        _results_equal(a, b)
        assert b.method == "precluster" and b.labels.dtype == np.int32
        assert ref_cost.minmax_cost(rg, a.labels) == \
            cost.minmax_cost(tg, b.labels)
    # The plan's ranks are the per-graph draw: the reference's host path
    # reproduces the port's labels from its own ranks.
    g = graph.build_graph(40, clustered_edges(40, rng), device=CPU)
    res = api.correlation_cluster(g, method="precluster", lam=2,
                                  key=_words(jax.random.PRNGKey(5)),
                                  device=CPU)
    p = plan.plan_graph(g, method="precluster", lam=2)
    host, rounds = ref_programs.precluster_host(
        40, p.canonical_edges, p.eligible,
        np.asarray(ref_ranks(40, jax.random.PRNGKey(5))))
    assert (host == res.labels).all() and rounds == res.info["depth"]


def _brute_common(ell):
    B, R, W = ell.shape
    out = np.zeros((B, R, W), dtype=np.int32)
    for b in range(B):
        rows = [set(ell[b, r][ell[b, r] != R].tolist()) for r in range(R)]
        for r in range(R):
            for w in range(W):
                v = ell[b, r, w]
                if v != R:
                    out[b, r, w] = len(rows[r] & rows[v])
    return out


@pytest.mark.parametrize("budget", [1, 700, 5000])
def test_chunked_agreement_pass_equals_one_walk(budget):
    """Chunks of one row (budget 1), of a few rows that end mid-entry, and
    of whole entries give the counts of one walk over every row, which
    equal a brute-force count."""
    plans, _, (ell, _, _, _, _) = _packed(_specs([20, 30, 12], seed=9), 2,
                                          seed=1)
    t = torch.from_numpy(np.ascontiguousarray(ell))
    whole = ref.common_neighbours_ref(t, budget=1 << 30)
    assert (whole.numpy() == _brute_common(ell)).all()
    chunked = ref.common_neighbours_ref(t, budget=budget)
    assert torch.equal(chunked, whole)
    assert torch.equal(ref.agreement_ell_ref(t, budget=budget),
                       agreement.agreement_ell_batch(t))


# ---------------------------------------------------------------------------
# One agreement pass a group of replicas (``replicas`` = k).
# ---------------------------------------------------------------------------


def _port_bucket(ns, k, seed, lam=1, prebuilt=False, staging=None):
    """The port's ``pack_bucket`` on clustered graphs of ``ns`` vertices
    (λ = 1, so that edges agree), promoted to one bucket; the group axis
    pads to a power of two."""
    rng = np.random.default_rng(seed)
    gs = [graph.build_graph(n, clustered_edges(n, rng), device=CPU)
          for n in ns]
    plans = [plan.plan_graph(g, method="precluster", lam=lam) for g in gs]
    R, W = max(p.R for p in plans), max(p.W for p in plans)
    plans = [plan.promote_plan(p, R, W) for p in plans]
    keys = [api.sample_keys(_words(jax.random.PRNGKey(seed + i)), k)
            for i in range(len(plans))]
    if prebuilt:
        for p, ks in zip(plans, keys):
            p.rows = plan.build_packed_rows(p, ks)
    return plan.pack_bucket(plans, [None if prebuilt else ks for ks in keys],
                            k=k, staging=staging)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("R", [16, 64])
def test_agreement_once_a_group_equals_every_entry(R, k):
    """At n = R−1, R, R+1 (two buckets promoted to one), one pass a group
    of k replicas equals the pass over every entry, in the plain version
    and through the wrapper; λ = 1 clustered graphs, so edges agree."""
    ell = torch.from_numpy(_port_bucket([R - 1, R, R + 1], k, seed=R)[0])
    every = ref.agreement_ell_ref(ell)
    assert (every != ell.shape[1]).any(), "no edge agrees"
    assert torch.equal(ref.agreement_ell_ref(ell, replicas=k), every)
    assert torch.equal(agreement.agreement_ell_batch(ell, replicas=k), every)


@pytest.mark.parametrize("prebuilt", [False, True])
@pytest.mark.parametrize("k", [1, 3])
def test_pack_bucket_gives_a_group_one_ell(k, prebuilt):
    """The contract ``replicas`` leans on: the k entries of a group carry
    identical ELLs and the groups added up to a power of two are all pad,
    whether the rows are scattered at the flush or prebuilt at admission,
    and when a staging buffer that held a larger flush is refilled."""
    ns = [20, 31, 9]
    ell = _port_bucket(ns, k, seed=2, prebuilt=prebuilt)[0]
    B, R, W = ell.shape
    assert B == 4 * k
    groups = ell.reshape(4, k, R, W)
    assert (groups == groups[:, :1]).all()
    assert (groups[len(ns):] == R).all() and (groups[:len(ns)] != R).any()
    # The same staging buffer, first filled by four graphs, then by three.
    staging = {"ell": np.empty((4 * k, R, W), np.int32),
               "ranks": np.empty((4 * k, R + 1), np.int32),
               "elig": np.empty((4 * k, R + 1), bool),
               "m_edges": np.empty((4 * k,), np.int32)}
    _port_bucket(ns + [30], k, seed=3, prebuilt=prebuilt, staging=staging)
    again = _port_bucket(ns, k, seed=2, prebuilt=prebuilt,
                         staging=staging)[0]
    assert (again == ell).all()


def _staged_form(row, R):
    """Whether an ELL row is as the agreement kernel's smem route stages
    it: its ids first, then pads, the ids ascending up to one rotation."""
    du = int((row != R).sum())
    ids = row[:du]
    if (row[du:] != R).any() or ((ids < 0) | (ids >= R)).any():
        return False
    desc = int((ids[:-1] > ids[1:]).sum())
    return desc == 0 or (desc == 1 and ids[-1] <= ids[0])


@pytest.mark.parametrize("prebuilt", [False, True])
def test_pack_bucket_rows_are_ascending_up_to_a_rotation(prebuilt):
    """The layout the smem route's staged path leans on (other rows take
    its fallback): every row ``pack_bucket`` writes holds the neighbours
    above u ascending, then those below ascending, then pads."""
    for seed, ns in ((2, [20, 31, 9]), (5, [60, 64, 65]), (7, [130])):
        ell = _port_bucket(ns, 1, seed=seed, lam=2, prebuilt=prebuilt)[0]
        B, R, W = ell.shape
        for b in range(B):
            for u in range(R):
                row = ell[b, u]
                assert _staged_form(row, R), (b, u, row)
                ids = row[row != R]
                k = int((ids > u).sum())
                assert (ids[:k] > u).all() and (ids[k:] < u).all()
    # And what takes the fallback.
    assert not _staged_form(np.array([3, 1, 4, 2, 8]), 8)   # two descents
    assert not _staged_form(np.array([3, 4, 1, 5, 8]), 8)   # no rotation
    assert not _staged_form(np.array([5, 8, 2, 8]), 8)      # a pad inside
    assert _staged_form(np.array([5, 7, 1, 2, 8, 8]), 8)    # one rotation


def test_agreement_refuses_a_batch_of_partial_groups():
    ell = torch.from_numpy(_port_bucket([20, 31, 9], 3, seed=2)[0])
    for fn in (ref.agreement_ell_ref, agreement.agreement_ell_batch):
        with pytest.raises(ValueError, match="replicas=5"):
            fn(ell, replicas=5)
        with pytest.raises(ValueError, match="replicas=0"):
            fn(ell, replicas=0)
    ranks = torch.zeros((12, ell.shape[1] + 1), dtype=torch.int32)
    elig = torch.zeros((12, ell.shape[1] + 1), dtype=torch.bool)
    with pytest.raises(ValueError, match="replicas=5"):
        programs._precluster_rounds_body(ell, ranks, elig, replicas=5)


@pytest.mark.parametrize("objective", ["disagree", "minmax"])
@pytest.mark.parametrize("k", [1, 3])
def test_precluster_bucket_impl_with_replicas_matches_reference(k,
                                                                objective):
    """``bucket_impl(program='precluster')``, whose rounds body gets
    ``replicas=k``, equals the reference's bucket program on its packed
    inputs; and the port's sharded executor over two ``"cpu"`` devices,
    which cuts the batch at group boundaries, gives the same winners."""
    specs = [(n, clustered_edges(n, np.random.default_rng(n)))
             for n in (20, 31, 9, 28)]
    plans_r, keys_r, (ell, ranks, elig, m_edges, _) = _packed(specs, k,
                                                              seed=40)
    want = jax.jit(functools.partial(
        ref_programs.bucket_impl, k=k, use_kernel=False, block_rows=None,
        program="precluster", objective=objective))(ell, ranks, elig,
                                                    m_edges)
    want = [np.asarray(x) for x in want]
    t = [torch.from_numpy(np.ascontiguousarray(a))
         for a in (ell, ranks, elig, m_edges)]
    got = programs.bucket_impl(*t, k=k, program="precluster",
                               objective=objective)
    for x, y in zip(want, got):
        assert y.dtype == torch.int32 and (x == y.numpy()).all()
    from repro_torch.core.executor import ShardedExecutor, pack_and_submit

    gs = [graph.build_graph(n, e, device=CPU) for n, e in specs]
    plans_t = [plan.plan_graph(g, method="precluster") for g in gs]
    R, W = ell.shape[1:]
    plans_t = [plan.promote_plan(p, R, W) for p in plans_t]
    keys_t = [api.sample_keys(_words(jax.random.PRNGKey(40 + i)), k)
              for i in range(len(plans_t))]
    two = ShardedExecutor([CPU, CPU])
    handle, _ = pack_and_submit(plans_t, keys_t, k, two, objective=objective)
    sharded = handle.result()
    two.close()
    for x, y in zip(want, sharded):
        assert (x[: len(specs)] == np.asarray(y)[: len(specs)]).all()
