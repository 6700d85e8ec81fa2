"""Forests, cliques, the rest of the cost module, the parallel degeneracy
peel and the methods built on them: the port ≡ the reference, bit-exactly,
on the CPU.

The whole of ``forest.py`` (partner arrays and rounds for one key, on
forests of n = 1, 2, 50 and 500 and on a graph that is not a forest),
``rng.randint`` against ``jax.random.randint``, ``clique_clustering``,
``connected_components`` (one case stopped by ``max_iters``) and
``component_sizes``, ``brute_force_opt``, ``lemma25_transform`` and
``canonicalize``, ``degeneracy_parallel`` and ``correlation_cluster(lam=
None)`` at n = 200,001 (the repaired ``exact=False`` path),
``correlation_cluster`` with ``forest_exact``, ``forest_approx`` and
``cliques``, and that ``repro_torch.core`` exports every name of
``repro.core``. Inputs are numpy-made from seeds; comparisons are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as tcore
from repro.core import api as ref_api
from repro.core import arboricity as ref_arb
from repro.core import cliques as ref_cliques
from repro.core import cost as ref_cost
from repro.core import forest as ref_forest
from repro.core import graph as ref_graph
from repro_torch.core import (api, arboricity, cliques, cost, degree_cap,
                              forest, graph, rng)

CPU = "cpu"


def _words(key):
    return np.asarray(jax.random.key_data(key))


def _pair(n, edges):
    return (ref_graph.build_graph(n, edges),
            graph.build_graph(n, edges, device=CPU))


def _forest_cases():
    rng_ = np.random.default_rng(15)
    out = [(f"forest{n}", n, ref_graph.random_forest(n, rng_))
           for n in (1, 2, 50, 500)]
    out.append(("forest_sparse300", 300,
                ref_graph.random_forest(300, rng_, p_keep=0.7)))
    out.append(("arboric200", 200, ref_graph.random_arboric(200, 2, rng_)[0]))
    return out


FOREST_CASES = _forest_cases()
FOREST_IDS = [c[0] for c in FOREST_CASES]


@pytest.mark.parametrize("case", FOREST_CASES, ids=FOREST_IDS)
def test_forest_module_matches_reference(case):
    name, n, edges = case
    rg, tg = _pair(n, edges)
    key = jax.random.PRNGKey(n + 5)
    assert (ref_forest.max_matching_forest(rg)
            == forest.max_matching_forest(tg)).all()
    assert (np.asarray(ref_forest._edge_priorities(rg, key)).astype(np.int64)
            == forest._edge_priorities(tg, _words(key)).numpy()).all()
    p1, r1 = ref_forest.maximal_matching_parallel(rg, key)
    p2, r2 = forest.maximal_matching_parallel(tg, _words(key))
    assert (np.asarray(p1) == p2.numpy()).all() and int(r1) == r2
    p1, r1 = ref_forest.augmenting_matching_parallel(rg, key)
    p2, r2 = forest.augmenting_matching_parallel(tg, _words(key))
    assert (p1 == p2).all() and r1 == r2
    assert forest.matching_size(p2) == ref_forest.matching_size(p1)
    assert (forest.clustering_from_matching(p2)
            == ref_forest.clustering_from_matching(p1)).all()
    assert forest.forest_cost_from_matching(tg, p2) == \
        ref_forest.forest_cost_from_matching(rg, p1)


def test_randint_matches_jax():
    spans = [(0, 2**31 - 1), (0, 10), (5, 5), (7, 3), (-100, 100), (0, 1),
             (-2**31, 2**31 - 1), (0, 65537), (3, 2**20 + 7)]
    for seed in list(range(24)) + [2**31 - 1, 2**32 - 1]:
        base = jax.random.PRNGKey(seed)
        for key in (base, jax.random.fold_in(base, 3),
                    jax.random.split(base)[1]):
            for lo, hi in spans:
                assert rng.randint(_words(key), lo, hi) == \
                    int(jax.random.randint(key, (), lo, hi)), (seed, lo, hi)


def _clique_cases():
    rng_ = np.random.default_rng(32)
    n, e = ref_graph.disjoint_cliques([1, 2, 3, 5, 8], gap=1)
    noisy = np.concatenate([e, [[0, 3], [10, 12]]])
    path_n = 40
    return [("cliques", n, e), ("cliques_noise", n, noisy),
            ("barbell", *ref_graph.barbell(4)),
            ("arboric150", 150, ref_graph.random_arboric(150, 2, rng_)[0]),
            ("path40", path_n, ref_graph.path(path_n))]


CLIQUE_CASES = _clique_cases()


@pytest.mark.parametrize("case", CLIQUE_CASES, ids=[c[0] for c in CLIQUE_CASES])
def test_cliques_module_matches_reference(case):
    name, n, edges = case
    rg, tg = _pair(n, edges)
    assert (np.asarray(ref_cliques.clique_clustering(rg))
            == cliques.clique_clustering(tg).numpy()).all()
    mask = np.random.default_rng(n).random(n) < 0.7
    for max_iters in (64, 1):
        l1, i1 = ref_cliques.connected_components(rg, jnp.asarray(mask),
                                                  max_iters=max_iters)
        l2, i2 = cliques.connected_components(tg, torch.from_numpy(mask),
                                              max_iters=max_iters)
        assert (np.asarray(l1) == l2.numpy()).all() and int(i1) == i2
        s1 = ref_cliques.component_sizes(l1, jnp.asarray(mask), n)
        s2 = cliques.component_sizes(l2, torch.from_numpy(mask), n)
        assert (np.asarray(s1) == s2.numpy()).all()


def test_connected_components_stops_at_max_iters():
    # A path of 64 vertices needs more than two propagation iterations.
    rg, tg = _pair(64, ref_graph.path(64))
    mask = np.ones(64, bool)
    l1, i1 = ref_cliques.connected_components(rg, jnp.asarray(mask),
                                              max_iters=2)
    l2, i2 = cliques.connected_components(tg, torch.from_numpy(mask),
                                          max_iters=2)
    assert int(i1) == i2 == 2
    assert (np.asarray(l1) == l2.numpy()).all() and len(set(l2.tolist())) > 1


def test_cost_extras_match_reference():
    rng_ = np.random.default_rng(25)
    for n in (5, 7, 9):
        edges = ref_graph.gnp(n, 0.4, rng_)
        rg, tg = _pair(n, edges)
        c1, a1 = ref_cost.brute_force_opt(rg)
        c2, a2 = cost.brute_force_opt(tg)
        assert c1 == c2 and (a1 == a2).all()
    with pytest.raises(ValueError):
        cost.brute_force_opt(graph.build_graph(11, np.zeros((0, 2)),
                                               device=CPU))
    labels = rng_.integers(0, 50, 60) * 3
    assert (cost.canonicalize(labels) == ref_cost.canonicalize(labels)).all()
    # One big cluster of a forest: Lemma 25 ejects vertices until every
    # cluster holds at most 4λ - 2.
    rg, tg = _pair(60, ref_graph.random_forest(60, rng_))
    zeros = np.zeros(60, np.int32)
    assert (cost.lemma25_transform(tg, zeros, 1)
            == ref_cost.lemma25_transform(rg, zeros, 1)).all()
    n, e = ref_graph.disjoint_cliques([6, 9])
    rg, tg = _pair(n, e)
    assert (cost.lemma25_transform(tg, np.zeros(n, np.int32), 3)
            == ref_cost.lemma25_transform(rg, np.zeros(n, np.int32), 3)).all()


def test_generic_degree_cap_matches_reference():
    rg, tg = _pair(120, np.concatenate([
        ref_graph.star(120), ref_graph.random_forest(120,
                                                     np.random.default_rng(4))]))

    def inner(sub, low_ids):     # a host clustering of the subgraph
        return np.arange(sub.n) // 3

    a = ref_core.degree_capped(rg, lam=1, eps=2.0, inner_fn=inner)
    b = degree_cap.degree_capped(tg, lam=1, eps=2.0, inner_fn=inner)
    assert (a.labels == b.labels).all() and (a.high_mask == b.high_mask).all()
    assert a.threshold == b.threshold and b.inner is None


@pytest.mark.parametrize("n,lam", [(0, 1), (1, 1), (60, 1), (400, 2),
                                   (700, 3)])
def test_degeneracy_parallel_matches_reference(n, lam):
    edges = ref_graph.random_arboric(n, lam, np.random.default_rng(n))[0] \
        if n > 1 else np.zeros((0, 2), np.int64)
    rg, tg = _pair(n, edges)
    assert arboricity.degeneracy_parallel(tg) == \
        ref_arb.degeneracy_parallel(rg)
    assert arboricity.arboricity_bounds(tg, exact=False) == \
        ref_arb.arboricity_bounds(rg, exact=False)


def test_lambda_estimate_above_200k_vertices():
    """The repaired fault: ``lam=None`` above 200,000 vertices takes the
    parallel peel (``exact=False``), as the reference does."""
    n = 200_001
    rg, tg = _pair(n, ref_graph.random_forest(n, np.random.default_rng(7)))
    key = jax.random.PRNGKey(11)
    a = ref_api.correlation_cluster(rg, key=key)
    b = api.correlation_cluster(tg, key=_words(key), device=CPU)
    assert (a.labels == b.labels).all()
    assert (a.cost, a.method) == (b.cost, b.method)
    assert a.info == b.info and "lambda_estimate" in b.info


@pytest.mark.parametrize("method", ["forest_exact", "forest_approx",
                                    "cliques"])
def test_correlation_cluster_matching_and_clique_methods(method):
    rng_ = np.random.default_rng(9)
    n, e = ref_graph.disjoint_cliques([1, 3, 4, 6], gap=1)
    cases = [(400, ref_graph.random_forest(400, rng_)),
             (n, np.concatenate([e, [[1, 5]]])),
             (90, ref_graph.random_arboric(90, 2, rng_)[0])]
    for n, edges in cases:
        rg, tg = _pair(n, edges)
        for lam in (None, 2):
            key = jax.random.PRNGKey(n)
            a = ref_api.correlation_cluster(rg, key=key, method=method,
                                            lam=lam)
            b = api.correlation_cluster(tg, key=_words(key), method=method,
                                        lam=lam, device=CPU)
            assert (a.labels == b.labels).all()
            assert (a.cost, a.method, a.info) == (b.cost, b.method, b.info)


def test_every_reference_name_is_exported():
    assert set(ref_core.__all__) <= set(tcore.__all__)
    assert not api.NOT_PORTED
    for name in ref_core.__all__:
        assert getattr(tcore, name) is not None
