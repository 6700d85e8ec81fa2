"""Per-graph path of the port ≡ the reference, bit-exactly, on the CPU.

Graph layout, greedy MIS (status and rounds), PIVOT engines, the Theorem 26
degree cap, the cost and ``correlation_cluster`` (labels, cost, depth,
picked sample, the whole info dict) for the same numpy-made inputs and the
same keys. Integer outputs, so every comparison is exact equality.
"""

import importlib

import jax
import numpy as np
import pytest
import torch

from repro.core import api as ref_api
from repro.core import arboricity as ref_arb
from repro.core import cost as ref_cost
from repro.core import degree_cap as ref_cap
from repro.core import graph as ref_graph
from repro.core import mis as ref_mis
from repro_torch.core import api, arboricity, cost, degree_cap, graph, mis
from repro_torch.core import rng as trng
from repro_torch import util

CPU = "cpu"
# ``core`` re-exports the function ``pivot`` under the module's name.
ref_pivot = importlib.import_module("repro.core.pivot")
tpivot = importlib.import_module("repro_torch.core.pivot")


def _words(key):
    return np.asarray(jax.random.key_data(key))


def _cases():
    """(name, n, edges) with λ-bounded, hub-heavy and tiny graphs."""
    rng = np.random.default_rng(0)
    out = []
    for n, lam in ((30, 1), (45, 2), (60, 3)):
        edges, _ = ref_graph.random_arboric(n, lam, rng)
        out.append((f"arboric{n}", n, edges))
    out.append(("star40", 40, ref_graph.star(40)))     # hub above 12λ
    n, e = ref_graph.barbell(5)
    out.append(("barbell", n, e))
    out.append(("gnp20", 20, ref_graph.gnp(20, 0.3, rng)))
    return out


CASES = _cases()
IDS = [c[0] for c in CASES]


def _pair(n, edges, pad_to=None):
    return (ref_graph.build_graph(n, edges, pad_to=pad_to),
            graph.build_graph(n, edges, pad_to=pad_to, device=CPU))


@pytest.mark.parametrize("pad_to", [None, 300])
def test_build_graph_layout_identical(pad_to):
    rng = np.random.default_rng(1)
    edges = np.concatenate([ref_graph.random_arboric(50, 3, rng)[0],
                            [[3, 3], [4, 7], [7, 4]]])   # loop + duplicate
    rg, tg = _pair(50, edges, pad_to=pad_to)
    assert (rg.n, rg.m) == (tg.n, tg.m)
    for f in ("src", "dst", "row_offsets", "deg", "eid"):
        t = getattr(tg, f)
        assert t.dtype == torch.int32
        assert (t.numpy() == np.asarray(getattr(rg, f))).all(), f
    assert (tg.undirected_edges() == rg.undirected_edges()).all()
    assert tg.max_degree() == rg.max_degree()


def test_generators_identical():
    for fn, args in [("random_forest", (300,)), ("random_arboric", (200, 3)),
                     ("gnp", (30, 0.2)), ("scale_free", (80, 2))]:
        a = getattr(ref_graph, fn)(*args, rng=np.random.default_rng(7))
        b = getattr(graph, fn)(*args, rng=np.random.default_rng(7))
        a = a[0] if isinstance(a, tuple) else a
        b = b[0] if isinstance(b, tuple) else b
        assert (np.asarray(a) == np.asarray(b)).all(), fn
    assert (graph.star(9) == ref_graph.star(9)).all()
    assert (graph.path(9) == ref_graph.path(9)).all()
    assert graph.barbell(4)[0] == ref_graph.barbell(4)[0]
    assert (graph.disjoint_cliques([3, 1, 4], gap=1)[1]
            == ref_graph.disjoint_cliques([3, 1, 4], gap=1)[1]).all()


@pytest.mark.parametrize("name,n,edges", CASES, ids=IDS)
def test_greedy_mis_parallel_and_capture(name, n, edges):
    rg, tg = _pair(n, edges)
    key = jax.random.PRNGKey(n)
    ranks = ref_mis.random_permutation_ranks(n, key)
    tranks = mis.random_permutation_ranks(n, _words(key), device=CPU)
    assert (tranks.numpy() == np.asarray(ranks)).all()
    # Half the cases restrict to an eligible subgraph (the degree cap).
    elig = np.asarray(rg.deg) <= 6 if IDS.index(name) % 2 else None
    rs = ref_mis.greedy_mis_parallel(
        rg, ranks, eligible=None if elig is None else jax.numpy.asarray(elig))
    ts = mis.greedy_mis_parallel(
        tg, tranks, eligible=None if elig is None else torch.from_numpy(elig))
    assert (ts.status.numpy() == np.asarray(rs.status)).all()
    assert ts.rounds == int(rs.rounds)
    in_mis = ts.status == mis.IN_MIS
    labels = mis.assign_to_min_rank_mis_neighbor(tg, tranks, in_mis)
    expect = ref_mis.assign_to_min_rank_mis_neighbor(
        rg, ranks, jax.numpy.asarray(in_mis.numpy()))
    assert (labels.numpy() == np.asarray(expect)).all()
    # Oracles are copies: same answers on the same ranks.
    assert (mis.greedy_mis_sequential(tg, tranks.numpy())
            == ref_mis.greedy_mis_sequential(rg, np.asarray(ranks))).all()
    assert (mis.pivot_sequential(tg, tranks.numpy())
            == ref_mis.pivot_sequential(rg, np.asarray(ranks))).all()


@pytest.mark.parametrize("name,n,edges", CASES, ids=IDS)
def test_pivot_engines_and_degree_cap(name, n, edges):
    rg, tg = _pair(n, edges)
    key = jax.random.PRNGKey(3 * n)
    for engine in ("rounds", "sequential"):
        a = ref_pivot.pivot(rg, key, engine=engine)
        b = tpivot.pivot(tg, _words(key), engine=engine)
        assert (a.labels == b.labels).all() and a.depth == b.depth
        assert (a.in_mis == b.in_mis).all()
    a = ref_cap.degree_capped_pivot(rg, lam=1, key=key)
    b = degree_cap.degree_capped_pivot(tg, lam=1, key=_words(key))
    assert (a.labels == b.labels).all()
    assert (a.high_mask == b.high_mask).all()
    assert a.threshold == b.threshold and a.inner.depth == b.inner.depth
    assert arboricity.arboricity_bounds(tg) == ref_arb.arboricity_bounds(rg)
    assert cost.clustering_cost(tg, b.labels) == \
        ref_cost.clustering_cost(rg, a.labels)
    assert cost.clustering_cost_split(tg, b.labels) == \
        ref_cost.clustering_cost_split(rg, a.labels)


@pytest.mark.parametrize("method", ["pivot", "pivot_raw"])
@pytest.mark.parametrize("num_samples", [1, 3])
def test_correlation_cluster_matches_reference(method, num_samples):
    for name, n, edges in CASES[:4]:
        rg, tg = _pair(n, edges)
        key = jax.random.PRNGKey(n + num_samples)
        a = ref_api.correlation_cluster(rg, key=key, method=method,
                                        num_samples=num_samples)
        b = api.correlation_cluster(tg, key=_words(key), method=method,
                                    num_samples=num_samples, device=CPU)
        assert (a.labels == b.labels).all(), name
        assert a.cost == b.cost and a.info == b.info, (name, a.info, b.info)
    # Raw edge input builds the graph on the requested device.
    c = api.correlation_cluster(edges, n=n, key=trng.PRNGKey(1), device=CPU)
    assert c.labels.shape == (n,)


def test_not_ported_methods_and_device_rule(monkeypatch):
    g = graph.build_graph(4, ref_graph.path(4), device=CPU)
    for method, item in api.NOT_PORTED.items():
        with pytest.raises(NotImplementedError, match=item):
            api.correlation_cluster(g, method=method, device=CPU)
    with pytest.raises(ValueError):
        api.correlation_cluster(g, method="nope", device=CPU)
    with pytest.raises(NotImplementedError, match="A14"):
        tpivot.pivot(g, trng.PRNGKey(0), engine="phased")
    # No silent CPU fallback: the default device is CUDA.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        util.resolve_device(None)
    with pytest.raises(RuntimeError):
        api.correlation_cluster(g)
    with pytest.raises(RuntimeError):
        graph.build_graph(4, ref_graph.path(4))
    assert util.resolve_device("cpu") == torch.device("cpu")
