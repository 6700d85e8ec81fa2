"""Algorithm 1 of the port ≡ the reference, bit-exactly, on the CPU.

``algorithm1`` under both subroutines (status, rounds, every ``PhaseStat``
field, the ledger's total and summary, whose floats are compared with
``==``), B3's window mode (its plain version, which the wrapper takes for a
CPU tensor) against the reference's jitted ``_run_window`` on chained
random windows, the Lemma 22 probe, the phased PIVOT engines,
``correlation_cluster(method='pivot_phased')`` at k = 1 and 3, and the
round-by-round ``greedy_mis_rounds_trace`` and ``dependency_depth``. Inputs are
numpy-made from seeds; every comparison is exact equality.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import api as ref_api
from repro.core import degree_cap as ref_cap
from repro.core import graph as ref_graph
from repro.core import mis as ref_mis
from repro.core import phases as ref_phases
from repro_torch.core import api, degree_cap, graph, mis, phases
from repro_torch.kernels import mis_pivot as mp

CPU = "cpu"
# ``core`` re-exports the function ``pivot`` under the module's name.
ref_pivot_mod = importlib.import_module("repro.core.pivot")
tpivot_mod = importlib.import_module("repro_torch.core.pivot")


def _words(key):
    return np.asarray(jax.random.key_data(key))


def _cases():
    """(name, n, edges): λ-arboric graphs of three sizes and a star."""
    rng = np.random.default_rng(18)
    out = []
    for n, lam in ((300, 1), (1000, 2), (2000, 3)):
        out.append((f"arboric{n}", n, ref_graph.random_arboric(n, lam, rng)[0]))
    out.append(("star500", 500, ref_graph.star(500)))
    return out


CASES = _cases()
IDS = [c[0] for c in CASES]


def _pair(n, edges):
    return (ref_graph.build_graph(n, edges),
            graph.build_graph(n, edges, device=CPU))


def _assert_ledger_equal(a, b):
    assert (a.model, a.n, a.extra_rounds) == (b.model, b.n, b.extra_rounds)
    assert [dataclasses.astuple(p) for p in a.phases] == \
        [dataclasses.astuple(p) for p in b.phases]
    assert a.total_rounds == b.total_rounds
    assert a.summary() == b.summary()


@pytest.mark.parametrize("subroutine", ["alg2", "alg3"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_algorithm1_matches_reference(case, subroutine):
    name, n, edges = case
    rg, tg = _pair(n, edges)
    key = jax.random.PRNGKey(n + 1)
    s1, r1, l1 = ref_phases.algorithm1(rg, key=key, subroutine=subroutine)
    s2, r2, l2 = phases.algorithm1(tg, key=_words(key), subroutine=subroutine)
    assert (np.asarray(r1) == r2.numpy()).all()
    assert (np.asarray(s1.status) == s2.status.numpy()).all()
    assert int(s1.rounds) == s2.rounds
    _assert_ledger_equal(l1, l2)
    # The phases' output is the global greedy MIS for the same ranks.
    assert (s2.status.numpy() == 1).tolist() == \
        mis.greedy_mis_sequential(tg, r2.numpy()).tolist()


def _windows(n, rng):
    """A chain of windows: empty ones, one whose out-of-window undecided
    vertices a winner removes (the upper half first), random ones, and a
    final [0, n) that resolves the rest."""
    out = [(0, 0), (n // 2, n), (n // 2, n // 2)]
    for _ in range(4):
        lo = int(rng.integers(0, n))
        out.append((lo, lo + int(rng.integers(1, max(2, n // 4)))))
    return out + [(0, n)]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_window_plain_matches_reference_run_window(case):
    name, n, edges = case
    rg, tg = _pair(n, edges)
    key = jax.random.PRNGKey(n + 2)
    ref_ranks = ref_mis.random_permutation_ranks(n, key)
    ranks = torch.from_numpy(np.array(ref_ranks))
    ref_state = ref_mis.MISState(status=jnp.zeros((n,), jnp.int32),
                                 rounds=jnp.int32(0))
    status = torch.zeros(n, dtype=torch.int32)
    rng = np.random.default_rng(n)
    hit_outside = False
    for lo, hi in _windows(n, rng):
        before = status.clone()
        ref_state, depth = ref_phases._run_window_jit(rg, ref_ranks,
                                                      ref_state, lo, hi)
        status, rounds = mp.mis_window_csr(tg.row_offsets, tg.dst, ranks,
                                           status, lo, hi)
        assert (np.asarray(ref_state.status) == status.numpy()).all(), (lo, hi)
        assert depth == int(rounds[0]), (lo, hi)
        outside = (ranks < lo) | (ranks >= hi)
        hit_outside |= bool(((before == 0) & (status == 2) & outside).any())
        if lo == hi:
            assert depth == 0 and torch.equal(before, status)
    assert hit_outside or name.startswith("star")
    # [0, n) from scratch is the whole greedy MIS (the non-window call).
    full = ref_mis.greedy_mis_parallel(rg, ref_ranks)
    status, rounds = mp.mis_window_csr(tg.row_offsets, tg.dst, ranks,
                                       torch.zeros(n, dtype=torch.int32),
                                       0, n)
    assert (np.asarray(full.status) == status.numpy()).all()
    assert int(full.rounds) == int(rounds[0])


@pytest.mark.parametrize("case", CASES[1:3], ids=IDS[1:3])
def test_remaining_max_degree_after_prefix_matches_reference(case):
    name, n, edges = case
    rg, tg = _pair(n, edges)
    ranks = np.asarray(ref_mis.random_permutation_ranks(
        n, jax.random.PRNGKey(3)))
    for t in (100, 500, 1500):
        assert phases.remaining_max_degree_after_prefix(tg, ranks, t) == \
            ref_phases.remaining_max_degree_after_prefix(rg, ranks, t)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_phased_pivot_engines_match_reference(case):
    name, n, edges = case
    rg, tg = _pair(n, edges)
    key = jax.random.PRNGKey(n + 4)
    a = ref_pivot_mod.pivot(rg, key, engine="phased")
    b = tpivot_mod.pivot(tg, _words(key), engine="phased")
    assert (a.labels == b.labels).all() and (a.in_mis == b.in_mis).all()
    assert a.depth == b.depth
    _assert_ledger_equal(a.ledger, b.ledger)
    a = ref_cap.degree_capped_pivot(rg, lam=1, key=key, engine="phased")
    b = degree_cap.degree_capped_pivot(tg, lam=1, key=_words(key),
                                       engine="phased")
    assert (a.labels == b.labels).all()
    assert (a.high_mask == b.high_mask).all() and a.threshold == b.threshold
    assert (a.inner.in_mis == b.inner.in_mis).all()
    assert a.inner.depth == b.inner.depth
    _assert_ledger_equal(a.inner.ledger, b.inner.ledger)


@pytest.mark.parametrize("num_samples", [1, 3])
@pytest.mark.parametrize("lam", [None, 2])
def test_correlation_cluster_pivot_phased_matches_reference(num_samples, lam):
    for name, n, edges in (CASES[0], CASES[3]):
        rg, tg = _pair(n, edges)
        key = jax.random.PRNGKey(n + num_samples)
        a = ref_api.correlation_cluster(rg, key=key, method="pivot_phased",
                                        lam=lam, num_samples=num_samples)
        b = api.correlation_cluster(tg, key=_words(key), lam=lam,
                                    method="pivot_phased",
                                    num_samples=num_samples, device=CPU)
        assert (a.labels == b.labels).all(), name
        assert (a.cost, a.method) == (b.cost, b.method)
        assert a.info == b.info, (name, a.info, b.info)
        assert "ledger" in b.info and "mpc_rounds" in b.info


def test_phased_engine_rules():
    g = graph.build_graph(4, ref_graph.path(4), device=CPU)
    with pytest.raises(ValueError, match="degree cap"):
        tpivot_mod.pivot(g, np.zeros(2, np.uint32), engine="phased",
                         eligible=torch.ones(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="unknown engine"):
        tpivot_mod.pivot(g, np.zeros(2, np.uint32), engine="nope")


@pytest.mark.parametrize("case", CASES[:2] + CASES[3:], ids=IDS[:2] + IDS[3:])
def test_rounds_trace_and_dependency_depth_match_reference(case):
    name, n, edges = case
    rg, tg = _pair(n, edges)
    ranks = np.array(ref_mis.random_permutation_ranks(
        n, jax.random.PRNGKey(n + 6)))
    s1, t1 = ref_mis.greedy_mis_rounds_trace(rg, jnp.asarray(ranks))
    s2, t2 = mis.greedy_mis_rounds_trace(tg, torch.from_numpy(ranks))
    assert (np.asarray(s1.status) == s2.status.numpy()).all()
    assert int(s1.rounds) == s2.rounds and t1 == t2
    assert mis.dependency_depth(tg, ranks) == \
        ref_mis.dependency_depth(rg, ranks) == s2.rounds
