"""The port's edge-sharded engine ≡ the single-device engine, bit for bit.

``distributed_pivot`` at world size 1 (no group, no collective) and on 2
and 4 processes spawned here, each in a gloo group over a ``FileStore``
under ``tmp_path``, raw and under the degree cap, with and without the
int8 ``packed`` hit collective: labels, ``in_mis`` and rounds equal the
reference's single-device ``greedy_mis_parallel`` + PIVOT capture on the
same (edge-masked) graph and ranks. The reference's own distributed
function cannot run on the installed jax (``shard_map(check_rep=...)``);
its docstring (``repro/core/dist.py:21``) states this identity. Then
``correlation_cluster(distributed=True)`` for ``pivot`` and ``pivot_raw``
against the reference's non-distributed call (labels, cost and info), and
the group rules.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from repro.core import api as ref_api
from repro.core import degree_cap as ref_cap
from repro.core import graph as ref_graph
from repro.core import mis as ref_mis
from repro_torch.core import api, dist as tdist, graph

CPU = "cpu"


def _cases():
    """(n, edges, lam): λ-arboric graphs, one with a hub above the cap and
    an odd edge count that no world size divides evenly."""
    rng = np.random.default_rng(14)
    arb = ref_graph.random_arboric(301, 2, rng)[0]
    hubbed = np.concatenate([ref_graph.random_arboric(500, 1, rng)[0],
                             ref_graph.star(500)[:40]])
    return [(301, arb, 2), (500, hubbed, 1), (7, ref_graph.path(7), 1)]


CASES = _cases()
VARIANTS = [(capped, packed) for capped in (False, True)
            for packed in (False, True)]


def _ranks(n, i):
    return np.asarray(ref_mis.random_permutation_ranks(
        n, jax.random.PRNGKey(100 + i)))


def _high(n, edges, lam):
    g = ref_graph.build_graph(n, edges)
    return np.asarray(g.deg) > ref_cap.degree_threshold(lam, 2.0)


def _torch_run(case_i, capped, packed, group=None):
    n, edges, lam = CASES[case_i]
    g = graph.build_graph(n, edges, device=CPU)
    ranks = _ranks(n, case_i)
    if capped:
        return api._distributed_capped(g, ranks, _high(n, edges, lam),
                                       group=group, packed=packed)
    return tdist.distributed_pivot(g, ranks, group=group, packed=packed)


def _reference(case_i, capped):
    """Single-device greedy MIS + capture of the reference on the graph
    whose edges at high vertices are dropped (capped), high vertices
    singletons."""
    n, edges, lam = CASES[case_i]
    high = _high(n, edges, lam) if capped else np.zeros(n, bool)
    keep = ~(high[edges[:, 0]] | high[edges[:, 1]])
    g = ref_graph.build_graph(n, edges[keep])
    ranks = jnp.asarray(_ranks(n, case_i))
    state = ref_mis.greedy_mis_parallel(g, ranks)
    in_mis = state.status == 1
    labels = np.asarray(ref_mis.assign_to_min_rank_mis_neighbor(g, ranks,
                                                                in_mis))
    labels = np.where(high, np.arange(n), labels)
    return labels, np.asarray(in_mis), int(state.rounds)


def _assert_equal(got, want):
    assert (got[0] == want[0]).all() and (got[1] == want[1]).all()
    assert got[2] == want[2]


@pytest.mark.parametrize("capped,packed", VARIANTS)
def test_world_size_one_matches_single_device(capped, packed):
    if dist.is_initialized():
        pytest.skip("a process group is already initialised here")
    for i in range(len(CASES)):
        _assert_equal(_torch_run(i, capped, packed), _reference(i, capped))


def _worker(rank, world, store_path, out_dir):
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    try:
        for i in range(len(CASES)):
            for capped, packed in VARIANTS:
                tdist.reset_stats()
                labels, in_mis, rounds = _torch_run(i, capped, packed)
                n = CASES[i][0]
                assert tdist.stats["all_reduce_bytes"] == \
                    rounds * tdist.round_bytes(n, packed) + 4 * (n + 1)
                np.savez(os.path.join(out_dir, f"{rank}_{i}_{capped}_{packed}"),
                         labels=labels, in_mis=in_mis, rounds=rounds)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", [2, 4])
def test_spawned_gloo_group_matches_single_device(tmp_path, world):
    tmp.spawn(_worker, args=(world, str(tmp_path / "store"), str(tmp_path)),
              nprocs=world, join=True)
    for i in range(len(CASES)):
        for capped, packed in VARIANTS:
            want = _reference(i, capped)
            for rank in range(world):
                got = np.load(tmp_path / f"{rank}_{i}_{capped}_{packed}.npz")
                _assert_equal((got["labels"], got["in_mis"],
                               int(got["rounds"])), want)


@pytest.mark.parametrize("method", ["pivot", "pivot_raw"])
@pytest.mark.parametrize("num_samples", [1, 3])
def test_correlation_cluster_distributed_matches_reference(method,
                                                           num_samples):
    for n, edges, lam in CASES[:2]:
        rg = ref_graph.build_graph(n, edges)
        tg = graph.build_graph(n, edges, device=CPU)
        key = jax.random.PRNGKey(n + num_samples)
        b = api.correlation_cluster(tg, key=np.asarray(jax.random.key_data(
            key)), method=method, lam=lam, num_samples=num_samples,
            device=CPU, distributed=True)
        c = api.correlation_cluster(tg, key=np.asarray(jax.random.key_data(
            key)), method=method, lam=lam, num_samples=num_samples,
            device=CPU)
        # Raw PIVOT is one engine either way. Under the cap the reference's
        # rounds engine holds the same MIS on the eligible vertices, and
        # the same depth wherever an eligible vertex exists: the isolated
        # high vertices win in the first round, which runs regardless.
        a = ref_api.correlation_cluster(rg, key=key, method=method, lam=lam,
                                        num_samples=num_samples)
        assert (a.labels == b.labels).all() and (b.labels == c.labels).all()
        assert a.cost == b.cost == c.cost
        assert a.info == b.info == c.info


def test_group_rules():
    g = graph.build_graph(4, ref_graph.path(4), device=CPU)
    assert tdist.round_bytes(4) == 40 and tdist.round_bytes(4, True) == 25
    if not dist.is_initialized():
        assert tdist.edge_shard_mesh() is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tdist.pow2_device_mesh()
    empty = graph.build_graph(0, np.zeros((0, 2)), device=CPU)
    labels, in_mis, rounds = tdist.distributed_pivot(empty, np.zeros(0))
    assert labels.shape == (0,) and rounds == 0
    labels, _, _ = tdist.distributed_pivot(g, np.arange(4))
    assert labels.tolist() == [0, 0, 2, 2]
