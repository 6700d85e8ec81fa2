"""Kernel B3 of the port, the fused per-graph PIVOT, ≡ the reference.

``repro_torch.kernels.ref.mis_pivot_ref`` is the plain version that defines
what the CUDA kernel ``csrc/mis_pivot.cu`` computes: every greedy-MIS round
and the PIVOT capture of k samples of one graph. Here it is held, per
sample, against the reference's ``greedy_mis_parallel`` (status, rounds),
``assign_to_min_rank_mis_neighbor`` on its MIS and PIVOT's eligible
restriction, for k in {1, 3}, with and without an eligible mask, on
hub-heavy, tiny and edgeless graphs and one of 2^15 + 1 vertices. Integer
outputs: tolerance 0. The launch plan is checked from shapes alone; the
kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as ref_graph
from repro.core import mis as ref_mis
from repro_torch.core import api, graph, mis
from repro_torch.core import rng as trng
from repro_torch.kernels import mis_pivot as mp
from repro_torch.kernels import ref

CPU = "cpu"
# ``core`` re-exports the function ``pivot`` under the module's name.
tpivot = importlib.import_module("repro_torch.core.pivot")


def _cases():
    """(name, n, edges, cap): ``cap`` is the degree bound of the eligible
    mask (the Theorem 26 cap) in the masked runs."""
    rng = np.random.default_rng(5)
    out = [("star40", 40, ref_graph.star(40), 3),        # hub above the cap
           ("path9", 9, ref_graph.path(9), 1)]
    n, e = ref_graph.barbell(5)
    out.append(("barbell", n, e, 4))
    n, e = ref_graph.disjoint_cliques([3, 1, 4, 2], gap=1)
    out.append(("cliques", n, e, 2))
    out.append(("empty", 6, np.zeros((0, 2), np.int64), 0))
    out.append(("single", 1, np.zeros((0, 2), np.int64), 0))
    out.append(("arboric60", 60, ref_graph.random_arboric(60, 3, rng)[0], 5))
    out.append(("arboric32769", 2**15 + 1,
                ref_graph.random_arboric(2**15 + 1, 2, rng)[0], 6))
    return out


CASES = _cases()
IDS = [c[0] for c in CASES]


def _keys(seed, k):
    key = jax.random.PRNGKey(seed)
    return [jax.random.fold_in(key, i) for i in range(k)]


def _words(key):
    return np.asarray(jax.random.key_data(key))


def _reference(rg, keys, elig):
    """Per sample: the reference's status, labels (eligible-restricted) and
    rounds, and the reference's ranks. Without a mask every vertex is
    eligible; the all-true mask, which the reference's ``None`` stands
    for, lets both runs of a graph share one compiled loop."""
    n = rg.n
    el = jnp.ones((n,), bool) if elig is None else jnp.asarray(elig)
    out = []
    for key in keys:
        ranks = ref_mis.random_permutation_ranks(n, key)
        st = ref_mis.greedy_mis_parallel(rg, ranks, eligible=el)
        labels = np.asarray(ref_mis.assign_to_min_rank_mis_neighbor(
            rg, ranks, st.status == ref_mis.IN_MIS))
        if elig is not None:
            labels = np.where(elig, labels, np.arange(n))
        out.append((np.asarray(st.status), labels, int(st.rounds),
                    np.asarray(ranks)))
    return out


@pytest.mark.parametrize("masked", [False, True], ids=["all", "capped"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("name,n,edges,cap", CASES, ids=IDS)
def test_plain_mis_pivot_matches_reference(name, n, edges, cap, k, masked):
    rg = ref_graph.build_graph(n, edges)
    tg = graph.build_graph(n, edges, device=CPU)
    elig = np.asarray(rg.deg) <= cap if masked else None
    keys = _keys(n + k, k)
    ranks = mis.random_permutation_ranks_batch(
        n, [_words(key) for key in keys], device=CPU)
    eligible = torch.ones(n, dtype=torch.bool) if elig is None \
        else torch.from_numpy(elig)
    status, labels, rounds = mp.mis_pivot_csr(tg.row_offsets, tg.dst, ranks,
                                              eligible)
    assert status.dtype == labels.dtype == rounds.dtype == torch.int32
    assert status.shape == labels.shape == (k, n) and rounds.shape == (k,)
    for s, (st, lab, rd, rk) in enumerate(_reference(rg, keys, elig)):
        assert (ranks[s].numpy() == rk).all()
        assert (status[s].numpy() == st).all()
        assert (labels[s].numpy() == lab).all()
        assert int(rounds[s]) == rd


@pytest.mark.parametrize("name,n,edges,cap", CASES[:4] + CASES[6:7],
                         ids=IDS[:4] + IDS[6:7])
def test_host_loop_and_fused_agree(name, n, edges, cap):
    """The round-by-round host loop (the port's earlier path, kept as the
    fused kernel's yardstick) gives the fused call's MIS and rounds."""
    tg = graph.build_graph(n, edges, device=CPU)
    elig = tg.deg <= cap
    ranks = mis.random_permutation_ranks(n, trng.PRNGKey(n), device=CPU)
    loop = mis._greedy_mis_host_loop(tg, ranks, eligible=elig)
    fused = mis.greedy_mis_parallel(tg, ranks, eligible=elig)
    assert torch.equal(loop.status, fused.status)
    assert loop.rounds == fused.rounds


@pytest.mark.parametrize("k", [1, 4])
def test_plain_mis_pivot_no_vertex(k):
    tg = graph.build_graph(0, np.zeros((0, 2), np.int64), device=CPU)
    status, labels, rounds = mp.mis_pivot_csr(
        tg.row_offsets, tg.dst, torch.zeros((k, 0), dtype=torch.int32),
        torch.zeros(0, dtype=torch.bool))
    assert status.shape == labels.shape == (k, 0)
    assert rounds.tolist() == [0] * k


def test_per_graph_path_draws_once_and_calls_b3_once(monkeypatch):
    """``correlation_cluster`` with best-of-3 draws the three rank rows in
    one batched call and runs all three samples in one B3 call."""
    calls = {"draw": 0, "b3": 0}
    draw, b3 = trng.permutation_batch, tpivot.mis_pivot_csr

    def counted_draw(keys, n, device):
        calls["draw"] += 1
        assert len(keys) == 3
        return draw(keys, n, device)

    def counted_b3(*args):
        calls["b3"] += 1
        assert args[2].shape[0] == 3
        return b3(*args)

    monkeypatch.setattr(trng, "permutation_batch", counted_draw)
    monkeypatch.setattr(tpivot, "mis_pivot_csr", counted_b3)
    n, edges, _ = CASES[6][1:]
    tg = graph.build_graph(n, edges, device=CPU)
    res = api.correlation_cluster(tg, key=trng.PRNGKey(2), lam=1,
                                  num_samples=3, device=CPU)
    assert calls == {"draw": 1, "b3": 1}
    assert res.info["num_samples"] == 3 and res.labels.shape == (n,)


# Launch plans, from shapes alone (no card needed).
@pytest.mark.parametrize("k,n", [(1, 0), (1, 1), (3, 64), (3, 1000),
                                 (8, 4096), (3, 32768), (100, 46489)])
def test_block_plan_holds_the_state_in_shared_memory(k, n):
    plan = mp.block_plan(k, n)
    assert plan.route == "block" and plan.blocks == k
    assert plan.smem_bytes == 5 * n <= mp.SMEM_BYTES_MAX
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 1024
    assert plan.threads >= min(n, 1024)


@pytest.mark.parametrize("k,n", [(1, 0), (3, 64), (8, 1000), (3, 4096),
                                 (1, 5632), (100, 4000), (65, 5632)])
def test_launch_plan_block_route_for_small_graphs(k, n):
    assert n <= mp.BLOCK_MAX_N
    plan = mp.mis_launch_plan(k, n)
    assert plan == mp.block_plan(k, n) and plan.samples == k


@pytest.mark.parametrize("k,n", [(1, 5633), (3, 8192), (3, 32768),
                                 (3, 46000), (3, 60000), (64, 100000),
                                 (1, 10**6), (65, 50000), (100, 20000)])
def test_launch_plan_grid_route_for_large_graphs(k, n):
    plan = mp.mis_launch_plan(k, n)
    assert plan == mp.grid_plan(k, n)
    assert plan.route == "grid" and plan.smem_bytes == 0
    assert plan.threads == 1024
    assert plan.samples == min(k, mp.MAX_GRID_SAMPLES)
    # At most one block an SM (the card holds one 1,024-thread block of
    # the kernel an SM at once), none idle: each has items.
    assert 1 <= plan.blocks <= mp.SMS
    assert (plan.blocks - 1) * plan.threads < plan.samples * n


def test_grid_route_takes_any_k_in_groups_of_64():
    # A sample's state outgrows a block's shared memory above n = 46,489;
    # the grid route then takes any k, 64 samples a launch.
    assert mp.block_plan(1, 46490) is None
    for k in (1, 64, 65, 128, 1000):
        plan = mp.mis_launch_plan(k, 46490)
        assert plan.route == "grid" and plan.samples == min(k, 64)
        assert plan.args() == (mp.ROUTES["grid"], 1024, plan.blocks, 0)
    assert mp.block_plan(70, 100).args() == (mp.ROUTES["block"], 128, 70,
                                             500)


def test_wrapper_rejects_bad_inputs_on_cpu():
    tg = graph.build_graph(5, ref_graph.path(5), device=CPU)
    ranks = torch.arange(5, dtype=torch.int32).repeat(2, 1)
    elig = torch.ones(5, dtype=torch.bool)
    ok = mp.mis_pivot_csr(tg.row_offsets, tg.dst, ranks, elig)
    assert torch.equal(ok[0], ref.mis_pivot_ref(tg.row_offsets, tg.dst,
                                                ranks, elig)[0])
    bad = [
        (tg.row_offsets, tg.dst, ranks.long(), elig),          # dtype
        (tg.row_offsets, tg.dst, ranks[0], elig),              # 1-D ranks
        (tg.row_offsets[:-1], tg.dst, ranks, elig),            # offsets
        (tg.row_offsets, tg.dst, ranks, elig.int()),           # mask dtype
        (tg.row_offsets, tg.dst, ranks, elig[:4]),             # mask shape
        (tg.row_offsets, tg.dst.long(), ranks, elig),          # ids dtype
        (tg.row_offsets, tg.dst, ranks[:0], elig),             # no sample
        (tg.row_offsets, tg.dst, ranks, elig.to("meta")),      # device
    ]
    for args in bad:
        with pytest.raises(ValueError):
            mp.mis_pivot_csr(*args)
