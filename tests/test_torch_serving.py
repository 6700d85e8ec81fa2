"""The port's clustering serving layer ≡ the reference's, on the CPU.

* ``graph_fingerprint``: the digest and payload of a port plan and key
  equal the reference's for the same graph and jax key;
* ``BucketBufferPool``: a leased buffer is never handed out again until
  released;
* the async executor and a sharded executor over two CPU devices return
  the sync executor's results bit for bit, and the program registry keeps
  the reference's LRU, pin and capacity rules;
* arrival traces generated as ``tests/test_scheduler.py`` generates them,
  replayed through the reference's and the port's ``ClusterBatcher`` on a
  virtual clock, with pivot and precluster requests and exact repeats:
  every policy's results and flush decisions equal the reference's (for
  ``adaptive`` and ``cost``, which read measured walls, under the same
  fixed telemetry and program-residency answers on both sides);
* result-cache hits and single-flight riders equal cold flushes.

Every output compared is an integer: equality is exact.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import jax
from repro.core import graph as ref_graph
from repro.core import executor as ref_executor
from repro.core import plan as ref_plan
from repro.serve import cluster_batcher as ref_cb
from repro.util import VirtualClock
from repro_torch.core import (AsyncExecutor, BucketBufferPool,
                              ShardedExecutor, SyncExecutor, executor,
                              graph, plan, correlation_cluster_batch)
from repro_torch.core import rng as trng
from repro_torch.kernels import neighbor_min as nm
from repro_torch.serve import ClusterBatcher, ClusterRequest, serve_all
from repro_torch.serve.engine import AdmissionRejected
from repro_torch.serve.resultcache import ResultCache

CPU = "cpu"


def _words(key):
    return np.asarray(jax.random.key_data(key))


@pytest.fixture(autouse=True)
def _unpin_program_registry():
    """The cost policy pins shapes in the process-global registry; never
    let pins leak between tests."""
    yield
    for bucket in executor.program_cache_info()["pinned"]:
        while executor.program_cache_unpin(tuple(bucket)):
            pass


def _edges(n, seed, lam=1):
    edges, _ = ref_graph.random_arboric(n, lam, np.random.default_rng(seed))
    return edges


@pytest.mark.parametrize("method,objective,k", [
    ("pivot", "disagree", 1), ("pivot_raw", "disagree", 3),
    ("precluster", "minmax", 2)])
def test_fingerprint_equals_reference(method, objective, k):
    for n, seed in ((1, 0), (17, 1), (64, 2), (200, 3)):
        e = _edges(n, seed, lam=2)
        rp = ref_plan.plan_graph(ref_graph.build_graph(n, e), method=method)
        tp = plan.plan_graph(graph.build_graph(n, e, device=CPU),
                             method=method)
        key = jax.random.PRNGKey(n + seed)
        a = ref_plan.graph_fingerprint(rp, key, method=method,
                                       num_samples=k, objective=objective)
        b = plan.graph_fingerprint(tp, _words(key), method=method,
                                   num_samples=k, objective=objective)
        assert a.digest == b.digest and a.payload == b.payload
        c = plan.graph_fingerprint(tp, trng.fold_in(_words(key), 1),
                                   method=method, num_samples=k,
                                   objective=objective)
        assert c.digest != b.digest


def test_pool_never_hands_out_a_leased_buffer():
    pool = BucketBufferPool()
    a = pool.acquire(4, 8, 4)
    b = pool.acquire(4, 8, 4)
    assert a.arrays["ell"] is not b.arrays["ell"]
    assert pool.leased == 2 and pool.n_buffers == 2
    a.release()
    a.release()                                   # idempotent
    c = pool.acquire(4, 8, 4)
    assert c.arrays["ell"] is a.arrays["ell"]      # reused once free
    assert c.arrays["ell"] is not b.arrays["ell"]
    d = pool.acquire(2, 8, 4)                      # another shape
    assert d.arrays["ell"].shape == (2, 8, 4)
    assert d.arrays["ranks"].dtype == np.int32
    assert d.arrays["elig"].dtype == bool
    for lease in (b, c, d):
        lease.release()
    assert pool.leased == 0 and pool.n_buffers == 3
    assert not pool.pinned                          # pinned only for CUDA


def _graphs(ns, seed=0):
    rng = np.random.default_rng(seed)
    return [graph.build_graph(int(n), ref_graph.random_arboric(
        int(n), 2, rng)[0], device=CPU) for n in ns]


@pytest.mark.parametrize("method", ["pivot", "precluster"])
def test_async_and_sharded_equal_sync(method):
    gs = _graphs(np.random.default_rng(4).integers(3, 140, 30))
    keys = [trng.PRNGKey(i) for i in range(len(gs))]
    want = correlation_cluster_batch(gs, keys=keys, method=method,
                                     num_samples=3, device=CPU)
    two = ShardedExecutor([CPU, CPU])
    assert two.group_pad(1) == 2 and two.group_pad(3) == 4
    for ex in ("async", two, SyncExecutor(device=CPU)):
        got = correlation_cluster_batch(gs, keys=keys, method=method,
                                        num_samples=3, device=CPU,
                                        executor=ex)
        for a, b in zip(want, got):
            assert (a.labels == b.labels).all() and a.cost == b.cost
            assert a.info == b.info
    two.close()
    with pytest.raises(ValueError, match="power-of-two"):
        ShardedExecutor([CPU] * 3)


def test_async_handles_retire_in_order_and_release_leases():
    gs = _graphs([20, 21, 22, 23])
    plans = [plan.promote_plan(plan.plan_graph(g), 32, 8) for g in gs]
    pool = BucketBufferPool()
    ex = AsyncExecutor(device=CPU)
    keys = [[trng.PRNGKey(i)] for i in range(4)]
    h1, _ = executor.pack_and_submit(plans[:2], keys[:2], 1, ex, pool=pool,
                                     payload="a")
    h2, _ = executor.pack_and_submit(plans[2:], keys[2:], 1, ex, pool=pool,
                                     payload="b")
    assert ex.in_flight == 2 and pool.leased == 2 and pool.n_buffers == 2
    assert h1.inflight_at_submit == 1 and h2.inflight_at_submit == 2
    assert h1.returned_seconds is not None
    done = ex.drain()
    assert [h.payload for h in done] == ["a", "b"] and ex.in_flight == 0
    for h in done:
        assert h.result()[0].shape == (2, 32) and h.harvested and h.ready()
        assert h.wall_seconds is not None and h.shape == (2, 32, 8)
    assert pool.leased == 0
    ex.close()


def test_program_registry_lru_and_pins():
    gs = _graphs([5, 9, 17, 33])
    shapes = [(1,) + plan.plan_graph(g).bucket for g in gs]
    assert len(set(shapes)) == 4
    prev = executor.set_program_cache_capacity(2)
    try:
        for g in gs:
            correlation_cluster_batch([g], device=CPU)
        info = executor.program_cache_info()
        assert info["size"] == 2 and info["evictions"] >= 2
        assert executor.program_cache_contains(shapes[3], 1)
        assert not executor.program_cache_contains(shapes[0], 1)
        assert executor.program_cache_contains(shapes[3], 1,
                                               method="pivot_raw")
        assert not executor.program_cache_contains(shapes[3], 1,
                                                   method="precluster")
        assert executor.program_cache_pin(shapes[2][1:]) == 1
        correlation_cluster_batch([gs[0]], device=CPU)   # evicts shapes[3]
        assert executor.program_cache_contains(shapes[2], 1)
        assert not executor.program_cache_contains(shapes[3], 1)
        assert executor.program_cache_touch(shapes[2][1:]) == 1
        assert executor.program_cache_unpin(shapes[2][1:])
        assert not executor.program_cache_unpin(shapes[2][1:])
    finally:
        executor.set_program_cache_capacity(prev)
    with pytest.raises(ValueError):
        executor.set_program_cache_capacity(0)


def test_registry_and_launch_counts_survive_concurrent_threads():
    """The dispatch threads enter registry keys and count kernel launches
    beside the main thread: under a tiny switch interval, 16 threads × 200
    entries lose no update."""
    old = sys.getswitchinterval()
    prev = executor.set_program_cache_capacity(10_000)
    base = executor.program_cache_info()["compiles"]
    counted = nm.launches["label_agree_ell_batch"]

    def work(t):
        for i in range(200):
            executor._record_run((1, 1 << 20, 1000 * t + i), 1, "pivot",
                                 "disagree")
            nm._count("label_agree_ell_batch")

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert executor.program_cache_info()["compiles"] == base + 3200
        assert nm.launches["label_agree_ell_batch"] == counted + 3200
    finally:
        sys.setswitchinterval(old)
        executor.set_program_cache_capacity(prev)
        nm.launches["label_agree_ell_batch"] = counted


# ---------------------------------------------------------------------------
# Arrival traces through the reference's and the port's ClusterBatcher.
# ---------------------------------------------------------------------------

def _trace(seed, policy, dense=False):
    """(uid, n, graph seed, key seed, method, gap s) per request, drawn as
    ``tests/test_scheduler.py``'s random traces draw them, with every third
    request precluster and a repeat of an earlier request now and then.
    ``dense``: 22 requests at most 4 ms apart over R = 8..32 with a 20 ms
    deadline, so that deadline flushes find stragglers to steal."""
    rng = np.random.default_rng(seed)
    gap_ms = 4.0 if dense else float(rng.uniform(0, 30))
    wait_ms = 20.0 if dense else float(rng.uniform(1, 60))
    rows = []
    for uid in range(22 if dense else int(rng.integers(8, 14))):
        gap = gap_ms / 1e3 * float(rng.random())
        if rows and rng.random() < 0.2:
            rows.append((uid,) + rows[int(rng.integers(len(rows)))][1:5]
                        + (gap,))
            continue
        n = int(rng.integers(5, 33 if dense else 15))
        method = "precluster" if uid % 3 == 2 else "pivot"
        rows.append((uid, n, seed * 31 + uid, uid, method, gap))
    return rows, (wait_ms / 1e3 if policy != "full" else None)


def _drive(engine, rows, clock, make_req):
    """Admit the trace on a virtual clock as the reference tests do: the
    policy logs each decision, retries on rejection, a poll per arrival."""
    log = []
    select = engine.policy.select_flushes

    def logged(buckets, now, telemetry):
        out = select(buckets, now, telemetry)
        log.extend((d.bucket, d.count, tuple(d.steal), d.deadline)
                   for d in out)
        return out

    engine.policy.select_flushes = logged
    retired = []
    for uid, n, gseed, kseed, method, gap in rows:
        clock.advance(gap)
        req = make_req(uid, n, gseed, kseed, method)
        while True:
            try:
                retired += engine.admit(req)
                break
            except (AdmissionRejected, ref_cb.AdmissionRejected):
                retired += engine.retire()
        retired += engine.poll()
    retired += engine.flush()
    return {r.uid: r for r in retired}, log


def _fixed_telemetry(engine):
    """Feed ``engine``'s flush telemetry walls set by the bucket's R in
    place of measured ones, and no compile walls. Measured walls are the
    host's, not the trace's, and the port has no compiled programs to
    time, so only under the same telemetry can ``adaptive`` and ``cost``
    be held to the reference's decisions."""
    lat = engine.stats.latency
    record, record_build = lat.record, lat.record_build

    def fixed(bucket, wall_s, assemble_s=0.0, depth=1, compile_s=None):
        record(bucket, 1e-3 * bucket[-2], 1e-4 * bucket[-2], depth=depth)

    lat.record = fixed
    lat.record_build = lambda key, build_s: record_build(key, 1e-5)
    lat.record_compile = lambda bucket, wall_s: None


def _fixed_probe(shape, k, *args, **kwargs):
    """The cost model's program-residency probe, one fixed answer a shape
    for both packages, so that both branches of its compile charge run."""
    return sum(int(s) for s in shape) % 2 == 0


@pytest.mark.parametrize("policy", ["full", "deadline", "adaptive",
                                    "coalesce", "cost"])
@pytest.mark.parametrize("seed", [0, 1])
def test_trace_replay_equals_reference(policy, seed, monkeypatch):
    _replay(policy, _trace(seed, policy), monkeypatch)


@pytest.mark.parametrize("policy", ["adaptive", "coalesce", "cost"])
@pytest.mark.parametrize("seed", [4, 6])
def test_dense_trace_replay_equals_reference(policy, seed, monkeypatch):
    """Traces on which ``coalesce`` steals, and ``cost`` takes some steals
    and refuses others: every decision and counter equals the
    reference's."""
    _replay(policy, _trace(seed, policy, dense=True), monkeypatch)


def _replay(policy, trace, monkeypatch):
    rows, max_wait = trace
    kw = dict(max_batch=4, num_samples=2, policy=policy, max_wait=max_wait)
    rclock, tclock = VirtualClock(), VirtualClock()
    ref = ref_cb.ClusterBatcher(clock=rclock, executor="sync", **kw)
    port = ClusterBatcher(clock=tclock, executor="sync", device=CPU, **kw)
    if policy in ("adaptive", "cost"):
        for engine in (ref, port):
            _fixed_telemetry(engine)
        monkeypatch.setattr(ref_executor, "program_cache_contains",
                            _fixed_probe)
        monkeypatch.setattr(executor, "program_cache_contains",
                            _fixed_probe)
    want, ref_log = _drive(ref, rows, rclock, lambda uid, n, gs, ks, m:
                           ref_cb.ClusterRequest(
                               uid=uid, graph=ref_graph.build_graph(
                                   n, _edges(n, gs)),
                               key=jax.random.PRNGKey(ks), method=m))
    got, port_log = _drive(port, rows, tclock, lambda uid, n, gs, ks, m:
                           ClusterRequest(
                               uid=uid, graph=graph.build_graph(
                                   n, _edges(n, gs), device=CPU),
                               key=_words(jax.random.PRNGKey(ks)), method=m))
    assert sorted(got) == sorted(want) == [r[0] for r in rows]
    for uid, r in want.items():
        assert (r.result.labels == got[uid].result.labels).all()
        assert r.result.cost == got[uid].result.cost
        assert r.result.info == got[uid].result.info
        assert r.result.method == got[uid].result.method
    assert port_log == ref_log
    for name in ("flushes", "deadline_flushes", "coalesced_flushes",
                 "stolen_requests", "padded_slots", "pad_vertex_waste",
                 "cache_hits", "subscribed", "buckets_seen"):
        assert getattr(port.stats, name) == getattr(ref.stats, name), name
    for name in ("steals_accepted", "steals_rejected",
                 "pad_entries_avoided"):
        assert getattr(port.policy, name, None) == \
            getattr(ref.policy, name, None), name
    # The same trace through the port's async and sharded executors.
    for ex in ("async", ShardedExecutor([CPU, CPU])):
        clock = VirtualClock()
        eng = ClusterBatcher(clock=clock, executor=ex, device=CPU, **kw)
        again, _ = _drive(eng, rows, clock, lambda uid, n, gs, ks, m:
                          ClusterRequest(
                              uid=uid, graph=graph.build_graph(
                                  n, _edges(n, gs), device=CPU),
                              key=_words(jax.random.PRNGKey(ks)), method=m))
        for uid, r in got.items():
            assert (r.result.labels == again[uid].result.labels).all()
            assert r.result.cost == again[uid].result.cost
        assert eng.pool.leased == 0
        eng.close()
    port.close()


def test_cache_hits_and_riders_equal_cold_flushes():
    cache = ResultCache()
    gs = _graphs([12, 30, 30, 70])
    reqs = [ClusterRequest(uid=i, graph=gs[i % 4], key=trng.PRNGKey(i % 4),
                           method="precluster" if i % 2 else "pivot")
            for i in range(12)]
    eng = ClusterBatcher(max_batch=8, num_samples=3, result_cache=cache,
                         executor="async", device=CPU,
                         objective="minmax")
    out = {r.uid: r for r in serve_all(eng, reqs)}
    assert sorted(out) == list(range(12))
    assert eng.stats.cache_hits + eng.stats.subscribed == 8
    # A second engine on the same cache retires everything at admission.
    warm = ClusterBatcher(max_batch=8, num_samples=3, result_cache=cache,
                          device=CPU, objective="minmax")
    again = {r.uid: r for r in serve_all(warm, [
        ClusterRequest(uid=r.uid, graph=r.graph, key=r.key, method=r.method)
        for r in reqs])}
    assert warm.stats.cache_hits == 12 and warm.stats.flushes == 0
    for uid, r in out.items():
        cold = correlation_cluster_batch(
            [r.graph], keys=[r.key], method=r.method, num_samples=3,
            objective="minmax", device=CPU)[0]
        for res in (r.result, again[uid].result):
            assert (res.labels == cold.labels).all()
            assert res.cost == cold.cost and res.info == cold.info
    eng.close()
    # warmup(autotune=True) tunes on a cache of its own (the tuning cache
    # is process-wide) and needs no card: on the CPU the one candidate is
    # the plain version.
    from repro_torch.kernels import autotune
    prev = autotune.set_tuning_cache(autotune.TuningCache(path=None))
    try:
        warm.warmup(gs, autotune=True)
        assert warm.stats.tuning["sweeps"] > 0
    finally:
        autotune.set_tuning_cache(prev)
    warm.warmup(gs)
    R, W = plan.plan_graph(gs[0]).bucket
    for g_pad in (1, 2, 4, 8):
        assert executor.program_cache_contains((3 * g_pad, R, W), 3,
                                               objective="minmax")


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ClusterBatcher()
