"""Clustering-as-a-service demo: streaming graphs through the engine API.

    PYTHONPATH=src python -m repro_torch.examples.batch_serving \\
        [--device cpu]

The port of ``examples/batch_serving.py``: a stream of small similarity
graphs arriving one at a time, served by ``ClusterBatcher`` under the
full-bucket, deadline, adaptive, coalescing and cost-aware policies, on
the sync and the async executors. Every result is bit-identical to
running ``correlation_cluster`` on that graph alone, under every policy
and executor.
"""


import argparse
import time

import numpy as np

from repro_torch.core import PRNGKey, build_graph
from repro_torch.core.graph import random_arboric
from repro_torch.serve.cluster_batcher import (
    AdmissionRejected,
    ClusterBatcher,
    ClusterRequest,
)


def make_stream(n_requests: int, seed: int = 42, device=None):
    rng = np.random.default_rng(seed)
    for uid in range(n_requests):
        n = int(rng.integers(8, 64))
        edges, _ = random_arboric(n, int(rng.integers(1, 4)), rng)
        yield ClusterRequest(uid=uid, graph=build_graph(n, edges,
                                                        device=device),
                             key=PRNGKey(uid))


def drive(batcher: ClusterBatcher, n_requests: int, label: str):
    print(f"\n--- {label} ---")
    device = batcher.device
    t0 = time.perf_counter()
    waits, retired = [], 0

    def account(done):
        nonlocal retired
        now = batcher.clock()   # same clock base as req.admitted_at
        for r in done:
            retired += 1
            waits.append(now - r.admitted_at)
            if retired % 25 == 0:
                print(f"  uid={r.uid:3d} n={r.graph.n:3d} "
                      f"clusters={len(np.unique(r.result.labels)):3d} "
                      f"cost={r.result.cost:4d} "
                      f"bucket={r.result.info['bucket']}")

    for req in make_stream(n_requests, device=device):
        while True:
            try:
                account(batcher.admit(req))
                break
            except AdmissionRejected:
                # Backpressure: the executor is at max_in_flight. Harvest
                # whatever finished and retry (a front-end would 429 here).
                done = batcher.retire()
                account(done)
                if not done:
                    time.sleep(0.001)   # let the device catch up
        account(batcher.poll())
    account(batcher.flush())
    dt = time.perf_counter() - t0
    batcher.close()

    s = batcher.stats
    print(f"served {retired} queries in {dt:.2f}s "
          f"({retired / dt:.1f} graphs/s)  [policy={s.policy}]")
    print(f"flushes={s.flushes} (deadline={s.deadline_flushes}, "
          f"coalesced={s.coalesced_flushes})  "
          f"buckets_seen={s.buckets_seen}  padded_slots={s.padded_slots}  "
          f"pad_vertex_waste={s.pad_vertex_waste}")
    if s.stolen_requests:
        print(f"work-stealing: {s.stolen_requests} requests promoted into "
              "larger-bucket flushes")
    if s.rejected or s.in_flight_peak:
        print(f"backpressure: rejected={s.rejected}  "
              f"in_flight_peak={s.in_flight_peak}")
    if s.latency.total_flushes:
        print(f"flush latency: wall EWMA={s.latency.ewma_wall * 1e3:.1f}ms  "
              f"assemble EWMA={s.latency.ewma_assemble * 1e3:.1f}ms"
              + (f"  build EWMA={s.latency.ewma_build * 1e3:.2f}ms"
                 if s.latency.total_builds else ""))
    print(f"max in-engine wait: {max(waits):.3f}s")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    n_requests = 100
    base = dict(max_batch=16, num_samples=2, device=args.device)
    print(f"streaming {n_requests} clustering queries (max_batch=16)...")
    drive(ClusterBatcher(**base),
          n_requests, "full-bucket policy (throughput mode)")
    drive(ClusterBatcher(**base, max_wait=0.05),
          n_requests, "deadline policy (max_wait=50ms, bounded tail)")
    # Pipelined serving: non-blocking flush dispatch + bounded in-flight
    # work. The same stream, same answers — packing just overlaps compute.
    drive(ClusterBatcher(**base, max_wait=0.05, executor="async",
                         max_in_flight=4),
          n_requests, "async executor (pipelined flushes, max_in_flight=4)")
    # Self-tuning pipelining: the adaptive policy derives the in-flight
    # window from the flush-latency telemetry instead of the knob above.
    drive(ClusterBatcher(**base, max_wait=0.05, executor="async",
                         policy="adaptive"),
          n_requests, "adaptive policy (latency-derived in-flight window)")
    # Work-stealing: requests stuck in a rare shape bucket ride a hot
    # bucket's flush at a promoted (R, W) shape — same answers, bounded
    # wait for the starved bucket.
    drive(ClusterBatcher(**base, max_wait=0.05, policy="coalesce"),
          n_requests, "coalescing policy (cross-bucket work-stealing)")
    # Priced work-stealing: same steals, but only when the wait saved
    # covers the pad/compile cost added; plus shape-heat eviction hints
    # to the compiled-program cache.
    cost_batcher = ClusterBatcher(**base, max_wait=0.05,
                                  policy="cost")
    drive(cost_batcher, n_requests,
          "cost-aware coalescing (priced steals + eviction hints)")
    print(f"steal pricing: {cost_batcher.policy.cost_stats()}")


if __name__ == "__main__":
    main()
