"""Near-duplicate detection via MinHash + the paper's correlation clustering.

This is where the paper's algorithm is a first-class framework feature: the
data pipeline builds a sparse similarity graph over documents (positive
edge ⇔ sketch similarity ≥ τ) and runs **Algorithm 4** (degree-cap +
PIVOT, Corollary 28) to produce a 3-approximate minimum-disagreement
clustering; one representative per cluster survives into the training
stream.

Why correlation clustering and not naive connected components: CC chains
drift (A≈B≈C≈…≈Z merges unrelated Z with A); minimizing disagreements
penalizes both false merges (negative intra-pairs) and false splits
(positive cut edges), and the bounded-arboricity machinery makes it cheap —
similarity graphs of near-dedup workloads are sparse and scale-free, the
paper's own motivating regime (§1).

The port of ``repro/data/dedup.py``. The MinHash, LSH, sharding and quality
code is the reference's numpy, copied unchanged: the int64 products of
:func:`minhash_signatures` wrap exactly as there, so signatures, edges and
shards are bit-equal. The clustering runs on ``device`` (``None`` means
CUDA and raises without it; ``device="cpu"`` runs the plain versions):

* :func:`dedup_corpus` — one graph through the per-graph
  ``correlation_cluster`` (the fused PIVOT kernel, B3, once a call);
* :func:`dedup_corpus_batched` — one graph per component through
  ``correlation_cluster_batch`` (kernels B1 and B2);
* :func:`dedup_corpus_streaming` — the components admitted one at a time
  into a :class:`~repro_torch.serve.cluster_batcher.ClusterBatcher`.

Labels, keep masks, costs, edge counts and ``info`` equal the reference's
for the same corpus and seed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import build_graph, correlation_cluster
from repro_torch.core import correlation_cluster_batch
from repro_torch.core import rng
from repro_torch.core.api import ClusterResult
from repro_torch.util import DeviceLike, resolve_device

from .synthetic import Corpus

_MERSENNE = (1 << 61) - 1


def minhash_signatures(docs, num_hashes: int = 64, shingle: int = 4,
                       seed: int = 0) -> np.ndarray:
    """(n_docs, num_hashes) MinHash over token shingles."""
    rng = np.random.default_rng(seed)
    a = rng.integers(1, _MERSENNE, num_hashes, dtype=np.int64)
    b = rng.integers(0, _MERSENNE, num_hashes, dtype=np.int64)
    sigs = np.full((len(docs), num_hashes), np.iinfo(np.int64).max,
                   dtype=np.int64)
    for i, doc in enumerate(docs):
        if len(doc) < shingle:
            sh = np.array([hash(tuple(doc.tolist()))], dtype=np.int64)
        else:
            win = np.lib.stride_tricks.sliding_window_view(
                np.asarray(doc, np.int64), shingle)
            sh = (win * np.array([1, 1_000_003, 998_244_353, 911_382_323]
                                 [:shingle], np.int64)).sum(1)
        sh = np.unique(sh) % _MERSENNE
        vals = (sh[:, None] * a[None, :] + b[None, :]) % _MERSENNE
        sigs[i] = vals.min(axis=0)
    return sigs


def similarity_edges(sigs: np.ndarray, threshold: float = 0.5,
                     bands: int = 16) -> np.ndarray:
    """LSH banding → candidate pairs → exact signature similarity filter.

    Returns the positive edge list (m, 2). Banding keeps candidate
    generation near-linear (the MPC-friendly part); the final filter makes
    edges ⇔ estimated Jaccard ≥ threshold.
    """
    n, h = sigs.shape
    rows = h // bands
    buckets: dict = {}
    for band in range(bands):
        chunk = sigs[:, band * rows:(band + 1) * rows]
        for i in range(n):
            key = (band, chunk[i].tobytes())
            buckets.setdefault(key, []).append(i)
    cand = set()
    for members in buckets.values():
        if len(members) < 2:
            continue
        for ai in range(len(members)):
            for bi in range(ai + 1, len(members)):
                cand.add((members[ai], members[bi]))
    edges = []
    for u, v in cand:
        sim = float(np.mean(sigs[u] == sigs[v]))
        if sim >= threshold:
            edges.append((u, v))
    return np.asarray(sorted(edges), dtype=np.int64).reshape(-1, 2)


@dataclasses.dataclass
class DedupResult:
    keep: np.ndarray            # bool mask of representatives
    labels: np.ndarray          # cluster per doc
    clustering: ClusterResult
    n_edges: int


def _representatives(labels: np.ndarray) -> np.ndarray:
    """The first document of every cluster, as a keep mask."""
    n = len(labels)
    keep = np.zeros(n, dtype=bool)
    seen = set()
    for i in range(n):
        if labels[i] not in seen:
            seen.add(labels[i])
            keep[i] = True
    return keep


def dedup_corpus(corpus: Corpus, threshold: float = 0.5,
                 num_hashes: int = 64, eps: float = 2.0,
                 method: str = "pivot", distributed: bool = False,
                 seed: int = 0, num_samples: int = 4, group=None,
                 device: DeviceLike = None) -> DedupResult:
    """MinHash → similarity graph → Theorem 26 + PIVOT → representatives.

    ``num_samples``: best-of-k PIVOT (keep the lowest-disagreement draw).
    PIVOT is 3-approx in expectation; a single unlucky permutation can split
    true duplicate groups, so the pipeline takes the min over a few cheap
    independent draws. ``distributed=True`` runs the edge-sharded engine
    over ``group`` (every rank of the group makes the same call; no
    initialised group is world size 1).
    """
    dev = resolve_device(device)
    sigs = minhash_signatures(corpus.docs, num_hashes=num_hashes, seed=seed)
    edges = similarity_edges(sigs, threshold=threshold)
    n = len(corpus.docs)
    g = build_graph(n, edges, device=dev)
    res = correlation_cluster(g, method=method, eps=eps,
                              key=rng.PRNGKey(seed),
                              distributed=distributed, group=group,
                              num_samples=num_samples, device=dev)
    labels = res.labels
    return DedupResult(keep=_representatives(labels), labels=labels,
                       clustering=res, n_edges=g.m)


# ---------------------------------------------------------------------------
# Batched sharded dedup: per-band/per-component subgraphs → batch engine.
# ---------------------------------------------------------------------------


def shard_similarity_graph(n: int, edges: np.ndarray
                           ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Split the similarity graph into independent clustering subproblems.

    The LSH bands only generate candidate pairs inside shared buckets, so
    the verified similarity graph decomposes into many small connected
    components (near-dup groups rarely chain far). Each component is an
    independent correlation-clustering instance: PIVOT never merges
    vertices from different positive components, so clustering the shards
    and stitching labels is exact, and the shards are precisely the small
    same-shaped graphs the batch engine buckets together.

    Returns ``[(global_ids, local_edges), ...]`` for every component with at
    least one edge; isolated vertices stay singleton clusters implicitly.
    """
    parent = np.arange(n, dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:            # path compression
            parent[x], x = root, parent[x]
        return root

    for u, v in edges:
        ru, rv = find(int(u)), find(int(v))
        if ru != rv:
            parent[ru] = rv

    comp_edges: dict = {}
    for u, v in edges:
        comp_edges.setdefault(find(int(u)), []).append((int(u), int(v)))

    shards: List[Tuple[np.ndarray, np.ndarray]] = []
    for root, es in sorted(comp_edges.items()):
        es = np.asarray(es, dtype=np.int64)
        ids = np.unique(es)
        remap = {int(v): i for i, v in enumerate(ids)}
        local = np.array([[remap[int(u)], remap[int(v)]] for u, v in es],
                         dtype=np.int64)
        shards.append((ids, local))
    return shards


def dedup_corpus_batched(corpus: Corpus, threshold: float = 0.5,
                         num_hashes: int = 64, eps: float = 2.0,
                         seed: int = 0, num_samples: int = 4,
                         device: DeviceLike = None) -> DedupResult:
    """Sharded dedup through the batched multi-graph PIVOT engine.

    Same contract as :func:`dedup_corpus`, but the similarity graph is
    sharded into per-component subgraphs (see :func:`shard_similarity_graph`)
    that are clustered together through ``correlation_cluster_batch`` — the
    production path when the corpus yields millions of small near-dup
    groups rather than one giant graph. Shard ``i`` draws with the key
    ``fold_in(PRNGKey(seed), i)``.
    """
    dev = resolve_device(device)
    sigs = minhash_signatures(corpus.docs, num_hashes=num_hashes, seed=seed)
    edges = similarity_edges(sigs, threshold=threshold)
    n = len(corpus.docs)
    shards = shard_similarity_graph(n, edges)

    labels = np.arange(n, dtype=np.int32)   # isolated docs: singletons
    total_cost = 0
    buckets: set = set()
    if shards:
        graphs = [build_graph(len(ids), local, device=dev)
                  for ids, local in shards]
        keys = [rng.fold_in(rng.PRNGKey(seed), i)
                for i in range(len(shards))]
        results = correlation_cluster_batch(graphs, keys=keys, eps=eps,
                                            num_samples=num_samples,
                                            device=dev)
        for (ids, _), res in zip(shards, results):
            labels[ids] = ids[res.labels]   # lift local pivots to doc ids
            total_cost += res.cost
            buckets.add(res.info["bucket"])

    clustering = ClusterResult(
        labels=labels, cost=total_cost, method="pivot_batch",
        info={"n_shards": len(shards), "n_buckets": len(buckets),
              "buckets": sorted(buckets), "num_samples": num_samples})
    return DedupResult(keep=_representatives(labels), labels=labels,
                       clustering=clustering, n_edges=len(edges))


def dedup_corpus_streaming(corpus: Corpus, threshold: float = 0.5,
                           num_hashes: int = 64, eps: float = 2.0,
                           seed: int = 0, num_samples: int = 4,
                           device: DeviceLike = None, max_batch: int = 32,
                           max_wait: Optional[float] = None,
                           batcher=None) -> DedupResult:
    """Streaming dedup: feed similarity-graph shards through the serving
    engine incrementally instead of one monolithic batch call.

    Same contract (and bit-identical labels/cost) as
    :func:`dedup_corpus_batched` — per-shard keys are a function of the
    shard index only, so how shards are grouped into flushes cannot change
    any result. What changes is the *execution discipline*: shards are
    admitted one at a time into a
    :class:`repro_torch.serve.cluster_batcher.ClusterBatcher` (full-bucket
    flushes, plus ``max_wait`` deadline flushes when set) and labels are
    stitched as requests retire — the shape a production pipeline takes
    when near-dup groups arrive as a stream rather than a corpus snapshot.

    Pass ``batcher`` to reuse a long-lived engine (and its program registry
    and buffer pool) across corpora; its ``num_samples``, ``eps``,
    ``device`` and method must be this call's, or the call raises.
    """
    from repro_torch.serve.cluster_batcher import (ClusterBatcher,
                                                   ClusterRequest)

    dev = resolve_device(device)
    sigs = minhash_signatures(corpus.docs, num_hashes=num_hashes, seed=seed)
    edges = similarity_edges(sigs, threshold=threshold)
    n = len(corpus.docs)
    shards = shard_similarity_graph(n, edges)

    if batcher is None:
        batcher = ClusterBatcher(max_batch=max_batch, eps=eps,
                                 num_samples=num_samples, device=dev,
                                 max_wait=max_wait)
    else:
        # A reused engine must actually implement the parameters this call
        # promises — a mismatch would silently break the bit-identical
        # contract with dedup_corpus_batched.
        want = dict(num_samples=max(1, num_samples), eps=eps, device=dev,
                    method="pivot")
        got = dict(num_samples=batcher.num_samples, eps=batcher.eps,
                   device=batcher.device, method=batcher.method)
        if got != want:
            raise ValueError(
                f"reused batcher config {got} does not match the requested "
                f"dedup parameters {want}")
    # Delta baseline vs engine lifetime. Must be a *deep* snapshot:
    # dataclasses.replace copies shallowly, so the mutable nested fields
    # (latency telemetry, live result-cache counters) would alias the live
    # stats object and every delta computed from them would read 0.
    stats0 = batcher.stats.snapshot()

    labels = np.arange(n, dtype=np.int32)   # isolated docs: singletons
    total_cost = 0
    buckets: set = set()
    shard_ids = {i: ids for i, (ids, _) in enumerate(shards)}

    def stitch(retired) -> None:
        nonlocal total_cost
        for req in retired:
            ids = shard_ids[req.uid]
            labels[ids] = ids[req.result.labels]   # lift local pivots
            total_cost += req.result.cost
            buckets.add(req.result.info["bucket"])

    for i, (ids, local) in enumerate(shards):
        req = ClusterRequest(uid=i, graph=build_graph(len(ids), local,
                                                      device=dev),
                             key=rng.fold_in(rng.PRNGKey(seed), i))
        stitch(batcher.admit(req))
        stitch(batcher.poll())
    stitch(batcher.flush())

    stats1 = batcher.stats
    info = {"n_shards": len(shards), "n_buckets": len(buckets),
            "buckets": sorted(buckets), "num_samples": num_samples,
            # deltas, so a long-lived reused batcher reports this call's
            # serving work rather than its lifetime totals
            "flushes": stats1.flushes - stats0.flushes,
            "deadline_flushes": (stats1.deadline_flushes
                                 - stats0.deadline_flushes),
            "padded_slots": stats1.padded_slots - stats0.padded_slots,
            # nested-telemetry delta — reads 0 under a shallow snapshot
            "flush_samples": (stats1.latency.total_flushes
                              - stats0.latency.total_flushes),
            # repeat shards (same content, same fold_in key) served from
            # the result cache — nonzero when a reused batcher sees the
            # same corpus again
            "cache_hits": stats1.cache_hits - stats0.cache_hits}
    clustering = ClusterResult(
        labels=labels, cost=total_cost, method="pivot_stream", info=info)
    return DedupResult(keep=_representatives(labels), labels=labels,
                       clustering=clustering, n_edges=len(edges))


def dedup_quality(result: DedupResult, corpus: Corpus) -> dict:
    """Planted-cluster recall/precision of the dedup decisions."""
    dup_of = corpus.duplicate_of
    n = len(dup_of)
    # ground-truth cluster id = source doc (or self)
    gt = np.where(dup_of >= 0, dup_of, np.arange(n))
    tp = fp = fn = 0
    labels = result.labels
    for i in range(n):
        for j in range(i + 1, n):
            same_gt = gt[i] == gt[j]
            same_pred = labels[i] == labels[j]
            tp += same_gt and same_pred
            fp += (not same_gt) and same_pred
            fn += same_gt and (not same_pred)
    prec = tp / max(1, tp + fp)
    rec = tp / max(1, tp + fn)
    return {
        "pairs_precision": prec,
        "pairs_recall": rec,
        "kept_fraction": float(result.keep.mean()),
        "clusters": int(len(np.unique(labels))),
        "cost": result.clustering.cost,
    }


__all__ = ["minhash_signatures", "similarity_edges", "DedupResult",
           "dedup_corpus", "dedup_corpus_batched", "dedup_corpus_streaming",
           "shard_similarity_graph", "dedup_quality"]
