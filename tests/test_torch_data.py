"""The port's data pipeline ≡ the reference's, on the CPU.

* ``synthetic_corpus``, ``token_stream`` and ``TokenPipeline.batch_at``
  (several steps and shards) are the reference's numpy, bit for bit;
* ``minhash_signatures`` (short documents included), ``similarity_edges``
  and ``shard_similarity_graph`` equal the reference's exactly;
* ``dedup_corpus``, ``dedup_corpus_batched`` and ``dedup_corpus_streaming``
  on ``device="cpu"`` equal the reference's same call: labels, keep mask,
  cost, edge count and the ``info`` fields (shards, buckets, the streaming
  deltas, a reused batcher's result-cache hits too);
* streaming equals batched, and a reused batcher whose configuration is not
  the call's is refused;
* ``dedup_quality`` dicts are equal;
* the port's ``distributed=True`` (world size 1) equals the reference's
  ``distributed=False``: the reference's own distributed dedup fails on
  ``check_rep`` with the installed jax.

Each corpus has at most 120 documents and is built once for the module.
Every output compared is an integer or a mask: equality is exact.
"""

import numpy as np
import pytest

from repro.data import dedup as ref_dedup
from repro.data import pipeline as ref_pipeline
from repro.data import synthetic as ref_synthetic
from repro.serve.cluster_batcher import ClusterBatcher as RefBatcher
from repro_torch.data import dedup, pipeline, synthetic
from repro_torch.serve import ClusterBatcher

CPU = "cpu"
RECIPE = dict(n_docs=120, dup_fraction=0.4, mutate_p=0.05, seed=2)
THRESHOLD = 0.45
SEED = 3
INFO_KEYS = ("n_shards", "n_buckets", "buckets", "num_samples")
STREAM_KEYS = INFO_KEYS + ("flushes", "deadline_flushes", "padded_slots",
                           "flush_samples", "cache_hits")


@pytest.fixture(scope="module")
def corpus():
    return ref_synthetic.synthetic_corpus(**RECIPE)


@pytest.fixture(scope="module")
def ref_results(corpus):
    """The reference's three dedup calls, run once for the module."""
    kw = dict(threshold=THRESHOLD, seed=SEED)
    return {"dedup_corpus": ref_dedup.dedup_corpus(corpus, **kw),
            "dedup_corpus_batched": ref_dedup.dedup_corpus_batched(
                corpus, **kw),
            "dedup_corpus_streaming": ref_dedup.dedup_corpus_streaming(
                corpus, max_batch=8, **kw)}


def _same(got, want, keys=INFO_KEYS):
    assert np.array_equal(got.labels, want.labels)
    assert got.labels.dtype == want.labels.dtype
    assert np.array_equal(got.keep, want.keep)
    assert got.clustering.cost == want.clustering.cost
    assert got.n_edges == want.n_edges
    for key in keys:
        assert got.clustering.info[key] == want.clustering.info[key], key


# --- numpy stages -----------------------------------------------------------


@pytest.mark.parametrize("recipe", [
    RECIPE, dict(n_docs=40, dup_fraction=0.5, mutate_p=0.05, seed=1),
    dict(n_docs=20, vocab=50, doc_len=(2, 9), dup_fraction=0.3, seed=5)])
def test_synthetic_corpus_and_token_stream_equal_reference(recipe):
    a = ref_synthetic.synthetic_corpus(**recipe)
    b = synthetic.synthetic_corpus(**recipe)
    assert len(a.docs) == len(b.docs)
    for x, y in zip(a.docs, b.docs):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert np.array_equal(a.duplicate_of, b.duplicate_of)
    keep = np.arange(len(a.docs)) % 3 == 0
    for k in (None, keep):
        s_ref = ref_synthetic.token_stream(a, keep=k, sep_token=7)
        s = synthetic.token_stream(b, keep=k, sep_token=7)
        assert s.dtype == s_ref.dtype and np.array_equal(s, s_ref)


@pytest.mark.parametrize("seq_len,global_batch,seed", [(64, 8, 0),
                                                       (32, 12, 1)])
def test_token_pipeline_equals_reference(corpus, seq_len, global_batch, seed):
    stream = synthetic.token_stream(corpus)
    a = ref_pipeline.TokenPipeline(
        stream, ref_pipeline.PipelineConfig(seq_len, global_batch, seed))
    b = pipeline.TokenPipeline(
        stream, pipeline.PipelineConfig(seq_len, global_batch, seed))
    assert a.num_sequences == b.num_sequences
    for step in (0, 1, 5, 17):
        for shards in (1, 2, 4):
            for shard in range(shards):
                x = a.batch_at(step, shard, shards)
                y = b.batch_at(step, shard, shards)
                for key in ("tokens", "labels"):
                    assert y[key].dtype == x[key].dtype
                    assert np.array_equal(y[key], x[key])
    it = b.batches(start_step=3, shard=1, num_shards=2)
    for step in (3, 4):
        assert np.array_equal(next(it)["tokens"],
                              a.batch_at(step, 1, 2)["tokens"])


@pytest.mark.parametrize("num_hashes,seed", [(64, 0), (32, 3)])
def test_minhash_and_similarity_edges_equal_reference(corpus, num_hashes,
                                                      seed):
    # Documents shorter than a shingle hash as a whole tuple.
    docs = list(corpus.docs[:60]) + [np.zeros(0, np.int32),
                                     np.array([5], np.int32),
                                     np.array([1, 2, 3], np.int32),
                                     np.array([1, 2, 3], np.int32)]
    a = ref_dedup.minhash_signatures(docs, num_hashes=num_hashes, seed=seed)
    b = dedup.minhash_signatures(docs, num_hashes=num_hashes, seed=seed)
    assert b.dtype == a.dtype and np.array_equal(a, b)
    for threshold in (0.3, THRESHOLD, 0.8):
        ea = ref_dedup.similarity_edges(a, threshold=threshold)
        eb = dedup.similarity_edges(b, threshold=threshold)
        assert eb.dtype == ea.dtype and np.array_equal(ea, eb)
    # The two identical short documents are an edge.
    n = len(docs)
    assert [n - 2, n - 1] in dedup.similarity_edges(b).tolist()


def test_shard_similarity_graph_equals_reference(corpus):
    sigs = dedup.minhash_signatures(corpus.docs)
    edges = dedup.similarity_edges(sigs, threshold=THRESHOLD)
    n = len(corpus.docs)
    for es in (edges, edges[::-1], np.zeros((0, 2), np.int64)):
        a = ref_dedup.shard_similarity_graph(n, es)
        b = dedup.shard_similarity_graph(n, es)
        assert len(a) == len(b)
        for (ia, la), (ib, lb) in zip(a, b):
            assert np.array_equal(ia, ib) and np.array_equal(la, lb)
            assert ib.dtype == ia.dtype and lb.dtype == la.dtype


# --- the dedup entry points -------------------------------------------------


def test_dedup_corpus_equals_reference(corpus, ref_results):
    got = dedup.dedup_corpus(corpus, threshold=THRESHOLD, seed=SEED,
                             device=CPU)
    want = ref_results["dedup_corpus"]
    _same(got, want, keys=())
    assert got.clustering.info == want.clustering.info
    assert got.clustering.method == want.clustering.method


def test_dedup_corpus_batched_equals_reference(corpus, ref_results):
    got = dedup.dedup_corpus_batched(corpus, threshold=THRESHOLD, seed=SEED,
                                     device=CPU)
    want = ref_results["dedup_corpus_batched"]
    _same(got, want)
    assert got.clustering.info == want.clustering.info
    assert got.clustering.method == want.clustering.method
    assert got.clustering.info["n_shards"] > 10


def test_dedup_corpus_streaming_equals_reference_and_batched(corpus,
                                                             ref_results):
    got = dedup.dedup_corpus_streaming(corpus, threshold=THRESHOLD,
                                       seed=SEED, max_batch=8, device=CPU)
    want = ref_results["dedup_corpus_streaming"]
    _same(got, want, keys=STREAM_KEYS)
    assert got.clustering.info == want.clustering.info
    assert got.clustering.method == want.clustering.method
    # Streaming is the batched call's result, flush grouping aside.
    _same(got, ref_results["dedup_corpus_batched"])


def test_dedup_streaming_reused_batcher_equals_reference(corpus):
    """A long-lived batcher reused across two calls: the second call's
    deltas (its result-cache hits included) equal the reference's."""
    kw = dict(threshold=THRESHOLD, seed=SEED, num_samples=2)
    ref_eng = RefBatcher(max_batch=16, num_samples=2)
    eng = ClusterBatcher(max_batch=16, num_samples=2, device=CPU)
    for _ in range(2):
        want = ref_dedup.dedup_corpus_streaming(corpus, batcher=ref_eng,
                                                **kw)
        got = dedup.dedup_corpus_streaming(corpus, batcher=eng, device=CPU,
                                           **kw)
        _same(got, want, keys=STREAM_KEYS)
    assert got.clustering.info["cache_hits"] == \
        got.clustering.info["n_shards"] > 0
    # A reused batcher with another configuration is refused.
    for bad in (dict(num_samples=3), dict(eps=1.0)):
        with pytest.raises(ValueError, match="does not match"):
            dedup.dedup_corpus_streaming(corpus, batcher=eng, device=CPU,
                                         **{**kw, **bad})
    precluster = ClusterBatcher(num_samples=2, method="precluster",
                                device=CPU)
    with pytest.raises(ValueError, match="does not match"):
        dedup.dedup_corpus_streaming(corpus, batcher=precluster,
                                     device=CPU, **kw)
    eng.close()


def test_dedup_quality_equals_reference(corpus, ref_results):
    for name in ("dedup_corpus", "dedup_corpus_batched"):
        want = ref_results[name]
        got = getattr(dedup, name)(corpus, threshold=THRESHOLD, seed=SEED,
                                   device=CPU)
        q = dedup.dedup_quality(got, corpus)
        assert q == ref_dedup.dedup_quality(want, corpus)
    # The reference test's limits hold on the port's result too.
    assert q["pairs_recall"] > 0.7 and q["pairs_precision"] > 0.9
    assert q["kept_fraction"] < 0.85


def test_dedup_distributed_equals_reference_local(corpus, ref_results):
    """World size 1 (no initialised group): the edge-sharded engine
    equals the reference's single-device dedup."""
    got = dedup.dedup_corpus(corpus, threshold=THRESHOLD, seed=SEED,
                             distributed=True, device=CPU)
    want = ref_results["dedup_corpus"]
    _same(got, want, keys=())
    local = dedup.dedup_corpus(corpus, threshold=THRESHOLD, seed=SEED,
                               device=CPU)
    assert np.array_equal(got.labels, local.labels)


def test_dedup_defaults_to_the_card(corpus, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (dedup.dedup_corpus, dedup.dedup_corpus_batched,
               dedup.dedup_corpus_streaming):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(corpus)
