"""Data pipeline: synthetic corpora, near-duplicate dedup, token batches.

Each module mirrors its namesake in ``repro.data``:
  synthetic.py — corpus with planted near-duplicates (numpy)
  dedup.py     — MinHash → LSH similarity graph → correlation clustering,
                 per graph, through the batch engine or ``ClusterBatcher``
  pipeline.py  — deterministic sharded token batches with exact resume
"""
