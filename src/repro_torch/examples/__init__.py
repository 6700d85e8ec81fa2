"""The examples of the root ``examples/`` folder, ported: each runs with
``python -m repro_torch.examples.<name> [--device cpu]`` and prints the
lines its reference counterpart prints.

  quickstart        — the paper's methods on one graph
  forest_clustering — forests: matchings give the optimum
  dedup_pipeline    — near-duplicate dedup of a corpus
  batch_serving     — clustering requests through ``ClusterBatcher``
  serve_decode      — continuous batching of smollm-135m requests
  train_smollm      — dedup, then train the smoke smollm with checkpoints
"""
