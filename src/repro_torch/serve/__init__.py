"""Serving: the engine protocol and the token path's continuous batcher.

  engine.py   — ``ClusterEngine`` protocol, ``EngineStats``, ``serve_all``
  batching.py — ``ContinuousBatcher`` over a ``Model``'s prefill/decode

Each mirrors its namesake in ``repro.serve``; the clustering path's
``ClusterBatcher`` and its scheduler wait for ROADMAP A12.
"""
