"""Serving: the engine protocol and both serving paths.

  engine.py         — ``ClusterEngine`` protocol, ``EngineStats``,
                      ``serve_all``
  batching.py       — ``ContinuousBatcher`` over a ``Model``'s
                      prefill/decode (the token path)
  cluster_batcher.py — ``ClusterBatcher``, the clustering path's engine
  scheduler.py      — its scheduling policies and ``FlushTelemetry``
  costmodel.py      — the cost policy's ``FlushCostModel`` and ``ShapeHeat``
  resultcache.py    — the content-addressed ``ResultCache``

Each mirrors its namesake in ``repro.serve``.
"""

from .cluster_batcher import ClusterBatcher, ClusterRequest, ClusterStats
from .engine import AdmissionRejected, ClusterEngine, EngineStats, serve_all
from .resultcache import ResultCache
from .scheduler import make_policy

__all__ = ["ClusterBatcher", "ClusterRequest", "ClusterStats",
           "AdmissionRejected", "ClusterEngine", "EngineStats", "serve_all",
           "ResultCache", "make_policy"]
