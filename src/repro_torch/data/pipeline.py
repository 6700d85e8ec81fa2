"""Deterministic sharded batching with exact resume.

The pipeline is a pure function of (stream, step): every data-parallel
worker slices its own rows from the step's global batch, so restarts and
elastic re-sharding reproduce the exact token order from the checkpointed
``step`` cursor alone — no iterator state to snapshot. This is also the
straggler story: there is no coordinator handing out work; a rejoining or
replacement host computes its shard deterministically.

A copy of the numpy-only ``repro/data/pipeline.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    seq_len: int
    global_batch: int
    seed: int = 0


class TokenPipeline:
    """Fixed token stream → (tokens, labels) batches by step index."""

    def __init__(self, stream: np.ndarray, cfg: PipelineConfig):
        self.cfg = cfg
        need = cfg.seq_len + 1
        n_seq = max(1, len(stream) // need)
        self._data = stream[: n_seq * need].reshape(n_seq, need)
        rng = np.random.default_rng(cfg.seed)
        self._order = rng.permutation(n_seq)

    @property
    def num_sequences(self) -> int:
        return len(self._data)

    def batch_at(self, step: int, shard: int = 0, num_shards: int = 1):
        """Deterministic global batch for ``step``; returns this shard's rows."""
        cfg = self.cfg
        rows_per_shard = cfg.global_batch // num_shards
        idx0 = step * cfg.global_batch + shard * rows_per_shard
        idx = (np.arange(rows_per_shard) + idx0) % self.num_sequences
        rows = self._data[self._order[idx]]
        return {
            "tokens": rows[:, :-1].astype(np.int32),
            "labels": rows[:, 1:].astype(np.int32),
        }

    def batches(self, start_step: int = 0, shard: int = 0,
                num_shards: int = 1) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch_at(step, shard, num_shards)
            step += 1


__all__ = ["PipelineConfig", "TokenPipeline"]
