"""Synthetic corpus with planted near-duplicates.

Used by the dedup benchmarks/tests and the end-to-end training examples.
Documents are integer token sequences; near-duplicates are generated by
point mutations of a source document, so the planted cluster structure is
known and the dedup stage's recall/precision can be measured exactly.

A copy of the numpy-only ``repro/data/synthetic.py``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class Corpus:
    docs: List[np.ndarray]          # token arrays (variable length)
    duplicate_of: np.ndarray        # (n,) index of source doc, or -1 if orig


def synthetic_corpus(n_docs: int = 200, vocab: int = 1000,
                     doc_len: Tuple[int, int] = (64, 256),
                     dup_fraction: float = 0.4, mutate_p: float = 0.08,
                     seed: int = 0) -> Corpus:
    rng = np.random.default_rng(seed)
    n_orig = max(1, int(n_docs * (1 - dup_fraction)))
    docs: List[np.ndarray] = []
    dup_of = np.full(n_docs, -1, dtype=np.int64)
    for i in range(n_orig):
        ln = rng.integers(doc_len[0], doc_len[1] + 1)
        docs.append(rng.integers(0, vocab, ln).astype(np.int32))
    for i in range(n_orig, n_docs):
        src = int(rng.integers(0, n_orig))
        base = docs[src].copy()
        mask = rng.random(len(base)) < mutate_p
        base[mask] = rng.integers(0, vocab, int(mask.sum()))
        docs.append(base)
        dup_of[i] = src
    return Corpus(docs=docs, duplicate_of=dup_of)


def token_stream(corpus: Corpus, keep: np.ndarray | None = None,
                 sep_token: int = 0) -> np.ndarray:
    """Concatenate (kept) documents into a flat training token stream."""
    docs = corpus.docs if keep is None else [corpus.docs[i]
                                             for i in np.flatnonzero(keep)]
    parts = []
    for d in docs:
        parts.append(d)
        parts.append(np.array([sep_token], np.int32))
    return np.concatenate(parts) if parts else np.zeros((0,), np.int32)


__all__ = ["Corpus", "synthetic_corpus", "token_stream"]
