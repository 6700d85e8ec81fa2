"""The one traffic generator: a mix's data file in, requests or rows out.

Everything here is a pure function of the mix's parameters and the seed:
the same seed gives the same requests, and any request can be made again
from its index.

* Prompts (``kind: prefill``): lengths from a log-normal (``median``,
  ``sigma``) clipped to ``[min, max]``. Each run of ``stratum`` requests
  holds the same lengths, the distribution's quantiles ``(i + 0.5) /
  stratum``, in an order drawn from the seed, so that every seed sends the
  same work in another order. Token ids are uniform over the vocabulary.
* Rows (``kind: train``): documents of log-normal length, each ended by
  the ``eos`` token, packed end to end and cut into rows of ``seq_len +
  1`` tokens (inputs and next-token labels).
* :func:`open_loop`: requests sent at a steady ``rate``, one every ``1 /
  rate`` seconds whether or not the earlier ones are answered (users
  independent of each other), served one at a time in the order sent;
  every request sent before the window closes is served and counted,
  answered or failed. Its time is counted from when it was due.
* :func:`closed_loop`: ``clients`` users, each sending its next request
  the moment its last is answered, so that the server never waits; the
  window closes on the requests not yet begun, which are withdrawn.
"""

from __future__ import annotations

import dataclasses
import statistics
from collections import deque
from typing import Callable, List, Optional

import numpy as np


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), *stream])


def _lognormal_quantiles(p: dict, n: int) -> np.ndarray:
    z = [statistics.NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)]
    lens = np.rint(p["median"] * np.exp(p["sigma"] * np.array(z)))
    return np.clip(lens, p["min"], p["max"]).astype(np.int64)


class PromptLengths:
    """The prompt lengths of a mix and seed, drawn as far as they are
    read: ``lengths[i]`` is prompt ``i``'s."""

    def __init__(self, mix: dict, seed: int):
        p = mix["prompt_len"]
        self._base = _lognormal_quantiles(p, p["stratum"])
        self._rng = _rng(seed, 1)
        self._drawn: List[np.ndarray] = []
        self._n = 0

    def __getitem__(self, i: int) -> int:
        while i >= self._n:
            self._drawn.append(self._rng.permutation(self._base))
            self._n += len(self._base)
        return int(self._drawn[i // len(self._base)][i % len(self._base)])


def prompt_lengths(mix: dict, seed: int, n: int) -> np.ndarray:
    """The lengths of the first ``n`` prompts."""
    lengths = PromptLengths(mix, seed)
    return np.array([lengths[i] for i in range(n)], dtype=np.int64)


def distinct_lengths(mix: dict) -> np.ndarray:
    """Every prompt length the mix sends, longest first."""
    p = mix["prompt_len"]
    return np.unique(_lognormal_quantiles(p, p["stratum"]))[::-1]


def prompt_tokens(seed: int, uid: int, length: int, vocab: int) -> np.ndarray:
    """The token ids of prompt ``uid``."""
    return _rng(seed, 2, uid).integers(0, vocab, length, dtype=np.int32)


def cache_len(mix: dict, length: int) -> int:
    """The cache a prompt of ``length`` leaves: rounded up to
    ``cache_round``."""
    r = mix["cache_round"]
    return -(-length // r) * r


class PackedRows:
    """The packed document stream of a training mix, row after row."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix, self.vocab = mix, vocab
        self._rng = _rng(seed, 3)
        self._buf = np.zeros(0, np.int32)

    def _document(self) -> np.ndarray:
        p = self.mix["doc_len"]
        n = int(np.clip(np.rint(p["median"] * np.exp(
            p["sigma"] * self._rng.standard_normal())), p["min"], p["max"]))
        body = self._rng.integers(1, self.vocab, n - 1, dtype=np.int32)
        return np.append(body, np.int32(self.mix["eos"]))

    def rows(self, n: int) -> np.ndarray:
        """The next ``n`` rows, (n, seq_len + 1) int32."""
        width = self.mix["seq_len"] + 1
        need = n * width
        parts = [self._buf]
        have = len(self._buf)
        while have < need:
            doc = self._document()
            parts.append(doc)
            have += len(doc)
        flat = np.concatenate(parts)
        self._buf = flat[need:]
        return flat[:need].reshape(n, width)

    def batch(self) -> dict:
        """The next step's ``tokens`` and ``labels``, (batch, seq_len)."""
        r = self.rows(self.mix["batch"])
        return {"tokens": r[:, :-1], "labels": r[:, 1:]}


@dataclasses.dataclass
class Sent:
    """One request of the loop: when it was due, began and was answered
    (host clock, seconds), its answer or its error."""
    uid: int
    length: int
    t_send: float
    t_start: Optional[float] = None
    t_done: Optional[float] = None
    token: Optional[int] = None
    error: Optional[str] = None
    late: bool = False                # served after the window closed


def open_loop(serve: Callable[[Sent], None], lengths: np.ndarray,
              rate: float, t0: float, t_end: float,
              clock: Callable[[], float],
              sleep: Callable[[float], None]) -> List[Sent]:
    """Sends request ``i`` (of length ``lengths[i]``) at ``t0 + i / rate``
    whether or not earlier ones are answered, and serves the requests in
    the order sent, one at a time: ``serve(sent)`` sets ``t_start``,
    ``t_done`` and ``token`` or ``error``. Nothing is sent at or after
    ``t_end``; every request sent before is served, those begun after the
    close marked ``late``. Returns every request sent, in order."""
    out: List[Sent] = []
    queue: deque = deque()
    nxt = 0
    while True:
        now = clock()
        while t0 + nxt / rate <= now and t0 + nxt / rate < t_end:
            if nxt >= len(lengths):
                raise ValueError(f"the loop sent more than {len(lengths)} "
                                 "requests")
            queue.append(Sent(nxt, int(lengths[nxt]), t0 + nxt / rate))
            nxt += 1
        if queue:
            s = queue.popleft()
            s.late = now >= t_end
            serve(s)
            if s.t_done is None:
                s.t_done = clock()
            out.append(s)
        elif now >= t_end or t0 + nxt / rate >= t_end:
            return out
        else:
            sleep(t0 + nxt / rate - now)


def closed_loop(serve: Callable[[Sent], None], lengths: PromptLengths,
                clients: int, t0: float, t_end: float,
                clock: Callable[[], float]) -> List[Sent]:
    """``clients`` requests sent at ``t0``, and one more each time one is
    answered, served in the order sent, one at a time, as
    :func:`open_loop` serves them. A request is begun only before
    ``t_end``; those still waiting then are withdrawn, neither served nor
    counted. Returns every request served, in order."""
    out: List[Sent] = []
    queue: deque = deque(Sent(i, int(lengths[i]), t0)
                         for i in range(clients))
    nxt = clients
    while queue and clock() < t_end:
        s = queue.popleft()
        serve(s)
        if s.t_done is None:
            s.t_done = clock()
        out.append(s)
        queue.append(Sent(nxt, int(lengths[nxt]), s.t_done))
        nxt += 1
    return out


__all__ = ["PromptLengths", "prompt_lengths", "distinct_lengths", "prompt_tokens", "cache_len", "PackedRows",
           "Sent", "open_loop", "closed_loop"]
