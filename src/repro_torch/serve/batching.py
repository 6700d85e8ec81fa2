"""Continuous-batching serving loop over the prefill/decode entry points.

The port of ``repro/serve/batching.py``. Slot-based scheduler (vLLM-style):
a fixed number ``max_slots`` of sequences decode together; a finished
sequence releases its slot and the next queued request is prefilled into
it. Each slot owns its own cache (prefill batch 1) and each active slot
decodes one token per tick; a production deployment would page the slots
into one cache pool — the scheduling logic is the same.

It implements the :class:`repro_torch.serve.engine.ClusterEngine` protocol
(``admit`` / ``flush`` / ``retire`` / ``stats`` / ``pending``), so
``engine.serve_all`` can drive it. The model owns its weights (a
:class:`repro_torch.models.Model`), so unlike the reference the batcher
takes no ``params``. This module is host-side Python: the device work is
only ``model.prefill`` and ``model.decode_step``, everything else is queue
management.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional

import numpy as np
import torch

from .. import spans
from .engine import EngineStats


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray              # (len,) int32
    max_new_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class ServeStats(EngineStats):
    prefills: int = 0
    decode_steps: int = 0
    emitted_tokens: int = 0
    wasted_slot_steps: int = 0      # slot-steps with no sequence in the slot


class ContinuousBatcher:
    """Schedules requests through a single-sequence prefill + slot decode."""

    def __init__(self, model, max_slots: int = 4, cache_len: int = 512,
                 eos_token: int = 1):
        self.model = model
        self.max_slots = max_slots
        self.cache_len = cache_len
        self.eos = eos_token
        self.queue: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * max_slots
        self.slot_caches: List = [None] * max_slots
        self.slot_pos: np.ndarray = np.zeros(max_slots, np.int32)
        self.slot_last: np.ndarray = np.zeros(max_slots, np.int32)
        self._finished: Deque[Request] = deque()
        # Slot-fill is this path's (only) scheduling policy — named in the
        # protocol's stats surface like the clustering path's policies.
        self.stats = ServeStats(policy="slot-fill")

    # -- ClusterEngine protocol ------------------------------------------

    def admit(self, req: Request) -> List[Request]:
        """Queue a request and prefill it into a free slot if one exists.

        A request can retire at admission: prefill emits the first token,
        which may already hit EOS or satisfy ``max_new_tokens`` — retiring
        here (not after the next decode tick) keeps such requests from
        decoding one garbage token past their stop condition.
        """
        self.queue.append(req)
        self.stats.submitted += 1
        self._admit()
        self._retire()
        return self.retire()

    def flush(self, max_ticks: int = 10_000) -> List[Request]:
        """Decode until every admitted request finishes (or tick budget)."""
        ticks = 0
        while (self.queue or any(r is not None for r in self.slots)) \
                and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.retire()

    def retire(self) -> List[Request]:
        """Drain finished requests not yet handed back to the caller."""
        out = list(self._finished)
        self._finished.clear()
        return out

    def pending(self) -> int:
        return len(self.queue) + sum(r is not None for r in self.slots)

    # -- Scheduler internals ----------------------------------------------

    def _greedy(self, logits) -> int:
        """Argmax over the real vocabulary (padded columns dropped)."""
        top = torch.argmax(logits[0, : self.model.cfg.vocab_size])
        with spans.span("sync.greedy"):
            return int(top)

    def _admit(self):
        for i in range(self.max_slots):
            if self.slots[i] is None and self.queue:
                req = self.queue.popleft()
                with spans.request(req.uid), spans.span("serve.prefill"):
                    with spans.span("sync.tokens"):
                        tokens = torch.as_tensor(
                            req.prompt[None, :], dtype=torch.long,
                            device=self.model.device)
                    logits, caches = self.model.prefill(
                        tokens, cache_len=self.cache_len)
                    tok = self._greedy(logits)
                self.stats.prefills += 1
                req.out_tokens.append(tok)
                self.slots[i] = req
                self.slot_caches[i] = caches
                self.slot_pos[i] = len(req.prompt)
                self.slot_last[i] = tok
                self.stats.emitted_tokens += 1

    def _retire(self):
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if (len(req.out_tokens) >= req.max_new_tokens
                    or (req.out_tokens and req.out_tokens[-1] == self.eos)
                    or self.slot_pos[i] >= self.cache_len - 1):
                req.done = True
                self.slots[i] = None
                self.slot_caches[i] = None
                self._finished.append(req)
                self.stats.retired += 1

    def step(self):
        """One scheduler tick: admit → decode all active slots → retire.

        Retire runs immediately after admit as well: a request whose
        prefill token already ends it (EOS / max_new_tokens=1) must free
        its slot before the decode pass, not emit one token past the stop.
        """
        self._admit()
        self._retire()
        active = [i for i in range(self.max_slots) if self.slots[i] is not None]
        if not active:
            return False
        for i in active:
            req = self.slots[i]
            tok = torch.tensor([int(self.slot_last[i])], dtype=torch.long,
                               device=self.model.device)
            logits, caches = self.model.decode_step(
                tok, self.slot_caches[i], int(self.slot_pos[i]))
            self.slot_caches[i] = caches
            nxt = self._greedy(logits)
            req.out_tokens.append(nxt)
            self.slot_last[i] = nxt
            self.slot_pos[i] += 1
            self.stats.emitted_tokens += 1
        self.stats.decode_steps += 1
        self.stats.wasted_slot_steps += self.max_slots - len(active)
        self._retire()
        return True

    def run(self, max_ticks: int = 10_000) -> List[Request]:
        """Drive the loop to completion; returns the finished requests."""
        return self.flush(max_ticks=max_ticks)


__all__ = ["Request", "ContinuousBatcher", "ServeStats"]
