"""Fault tolerance for the training loop: the control-plane half.

A plain copy of ``repro/train/fault.py`` (it uses no JAX). The data plane,
the checkpoint format and the deterministic data order, lives in
``train/checkpoint.py`` and ``data/pipeline.py``.

* **Failure model**: a host can vanish at any step; recovery is a restart
  from the last checkpoint. The data pipeline is a pure function of the
  step cursor and the step is deterministic (``launch/train.py`` runs it
  under ``torch.use_deterministic_algorithms`` on the card), so a restart
  continues the loss trajectory bit for bit.
* **Checkpoint cadence**: :func:`suggest_cadence` is the Young/Daly
  approximation sqrt(2 · MTBF · write time).
* **Stragglers**: :class:`StepWatchdog` flags a step slower than
  ``factor`` times the trailing median.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional


def suggest_cadence(mtbf_s: float, ckpt_write_s: float,
                    step_s: float) -> int:
    """Young/Daly optimal checkpoint interval, in steps."""
    interval_s = math.sqrt(2.0 * mtbf_s * ckpt_write_s)
    return max(1, int(interval_s / max(step_s, 1e-9)))


@dataclasses.dataclass
class StepWatchdog:
    """Flags straggler steps: > ``factor`` × trailing-median step time."""
    factor: float = 2.0
    window: int = 32
    _times: List[float] = dataclasses.field(default_factory=list)
    _last: Optional[float] = None

    def start(self):
        self._last = time.monotonic()

    def stop(self) -> bool:
        """Record a step; returns True if this step was a straggler."""
        if self._last is None:
            raise RuntimeError("StepWatchdog.stop() before start()")
        dt = time.monotonic() - self._last
        self._last = None
        straggler = False
        if len(self._times) >= 8:
            med = sorted(self._times[-self.window:])[
                len(self._times[-self.window:]) // 2]
            straggler = dt > self.factor * med
        self._times.append(dt)
        return straggler

    @property
    def times(self) -> List[float]:
        """Every recorded step time, in seconds."""
        return list(self._times)

    @property
    def median(self) -> float:
        if not self._times:
            return 0.0
        t = sorted(self._times[-self.window:])
        return t[len(t) // 2]


class SimulatedFailure(RuntimeError):
    """Raised by ``launch/train.py``'s ``--fail-at`` to emulate a mid-run host loss."""


__all__ = ["suggest_cadence", "StepWatchdog", "SimulatedFailure"]
