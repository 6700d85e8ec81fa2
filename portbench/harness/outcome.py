"""What a driver hands back from one run, and the statistics it uses."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class Outcome:
    """One run: the end-to-end metrics by name (``setup_s`` among them),
    requests or steps attempted and failed (with the first errors), the
    numbers compared against their limits, the peak of device memory, the
    trace's reading, what the per-layer readers read (``layer``), and
    notes printed beside the result."""
    e2e: Dict[str, float]
    attempted: int
    failed: int
    failures: List[str]
    checks: Dict[str, float]
    memory_peak: int
    reading: Any
    layer: Dict[str, Any]
    notes: Dict[str, Any] = dataclasses.field(default_factory=dict)


def percentile(values, q: float) -> Optional[float]:
    """The ``q``-th percentile, interpolated linearly between ranks
    (None of no values)."""
    if not values:
        return None
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


__all__ = ["Outcome", "percentile"]
