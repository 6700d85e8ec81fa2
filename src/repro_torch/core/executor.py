"""Device-side execution layer of the batch engine.

The "how it runs" half of the plan/executor split (packing and bucketing
live in :mod:`repro_torch.core.plan`):

* :func:`run_bucket_program` moves one packed bucket to the device and runs
  the composed bucket program of :mod:`repro_torch.core.programs`: the
  method's rounds body, the objective's cost pass and the best-of-k argmin,
  so only the winners' labels, costs, sample indices and rounds come back.
  PyTorch runs eagerly, so there is no compiled-program cache to manage.
* :class:`InFlightBucket` is the handle of one dispatched bucket;
  ``result()`` brings its outputs to the host. The serving layer's queue
  of handles (``retire``/``drain``) comes with ROADMAP A12.
* :class:`SyncExecutor` dispatches, blocks and fetches one bucket at a time.
  The overlapped and multi-device executors of the reference are not
  ported yet (ROADMAP A11).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.util import DeviceLike, next_pow2, resolve_device

from .programs import bucket_impl, method_spec, objective_spec


def run_bucket_program(ell, ranks_p, elig_p, m_edges, k: int,
                       method: str = "pivot", objective: str = "disagree",
                       device: DeviceLike = None):
    """Run one bucket program on ``device``; returns device tensors.

    The inputs are the host arrays of :func:`repro_torch.core.plan.
    pack_bucket` (or tensors); they are copied to the device here.
    """
    program = method_spec(method).program
    objective_spec(objective)            # fail fast on unknown objectives
    dev = resolve_device(device)

    def put(a):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        return t.to(dev).contiguous()

    return bucket_impl(put(ell), put(ranks_p), put(elig_p), put(m_edges),
                       k=k, program=program, objective=objective)


class InFlightBucket:
    """Handle for one dispatched bucket program.

    ``result()`` brings the outputs to the host once, as numpy. ``payload``
    is the submitter's context.
    """

    __slots__ = ("payload", "_outputs", "_fetched")

    def __init__(self, outputs, payload: Any = None):
        self._outputs = outputs
        self._fetched: Optional[Tuple[np.ndarray, ...]] = None
        self.payload = payload

    def result(self) -> Tuple[np.ndarray, ...]:
        """(labels, costs, picked, rounds) as numpy; blocks if needed."""
        if self._fetched is None:
            self._fetched = tuple(o.cpu().numpy() for o in self._outputs)
            self._outputs = None
        return self._fetched


class SyncExecutor:
    """Dispatch, block, fetch — one bucket at a time, on one device.

    ``submit`` returns only after the outputs are on the host.
    """

    def __init__(self, device: DeviceLike = None):
        self.device = resolve_device(device)

    def group_pad(self, n_groups: int) -> int:
        """Padded group count for a bucket of ``n_groups`` graphs."""
        return next_pow2(max(1, n_groups))

    def submit(self, ell, ranks_p, elig_p, m_edges, k: int,
               payload: Any = None, method: str = "pivot",
               objective: str = "disagree") -> InFlightBucket:
        """Run one packed bucket and fetch its outputs into a handle."""
        outputs = run_bucket_program(ell, ranks_p, elig_p, m_edges, k=k,
                                     method=method, objective=objective,
                                     device=self.device)
        handle = InFlightBucket(outputs, payload=payload)
        handle.result()
        return handle


def pack_and_submit(plans, group_keys, k: int, executor: SyncExecutor,
                    payload: Any = None, objective: str = "disagree"):
    """Pack one bucket and dispatch it through an executor.

    One flush runs one method, taken from the plans (``GraphPlan.method``);
    a mixed-method plan list is refused. Returns ``(handle, stats)`` with
    this flush's :class:`~repro_torch.core.plan.PackStats`.
    """
    from .plan import estimate_pack_stats, pack_bucket

    method = plans[0].method
    for p in plans[1:]:
        if p.method != method:
            raise ValueError(
                f"cannot pack methods {method!r} and {p.method!r} into one "
                "bucket flush: a bucket program runs exactly one method")
    g_pad = executor.group_pad(len(plans))
    ell, ranks, elig, m_edges, _ = pack_bucket(plans, group_keys, k=k,
                                               g_pad=g_pad)
    handle = executor.submit(ell, ranks, elig, m_edges, k=k, payload=payload,
                             method=method, objective=objective)
    return handle, estimate_pack_stats(plans, k, g_pad=g_pad)


# Reference executors not ported yet, and the ROADMAP item that ports them.
NOT_PORTED = {"async": "A11", "sharded": "A11"}


def make_executor(spec=None, device: DeviceLike = None) -> SyncExecutor:
    """Resolve an executor argument: ``'sync'``, an instance, or None."""
    if spec is None or spec == "sync":
        return SyncExecutor(device=device)
    if isinstance(spec, str):
        if spec in NOT_PORTED:
            raise NotImplementedError(
                f"executor {spec!r} is not ported yet: ROADMAP "
                f"{NOT_PORTED[spec]}")
        raise ValueError(f"unknown executor {spec!r}; expected one of "
                         f"{sorted(['sync', *NOT_PORTED])}")
    if isinstance(spec, SyncExecutor):
        return spec
    raise TypeError(f"executor must be a name or SyncExecutor, "
                    f"got {type(spec).__name__}")


__all__ = [
    "InFlightBucket",
    "SyncExecutor",
    "make_executor",
    "pack_and_submit",
    "run_bucket_program",
]
