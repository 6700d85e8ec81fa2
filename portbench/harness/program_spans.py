"""The program's own spans and counters (``repro_torch.spans``), as the
per-layer readers take them.

The program records while a profiler runs in the process, so a
``--trace 1`` run's records cover the traced stretch and nothing else;
the readers read them after the window. A span's device interval is when
the stream reached its entry and its exit, set on the host's clock. A
program without the recorder, or one that kept nothing, gives None.
"""

from __future__ import annotations

import statistics


def recorded():
    """(records, counters) of the program's recorder, or None."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    recs = spans.records()
    if not recs:
        return None
    return recs, spans.counters()


def _owners(recs, root: str) -> list:
    """For each record, the index of the ``root`` span it lies in (itself
    where it is one), or None: parents come before their children."""
    owner = []
    for i, r in enumerate(recs):
        if r.name == root:
            owner.append(i)
        else:
            owner.append(None if r.parent is None else owner[r.parent])
    return owner


def device_ms_per(recs, root: str, names) -> list:
    """For each ``root`` span, the summed device ms of the spans named in
    ``names`` inside it; None where no such span was kept, or one has no
    device interval (a run off the card)."""
    owner = _owners(recs, root)
    sums = {i: 0.0 for i, r in enumerate(recs) if r.name == root}
    found = False
    for i, r in enumerate(recs):
        if r.name in names and owner[i] is not None:
            if r.device_ns is None:
                return None
            sums[owner[i]] += (r.device_ns[1] - r.device_ns[0]) / 1e6
            found = True
    return list(sums.values()) if found else None


def mean_device_ms(root: str, names):
    """The mean over the ``root`` spans of :func:`device_ms_per`."""
    got = recorded()
    per = got and device_ms_per(got[0], root, names)
    return statistics.fmean(per) if per else None


def per_span(counter: str, root: str):
    """The counter ``counter`` over the number of ``root`` spans kept."""
    got = recorded()
    if got is None:
        return None
    recs, counts = got
    n = sum(r.name == root for r in recs)
    return counts.get(counter, 0) / n if n else None


__all__ = ["recorded", "device_ms_per", "mean_device_ms", "per_span"]
