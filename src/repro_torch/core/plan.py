"""Host-side planning layer of the batch engine: bucketing and packing.

The "what runs" half of the plan/executor split (the "how it runs" half is
:mod:`repro_torch.core.executor`). Everything here is numpy on the host,
except the rank permutations, which are drawn on the graph's device:

* :func:`plan_graph` resolves one graph's degree cap and its ``(R, W)``
  shape bucket (``R`` = vertex count rounded to a power of two, ``W`` = max
  *eligible-induced* degree rounded to a power of two; the Theorem 26 cap
  keeps ``W ≤ 12λ``). It canonicalises the eligible-induced edge list
  (lexsorted) once.
* :func:`build_packed_rows` turns one plan into :class:`PackedRows`: the
  graph's finished ``(R, W)`` ELL rows, rank rows and eligibility row.
* :func:`pack_bucket` lays one bucket's graphs (× k best-of-k samples) into
  the ``(B, R, W)`` ELL array plus ``(B, R+1)`` rank/eligibility rows the
  device program consumes, with the group axis padded to a power of two.
  Plans carrying :class:`PackedRows` assemble by row copies; plans without
  derive their rows at flush time. The two are byte-identical.
  ``correlation_cluster_batch`` always derives at flush time; prebuilt
  rows and :func:`promote_plan` are the admission-time packing that the
  serving slice (ROADMAP A12) calls.
* :class:`PackStats` / :func:`estimate_pack_stats` account for padding.
* :func:`graph_fingerprint` is the content address of one planned request
  (the serving layer's result cache and single-flight key), and
  :class:`BucketBufferPool` leases reusable host staging per packed shape
  (pinned memory for a CUDA device, so that copies to the card run
  asynchronously).

The staging arrays are byte-equal to the reference's for the same plans and
keys: ranks are a function of ``(n, key)`` only, so any grouping of graphs
into buckets yields identical results. The fingerprint's payload is
byte-equal to the reference's too, so a port key and the same jax key
fingerprint alike.
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.util import next_pow2

from .arboricity import arboricity_bounds
from .degree_cap import high_degree
from .graph import Graph
from .mis import random_permutation_ranks_batch

MIN_ROWS = 8     # smallest R bucket
MIN_WIDTH = 4    # smallest W bucket

# Largest supported bucket shapes. R is bounded so the int32 pair count
# R·(R−1)/2 of the device cost pass cannot overflow; W is bounded because an
# eligible-induced degree that large means the degree cap is effectively off
# for a dense graph, and the per-graph engine is the right tool there.
MAX_ROWS = 1 << 15
MAX_WIDTH = 1 << 12

_INT32_MAX = np.iinfo(np.int32).max


@dataclasses.dataclass
class GraphPlan:
    """Per-graph packing plan: bucket key + degree-cap metadata."""

    g: Graph
    n: int
    lam: Optional[int]          # resolved arboricity bound (None for raw)
    threshold: Optional[float]  # degree-cap threshold (None for raw)
    eligible: np.ndarray        # (n,) bool — vertices the inner PIVOT sees
    wreq: int                   # max eligible-induced degree
    R: int                      # row bucket (pow2)
    W: int                      # width bucket (pow2)
    # Eligible-induced undirected edge list, lexsorted (u, v), int64.
    canonical_edges: Optional[np.ndarray] = None
    # Prebuilt rows (admission-time packing); None = derive at flush time.
    rows: Optional["PackedRows"] = None
    method: str = "pivot"

    @property
    def bucket(self) -> Tuple[int, int]:
        """Shape bucket (R, W) — the packing/promotion identity."""
        return (self.R, self.W)

    @property
    def queue_key(self) -> Tuple[str, int, int]:
        """Serving-layer bucket key (method, R, W): requests coalesce into
        one flush only when they share both the packed shape and the
        registered bucket program."""
        return (self.method, self.R, self.W)


def _canonical_kept(und: np.ndarray, eligible: np.ndarray) -> np.ndarray:
    if len(und):
        kept = und[eligible[und[:, 0]] & eligible[und[:, 1]]]
        if len(kept):
            kept = kept[np.lexsort((kept[:, 1], kept[:, 0]))]
    else:
        kept = np.zeros((0, 2), dtype=np.int64)
    return np.ascontiguousarray(kept, dtype=np.int64)


def plan_graph(g: Graph, method: str = "pivot", eps: float = 2.0,
               lam: Optional[int] = None) -> GraphPlan:
    """Resolve the degree cap and the (R, W) shape bucket for one graph.

    Degree-capped methods mirror the per-graph api: ``lam`` defaults to the
    degeneracy upper bound, eligibility is ``deg <= 8(1+ε)/ε·λ``. Uncapped
    methods (``'pivot_raw'``) mark every vertex eligible.

    Raises ``ValueError`` for an unregistered method, or when the graph
    exceeds the largest supported bucket.
    """
    from .programs import method_spec

    spec = method_spec(method)
    n = g.n
    if spec.degree_cap:
        if lam is None:
            _, lam = arboricity_bounds(g, exact=n <= 200_000)
        high, threshold = high_degree(g, lam, eps)
        eligible = ~high.cpu().numpy()
    else:
        lam, threshold = None, None
        eligible = np.ones(n, dtype=bool)

    kept = _canonical_kept(g.undirected_edges(), eligible)
    wreq = int(np.bincount(kept.ravel(), minlength=n).max()) if len(kept) else 0

    R = max(MIN_ROWS, next_pow2(max(1, n)))
    W = max(MIN_WIDTH, next_pow2(max(1, wreq)))
    if R > MAX_ROWS:
        raise ValueError(
            f"graph with n={n} needs row bucket R={R} > MAX_ROWS={MAX_ROWS}; "
            "the batch engine targets many small graphs — cluster this one "
            "through correlation_cluster (per-graph engine) instead")
    if W > MAX_WIDTH:
        raise ValueError(
            f"graph needs ELL width W={W} > MAX_WIDTH={MAX_WIDTH} (max "
            f"eligible-induced degree {wreq}); with method='pivot' the "
            "Theorem 26 degree cap bounds this by 12λ — a width this large "
            "means the graph is too dense for the bucketed ELL layout; use "
            "the per-graph engine")
    return GraphPlan(g=g, n=n, lam=lam, threshold=threshold,
                     eligible=eligible, wreq=wreq, R=R, W=W,
                     canonical_edges=kept, method=method)


def plan_canonical_edges(plan: GraphPlan) -> np.ndarray:
    """The plan's canonical (lexsorted) eligible-induced edge list.

    ``plan_graph`` always attaches it; plans built by hand get it derived
    (and memoised) here.
    """
    if plan.canonical_edges is None:
        plan.canonical_edges = _canonical_kept(plan.g.undirected_edges(),
                                               plan.eligible)
    return plan.canonical_edges


def _scatter_ell(ell_rows: np.ndarray, edges: np.ndarray, n: int) -> None:
    """Write both directions of ``edges`` into ELL rows, in COO order."""
    if not len(edges):
        return
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    deg = np.bincount(src, minlength=n)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=starts[1:])
    slot = np.arange(len(src)) - starts[src]
    ell_rows[src, slot] = dst


class PackedRows:
    """Prebuilt rows for one planned graph (admission-time packing).

    The ``(R, W)`` int32 ELL rows (pad id ``R``), the ``(k, R+1)`` rank rows
    for the best-of-k sample keys (``INT32_MAX`` beyond ``n``), the
    ``(R+1,)`` eligibility row (slot ``R`` False) and the full edge count
    ``m``. The ranks are drawn on the graph's device when the rows are
    built and copied into the padded host layout on first access.
    """

    __slots__ = ("R", "W", "n", "m", "k", "ell", "elig",
                 "_ranks", "_ranks_dev")

    def __init__(self, R: int, W: int, n: int, m: int, k: int,
                 ell: np.ndarray, elig: np.ndarray,
                 ranks: Optional[np.ndarray] = None, ranks_dev=None):
        self.R = R
        self.W = W
        self.n = n
        self.m = m
        self.k = k
        self.ell = ell
        self.elig = elig
        self._ranks = ranks
        self._ranks_dev = ranks_dev

    @property
    def bucket(self) -> Tuple[int, int]:
        return (self.R, self.W)

    @property
    def ranks(self) -> np.ndarray:
        """``(k, R+1)`` int32 rank rows."""
        if self._ranks is None:
            out = np.full((self.k, self.R + 1), _INT32_MAX, dtype=np.int32)
            if self._ranks_dev is not None:
                out[:, : self.n] = self._ranks_dev.cpu().numpy()
                self._ranks_dev = None
            self._ranks = out
        return self._ranks

    def promote(self, R: int, W: int) -> "PackedRows":
        """Pad-copy relayout into a larger ``(R, W)`` bucket.

        Bit-exact: promoted rows ``n..R`` carry INF rank and are
        ineligible, extra width slots hold the new pad id ``R``.
        """
        if (R, W) == (self.R, self.W):
            return self
        if R < self.R or W < self.W:
            raise ValueError(
                f"cannot promote packed rows {self.bucket} into ({R}, {W}):"
                " the target must be at least as large in both dimensions")
        ell = np.full((R, W), R, dtype=np.int32)
        if self.n:
            sub = self.ell[: self.n]
            ell[: self.n, : self.W] = np.where(sub == self.R, R, sub)
        elig = np.zeros(R + 1, dtype=bool)
        elig[: self.n] = self.elig[: self.n]
        ranks = np.full((self.k, R + 1), _INT32_MAX, dtype=np.int32)
        ranks[:, : self.n] = self.ranks[:, : self.n]
        return PackedRows(R=R, W=W, n=self.n, m=self.m, k=self.k,
                          ell=ell, elig=elig, ranks=ranks)


def build_packed_rows(plan: GraphPlan, keys: Sequence) -> PackedRows:
    """Build one graph's :class:`PackedRows` at its native bucket."""
    n = plan.n
    R, W = plan.bucket
    ell = np.full((R, W), R, dtype=np.int32)
    _scatter_ell(ell, plan_canonical_edges(plan), n)
    elig = np.zeros(R + 1, dtype=bool)
    if n:
        elig[:n] = plan.eligible
    ranks_dev = random_permutation_ranks_batch(
        n, keys, device=plan.g.device) if n else None
    return PackedRows(R=R, W=W, n=n, m=int(plan.g.m), k=len(keys),
                      ell=ell, elig=elig, ranks_dev=ranks_dev)


def promote_plan(plan: GraphPlan, R: int, W: int) -> GraphPlan:
    """Re-target a plan at a larger ``(R, W)`` shape bucket (coalescing).

    Bit-exact by construction: promoted rows carry INF rank and are
    ineligible, extra ELL width slots hold the pad id ``R``, and the cost
    identity sums zero over both.
    """
    if R < plan.R or W < plan.W:
        raise ValueError(
            f"cannot promote bucket {plan.bucket} into ({R}, {W}): the "
            "target must be at least as large in both dimensions")
    if R > MAX_ROWS or W > MAX_WIDTH:
        raise ValueError(
            f"promotion target ({R}, {W}) exceeds the largest supported "
            f"bucket ({MAX_ROWS}, {MAX_WIDTH})")
    if (R, W) == plan.bucket:
        return plan
    rows = plan.rows.promote(R, W) if plan.rows is not None else None
    return dataclasses.replace(plan, R=R, W=W, rows=rows)


@dataclasses.dataclass(frozen=True)
class GraphFingerprint:
    """Content address of one planned clustering request.

    ``digest`` is a 128-bit blake2b over ``payload``, the canonical byte
    encoding of everything that determines the device result bit for bit
    (see :func:`graph_fingerprint`). The payload rides along so a cache
    keyed by ``digest`` can verify equality on every hit instead of
    trusting the hash: a digest collision is counted and treated as a miss.
    """

    digest: str
    payload: bytes

    @property
    def nbytes(self) -> int:
        """Size of the retained canonical payload (cache byte accounting)."""
        return len(self.payload)


def _key_payload(key) -> bytes:
    """Canonical bytes of a key: dtype, size and raw key words.

    A port key is the uint32 ``(2,)`` array of
    :func:`repro_torch.core.rng.PRNGKey`; the bytes equal those the
    reference takes from the same jax legacy key, so both fingerprint
    alike.
    """
    arr = np.ascontiguousarray(np.asarray(key))
    return (str(arr.dtype).encode("utf-8") + b"\0"
            + struct.pack("<q", arr.size) + arr.tobytes())


def graph_fingerprint(plan: GraphPlan, key, *, method: str = "pivot",
                      num_samples: int = 1, eps: float = 2.0,
                      objective: str = "disagree") -> GraphFingerprint:
    """Canonical, collision-checked content hash of one planned request.

    Two requests with equal fingerprints produce bit-identical device
    inputs, hence bit-identical ``(labels, cost, picked)``: the invariant
    the serving layer's result cache and single-flight coalescing rest on.
    The payload holds the eligible-induced edge set in its canonical
    (lexsorted) order, the eligibility mask, ``n`` and ``m``; the exact key
    bytes and ``num_samples`` (ranks are a function of ``(n, key)`` and the
    sample keys fold from the base key); and ``method``, ``objective``,
    ``eps`` and the resolved ``lam``. Promotion to a larger flush shape is
    bit-exact, so the bucket does not enter it.
    """
    kept = plan_canonical_edges(plan)
    elig = np.ascontiguousarray(np.asarray(plan.eligible, dtype=bool))
    payload = b"".join([
        b"cc-graph-fp2\0",
        method.encode("utf-8") + b"\0",
        objective.encode("utf-8") + b"\0",
        struct.pack("<d", float(eps)),
        struct.pack("<q", -1 if plan.lam is None else int(plan.lam)),
        struct.pack("<qqq", max(1, int(num_samples)), int(plan.n),
                    int(plan.g.m)),
        _key_payload(key),
        np.packbits(elig).tobytes() if plan.n else b"",
        kept.tobytes(),
    ])
    return GraphFingerprint(
        digest=hashlib.blake2b(payload, digest_size=16).hexdigest(),
        payload=payload)


@dataclasses.dataclass
class PackStats:
    """Packing/padding accounting for one ``correlation_cluster_batch`` call."""

    n_graphs: int = 0
    n_entries: int = 0        # real device entries = graphs × num_samples
    padded_entries: int = 0   # empty entries added for pow2 group padding
    pad_vertex_waste: int = 0  # Σ (R − n) over real graphs
    bucket_shapes: List[Tuple[int, int, int]] = dataclasses.field(
        default_factory=list)  # (R, W, B) per bucket actually run

    def merge(self, other: "PackStats") -> None:
        self.n_graphs += other.n_graphs
        self.n_entries += other.n_entries
        self.padded_entries += other.padded_entries
        self.pad_vertex_waste += other.pad_vertex_waste
        self.bucket_shapes.extend(other.bucket_shapes)


def estimate_pack_stats(plans: Sequence[GraphPlan], k: int,
                        g_pad: Optional[int] = None) -> PackStats:
    """Price a flush's padding without packing it (the one formula)."""
    if not plans:
        raise ValueError("estimate_pack_stats needs at least one plan")
    R, W = plans[0].bucket
    if any(p.bucket != (R, W) for p in plans):
        raise ValueError("plans must share one (R, W) bucket shape — "
                         "promote them first")
    if g_pad is None:
        g_pad = next_pow2(len(plans))
    elif g_pad < len(plans):
        raise ValueError(f"g_pad={g_pad} < {len(plans)} graphs in bucket")
    return PackStats(
        n_graphs=len(plans),
        n_entries=len(plans) * k,
        padded_entries=(g_pad - len(plans)) * k,
        pad_vertex_waste=sum(R - p.n for p in plans),
        bucket_shapes=[(R, W, g_pad * k)],
    )


def pack_bucket(plans: Sequence[GraphPlan],
                group_keys: Sequence[Optional[Sequence]],
                k: int, staging: Optional[dict] = None,
                g_pad: Optional[int] = None):
    """Assemble one bucket's graphs (× k samples each) into host arrays.

    Returns ``(ell, ranks, elig, m_edges, pad_groups)`` with batch axis
    ``B = g_pad · k`` (``g_pad`` defaults to ``next_pow2(len(plans))``;
    the sharded executor asks for more). The ``k`` sample replicas of a
    graph occupy contiguous entries so the device argmin reduces over a
    ``(G, k)`` reshape. ``staging`` (the arrays of a
    :class:`BucketBufferPool` lease) is refilled in place instead of
    allocating. A plan with prebuilt :class:`PackedRows` is assembled by
    row copies (its ``group_keys`` entry may be ``None``), and a flush of
    only such plans restamps just the group-padding tail; a plan without
    is derived here, its rank batch drawn first and harvested after the
    host-side scatters. Deriving through :func:`build_packed_rows` instead
    would interleave each graph's rank draw with its host scatter and add
    a copy per graph, which made the warm batch pass slower end to end on
    an H100 host.
    """
    R, W = plans[0].bucket
    if g_pad is None:
        g_pad = next_pow2(len(plans))
    elif g_pad < len(plans):
        raise ValueError(f"g_pad={g_pad} < {len(plans)} graphs in bucket")
    b_pad = g_pad * k
    rows_list = [p.rows for p in plans]
    for pr in rows_list:
        if pr is not None and (pr.bucket != (R, W) or pr.k != k):
            raise ValueError(
                f"prebuilt rows at bucket {pr.bucket} with k={pr.k} cannot "
                f"assemble into a ({R}, {W}) flush with k={k}; promote the "
                "plan first (promote_plan relays its PackedRows)")
    all_prebuilt = all(pr is not None for pr in rows_list)
    if staging is None:
        ell = np.empty((b_pad, R, W), dtype=np.int32)
        ranks = np.empty((b_pad, R + 1), dtype=np.int32)
        elig = np.empty((b_pad, R + 1), dtype=bool)
        m_edges = np.empty((b_pad,), dtype=np.int32)
    else:
        ell, ranks, elig, m_edges = (staging["ell"], staging["ranks"],
                                     staging["elig"], staging["m_edges"])
        if ell.shape != (b_pad, R, W):
            raise ValueError(f"staging of shape {ell.shape} cannot hold a "
                             f"({b_pad}, {R}, {W}) flush")
    # Rows a prebuilt flush overwrites wholly need no pad pattern first.
    first_pad = len(plans) * k if all_prebuilt else 0
    ell[first_pad:] = R
    ranks[first_pad:] = _INT32_MAX
    elig[first_pad:] = False
    m_edges[first_pad:] = 0

    # Draw the derived graphs' rank batches first: on a CUDA graph they run
    # on the card while the host scatters the ELL rows below.
    rank_batches = [
        random_permutation_ranks_batch(plan.n, keys, device=plan.g.device)
        if pr is None and plan.n else None
        for plan, keys, pr in zip(plans, group_keys, rows_list)
    ]

    for gi, (plan, keys) in enumerate(zip(plans, group_keys)):
        n = plan.n
        base = gi * k
        pr = rows_list[gi]
        if pr is not None:
            ell[base: base + k] = pr.ell
            ranks[base: base + k] = pr.ranks
            elig[base: base + k] = pr.elig
            m_edges[base: base + k] = pr.m
            continue
        _scatter_ell(ell[base], plan_canonical_edges(plan), n)
        # The adjacency is identical across the k sample replicas; only the
        # permutation (hence ranks) differs per sample key.
        ell[base + 1: base + k] = ell[base]
        for si in range(len(keys)):
            if n:
                elig[base + si, :n] = plan.eligible
            m_edges[base + si] = plan.g.m

    for gi, (plan, batch) in enumerate(zip(plans, rank_batches)):
        if batch is not None:
            ranks[gi * k: gi * k + batch.shape[0], : plan.n] = \
                batch.cpu().numpy()
    return ell, ranks, elig, m_edges, g_pad - len(plans)


def result_for_plan(plan: GraphPlan, labels_row: np.ndarray, cost: int,
                    picked: int, rounds: int, k: int, method: str):
    """Build one :class:`~repro_torch.core.api.ClusterResult` from outputs."""
    from .api import ClusterResult  # deferred: api imports the batch layer

    info = {
        "bucket": plan.bucket,
        "depth": rounds,
        "engine": "batch",
    }
    if plan.threshold is not None:
        info.update(threshold=plan.threshold,
                    high_degree=int((~plan.eligible).sum()),
                    lambda_bound=plan.lam)
    if k > 1:
        info.update(num_samples=k, picked_sample=picked)
    return ClusterResult(labels=labels_row[: plan.n].astype(np.int32),
                         cost=cost, method=method, info=info)


class StagingLease:
    """One checked-out host staging buffer set (see :class:`BucketBufferPool`).

    ``arrays`` maps ``ell``/``ranks``/``elig``/``m_edges`` to the numpy
    staging arrays a flush packs into. The lease must be released (once)
    after the device program consuming the buffers has completed; the
    executor layer does this when a flush's outputs are fetched.
    """

    __slots__ = ("pool", "key", "arrays", "released")

    def __init__(self, pool: "BucketBufferPool", key: Tuple[int, int, int],
                 arrays: dict):
        self.pool = pool
        self.key = key
        self.arrays = arrays
        self.released = False

    def release(self) -> None:
        if not self.released:
            self.released = True
            self.pool._release(self)


class BucketBufferPool:
    """Persistent host staging buffers per packed shape ``(B, R, W)``.

    The numpy ``ell``/``ranks``/``elig``/``m_edges`` arrays a flush packs
    into are allocated once per shape and refilled in place on later
    flushes. Buffers are handed out as :class:`StagingLease` objects: a
    leased buffer is **never** handed out again until released, so an
    async executor overlapping flushes of one bucket shape gets a second
    buffer generation instead of refilling the one still feeding an
    in-flight program. Synchronous serving releases each lease before the
    next flush, holding O(#buckets) buffers; pipelined serving holds
    O(#buckets · in-flight).

    For a CUDA ``device`` the arrays are views of pinned host memory, so
    that the executor's copies to the card are asynchronous. (The
    reference's pool also switches its programs to donated device inputs;
    PyTorch frees a flush's device inputs when its references drop, so
    there is nothing to switch.) Results are bit-identical with or without
    the pool.
    """

    def __init__(self, device=None):
        import torch

        self.pinned = (device is not None
                       and torch.device(device).type == "cuda")
        self._free: Dict[Tuple[int, int, int], List[dict]] = {}
        self._allocated = 0
        self._leased = 0

    def _new_buffers(self, b: int, r: int, w: int) -> dict:
        import torch

        shapes = {"ell": ((b, r, w), torch.int32),
                  "ranks": ((b, r + 1), torch.int32),
                  "elig": ((b, r + 1), torch.bool),
                  "m_edges": ((b,), torch.int32)}
        # The numpy views keep their pinned tensors alive.
        return {name: torch.empty(shape, dtype=dt,
                                  pin_memory=self.pinned).numpy()
                for name, (shape, dt) in shapes.items()}

    def acquire(self, b: int, r: int, w: int) -> StagingLease:
        """Check out a staging buffer set for shape ``(b, r, w)``.

        Reuses a free buffer when one exists; otherwise allocates — a
        buffer whose lease is outstanding is never returned.
        """
        key = (b, r, w)
        free = self._free.get(key)
        if free:
            arrays = free.pop()
        else:
            arrays = self._new_buffers(b, r, w)
            self._allocated += 1
        self._leased += 1
        return StagingLease(self, key, arrays)

    def _release(self, lease: StagingLease) -> None:
        self._leased -= 1
        self._free.setdefault(lease.key, []).append(lease.arrays)

    @property
    def n_buffers(self) -> int:
        """Total staging buffer sets allocated (free + leased)."""
        return self._allocated

    @property
    def leased(self) -> int:
        """Buffer sets currently checked out to in-flight flushes."""
        return self._leased


__all__ = [
    "GraphPlan",
    "GraphFingerprint",
    "graph_fingerprint",
    "StagingLease",
    "BucketBufferPool",
    "PackStats",
    "PackedRows",
    "plan_graph",
    "plan_canonical_edges",
    "promote_plan",
    "build_packed_rows",
    "pack_bucket",
    "estimate_pack_stats",
    "result_for_plan",
    "MIN_ROWS",
    "MIN_WIDTH",
    "MAX_ROWS",
    "MAX_WIDTH",
]
