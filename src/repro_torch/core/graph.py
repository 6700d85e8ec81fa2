"""Graph container and generators for correlation clustering.

A complete signed graph is represented by its *positive* edge set only
(negative edges are implicit, the complement), matching the paper's
input-size convention ``N = |E⁺|`` (§1.1).

The layout is the reference's, array for array:

* COO: ``src``/``dst`` of length ``2m_pad`` (both directions of every
  undirected edge), sorted by ``src`` and padded with the sentinel vertex
  ``n`` so segment reductions have a spill row;
* CSR: ``row_offsets`` of length ``n + 2`` over the sorted COO;
* ``deg`` per vertex and ``eid``, the undirected edge id of every slot.

The build and the generators are host numpy; the returned :class:`Graph`
holds int32 tensors on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.util import DeviceLike, resolve_device

INT = torch.int32


@dataclasses.dataclass(frozen=True)
class Graph:
    """Positive-edge graph of a complete signed instance.

    Attributes:
      n: number of vertices.
      m: number of undirected positive edges.
      src, dst: directed COO, length ``2 * m_pad``, sorted by src; padding
        entries have ``src == dst == n``.
      row_offsets: CSR offsets, length ``n + 2`` (row ``n`` is the pad row).
      deg: positive degree per vertex, length ``n``.
      eid: undirected edge id per directed slot (pad = m).
    """

    n: int
    m: int
    src: torch.Tensor
    dst: torch.Tensor
    row_offsets: torch.Tensor
    deg: torch.Tensor
    eid: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self.src.device

    def to(self, device: DeviceLike) -> "Graph":
        """The same graph with every tensor on ``device`` (tensors already
        there are not copied)."""
        dev = torch.device(device)
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(dev)
                     for f in ("src", "dst", "row_offsets", "deg", "eid")})

    def undirected_edges(self) -> np.ndarray:
        """The (m, 2) undirected edge list with u < v (host numpy)."""
        s = self.src.cpu().numpy()
        d = self.dst.cpu().numpy()
        keep = (s < d) & (s < self.n)
        return np.stack([s[keep], d[keep]], axis=1)

    def max_degree(self) -> int:
        return int(self.deg.max()) if self.n else 0


def build_graph(n: int, edges: np.ndarray, pad_to: Optional[int] = None,
                device: DeviceLike = None) -> Graph:
    """Build a :class:`Graph` from an (m, 2) undirected edge array.

    Self loops and duplicate edges are removed. ``pad_to`` (directed count)
    fixes the array length.
    """
    dev = resolve_device(device)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if edges.size:
        lo = np.minimum(edges[:, 0], edges[:, 1])
        hi = np.maximum(edges[:, 0], edges[:, 1])
        keep = lo != hi
        lo, hi = lo[keep], hi[keep]
        und = np.unique(lo * np.int64(n) + hi)
        lo, hi = und // n, und % n
    else:
        lo = hi = np.zeros((0,), dtype=np.int64)
    m = int(lo.shape[0])

    s = np.concatenate([lo, hi])
    d = np.concatenate([hi, lo])
    e = np.concatenate([np.arange(m), np.arange(m)])
    order = np.argsort(s, kind="stable")
    s, d, e = s[order], d[order], e[order]

    npad = 2 * m if pad_to is None else int(pad_to)
    if npad < 2 * m:
        raise ValueError(f"pad_to={npad} < 2m={2 * m}")
    s_pad = np.full((npad,), n, dtype=np.int32)
    d_pad = np.full((npad,), n, dtype=np.int32)
    e_pad = np.full((npad,), m, dtype=np.int32)
    s_pad[: 2 * m] = s
    d_pad[: 2 * m] = d
    e_pad[: 2 * m] = e

    deg = np.bincount(s, minlength=n).astype(np.int32) if m else np.zeros(n, np.int32)
    row = np.zeros((n + 2,), dtype=np.int32)
    row[1: n + 1] = np.cumsum(deg)
    row[n + 1] = npad  # pad row swallows the sentinel tail

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    return Graph(n=n, m=m, src=put(s_pad), dst=put(d_pad),
                 row_offsets=put(row), deg=put(deg), eid=put(e_pad))


# ---------------------------------------------------------------------------
# Generators (host numpy). Each returns edges (and, where noted, lam, a known
# upper bound on the arboricity by construction). Same streams as the
# reference generators for the same numpy Generator state.
# ---------------------------------------------------------------------------


def random_forest(n: int, rng: np.random.Generator, p_keep: float = 1.0) -> np.ndarray:
    """Uniform random recursive forest: vertex i attaches to a random j < i."""
    if n <= 1:
        return np.zeros((0, 2), dtype=np.int64)
    # One vectorised draw: numpy's bounded-integer stream is the same as
    # drawing rng.integers(0, i) for i = 1 .. n-1 one call at a time.
    parents = rng.integers(0, np.arange(1, n, dtype=np.int64)).astype(np.int64)
    edges = np.stack([np.arange(1, n, dtype=np.int64), parents], axis=1)
    if p_keep < 1.0:
        edges = edges[rng.random(len(edges)) < p_keep]
    return edges


def random_arboric(n: int, lam: int, rng: np.random.Generator,
                   p_keep: float = 1.0) -> Tuple[np.ndarray, int]:
    """Union of ``lam`` independent random forests ⇒ arboricity ≤ lam."""
    chunks = []
    for _ in range(lam):
        perm = rng.permutation(n)
        f = random_forest(n, rng, p_keep=p_keep)
        if len(f):
            chunks.append(perm[f])
    edges = np.concatenate(chunks, axis=0) if chunks else np.zeros((0, 2), np.int64)
    return edges, lam


def gnp(n: int, p: float, rng: np.random.Generator) -> np.ndarray:
    """Erdős–Rényi G(n, p) positive edges (small n only)."""
    iu = np.triu_indices(n, k=1)
    mask = rng.random(len(iu[0])) < p
    return np.stack([iu[0][mask], iu[1][mask]], axis=1).astype(np.int64)


def clique(n: int, offset: int = 0) -> np.ndarray:
    iu = np.triu_indices(n, k=1)
    return (np.stack([iu[0], iu[1]], axis=1) + offset).astype(np.int64)


def barbell(lam: int) -> Tuple[int, np.ndarray]:
    """Two K_lam cliques joined by one edge (Remark 33 tightness instance)."""
    e1 = clique(lam, 0)
    e2 = clique(lam, lam)
    bridge = np.array([[lam - 1, lam]], dtype=np.int64)
    return 2 * lam, np.concatenate([e1, e2, bridge], axis=0)


def star(n: int) -> np.ndarray:
    """Star graph: arboricity 1, max degree n-1 (degree-cap stress case)."""
    return np.stack(
        [np.zeros(n - 1, dtype=np.int64), np.arange(1, n, dtype=np.int64)], axis=1
    )


def path(n: int) -> np.ndarray:
    return np.stack(
        [np.arange(n - 1, dtype=np.int64), np.arange(1, n, dtype=np.int64)], axis=1
    )


def disjoint_cliques(sizes, gap: int = 0) -> Tuple[int, np.ndarray]:
    edges, off = [], 0
    for s in sizes:
        if s >= 2:
            edges.append(clique(s, off))
        off += s + gap
    e = np.concatenate(edges, axis=0) if edges else np.zeros((0, 2), np.int64)
    return off, e


def scale_free(n: int, attach: int, rng: np.random.Generator) -> Tuple[np.ndarray, int]:
    """Barabási–Albert preferential attachment: arboricity ≤ attach.

    The endpoint pool is a flat int array (each edge endpoint appears once,
    so sampling it uniformly is degree-proportional sampling); duplicates
    within one vertex's picks are dropped, keeping ≤ attach new edges per
    vertex.
    """
    pool = np.empty(2 * attach * n, dtype=np.int64)
    pool[:attach] = np.arange(attach)
    pool_len = attach
    edges = np.empty((attach * n, 2), dtype=np.int64)
    m = 0
    for v in range(attach, n):
        idx = rng.integers(0, pool_len, attach)
        picks = np.unique(pool[idx])
        k = len(picks)
        edges[m:m + k, 0] = v
        edges[m:m + k, 1] = picks
        m += k
        pool[pool_len:pool_len + k] = picks
        pool[pool_len + k:pool_len + 2 * k] = v
        pool_len += 2 * k
    return edges[:m], attach


__all__ = [
    "Graph",
    "build_graph",
    "random_forest",
    "random_arboric",
    "gnp",
    "clique",
    "barbell",
    "star",
    "path",
    "disjoint_cliques",
    "scale_free",
]
