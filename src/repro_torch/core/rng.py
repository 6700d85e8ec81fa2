"""Counter-based keys and permutations, bit-identical to ``jax.random``.

The batch engine's contract is bit-exactness *per key*: a graph clustered
under key ``k`` gets the same ranks, hence the same labels, wherever it is
computed. So the port reproduces the reference's generator exactly rather
than using ``torch.Generator``:

* a key is two 32-bit words, ``PRNGKey(seed) == [0, seed]``,
  held as a ``(2,)`` uint32 numpy array (the layout of jax's raw key data);
* ``threefry2x32`` is the 20-round Threefry-2x32 hash with key injection
  every four rounds;
* ``split`` and ``fold_in`` follow the partitionable scheme (jax's
  ``jax_threefry_partitionable=True``): ``split(key, num)[i]`` hashes the
  64-bit counter ``i`` as ``(hi, lo)`` and keeps both output words,
  ``fold_in(key, d)`` hashes the counter ``(0, d)``;
* 32 random bits at flat position ``i`` are ``hash(key, (hi(i), lo(i)))``'s
  two words XORed;
* ``permutation(key, n)`` runs ``ceil(3·ln n / ln(2³²−1))`` rounds; each
  splits the key, draws 32-bit sort keys and applies a **stable** sort.

Tensor arithmetic is int64 with ``& 0xFFFFFFFF`` masks (torch's uint32
support is partial on both CPU and CUDA); the sort keys are non-negative
int64, so a stable sort orders them exactly as an unsigned 32-bit sort
would. Key derivation is scalar work and stays in Python integers.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

_M = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_UINT32_MAX = np.iinfo(np.uint32).max

KeyLike = Union[np.ndarray, torch.Tensor, Sequence[int]]


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & _M


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 hash of counter words ``(x1, x2)`` under key ``(k1, k2)``.

    Works on Python ints or int64 tensors holding values in ``[0, 2³²)``
    (keys and counters broadcast); returns the two output words.
    """
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & _M
    b = (x2 + ks[1]) & _M
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M
        b = (b + ks[(i + 2) % 3] + i + 1) & _M
    return a, b


def key_words(key: KeyLike) -> Tuple[int, int]:
    """The two 32-bit words of a key as Python ints."""
    if isinstance(key, torch.Tensor):
        key = key.detach().cpu().numpy()
    arr = np.asarray(key).reshape(-1)
    if arr.shape != (2,):
        raise ValueError(f"a key is two 32-bit words, got shape {arr.shape}")
    return int(arr[0]) & _M, int(arr[1]) & _M


def _as_key(words: Tuple[int, int]) -> np.ndarray:
    return np.array(words, dtype=np.uint32)


def PRNGKey(seed: int) -> np.ndarray:
    """Key ``[0, seed]`` from a seed in ``[0, 2³²)``.

    Wider seeds are refused: the reference runs with 32-bit integers, where
    jax would drop the high word, while a 64-bit jax keeps it.
    """
    seed = int(seed)
    if not 0 <= seed <= _M:
        raise ValueError(f"PRNGKey takes a seed in [0, 2**32), got {seed}")
    return _as_key((0, seed))


def fold_in(key: KeyLike, data: int) -> np.ndarray:
    """New key from ``key`` and a 32-bit integer ``data``."""
    k1, k2 = key_words(key)
    return _as_key(threefry2x32(k1, k2, 0, int(data) & _M))


def _split_words(k1: int, k2: int, num: int):
    return [threefry2x32(k1, k2, (i >> 32) & _M, i & _M) for i in range(num)]


def split(key: KeyLike, num: int = 2) -> np.ndarray:
    """``(num, 2)`` uint32 array of keys derived from ``key``."""
    k1, k2 = key_words(key)
    return np.array(_split_words(k1, k2, num), dtype=np.uint32).reshape(num, 2)


def _bits32(k1: torch.Tensor, k2: torch.Tensor, n: int,
            device: torch.device) -> torch.Tensor:
    """32 random bits per position for a batch of keys, as int64.

    ``k1``/``k2`` are ``(K, 1)`` int64 key words; returns ``(K, n)``.
    """
    lo = torch.arange(n, dtype=torch.int64, device=device)
    hi = (lo >> 32) & _M
    a, b = threefry2x32(k1, k2, hi, lo & _M)
    return a ^ b


def shuffle_rounds(n: int) -> int:
    """Sort rounds jax's ``permutation`` spends on ``n`` elements."""
    return int(np.ceil(3 * np.log(max(1, n)) / np.log(_UINT32_MAX)))


def permutation_batch(keys: Sequence[KeyLike], n: int,
                      device: torch.device) -> torch.Tensor:
    """``(K, n)`` int64: row ``i`` is ``jax.random.permutation(keys[i], n)``."""
    words = [key_words(k) for k in keys]
    perm = torch.arange(n, dtype=torch.int64, device=device).expand(
        len(words), n)
    for _ in range(shuffle_rounds(n)):
        pairs = [_split_words(k1, k2, 2) for k1, k2 in words]
        words = [p[0] for p in pairs]
        sub = torch.tensor([p[1] for p in pairs], dtype=torch.int64,
                           device=device)
        sort_keys = _bits32(sub[:, :1], sub[:, 1:], n, device)
        order = torch.sort(sort_keys, dim=1, stable=True).indices
        perm = torch.gather(perm, 1, order)
    return perm


def permutation(key: KeyLike, n: int, device: torch.device) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` as an int64 tensor."""
    return permutation_batch([key], n, device)[0]


def randint(key: KeyLike, minval: int, maxval: int) -> int:
    """``int(jax.random.randint(key, (), minval, maxval))`` for int32.

    jax draws 32 bits from each half of ``split(key)`` and folds the two
    into ``[minval, maxval)`` modulo the span, in uint32 arithmetic that
    wraps (so ``2**16 % span`` squared wraps too); ``maxval <= minval``
    gives ``minval``.
    """
    lo_v = max(-2**31, min(2**31 - 1, int(minval)))
    hi_v = max(-2**31, min(2**31 - 1, int(maxval)))
    (a1, a2), (b1, b2) = _split_words(*key_words(key), 2)
    higher = _xor_words(threefry2x32(a1, a2, 0, 0))
    lower = _xor_words(threefry2x32(b1, b2, 0, 0))
    span = 1 if hi_v <= lo_v else (hi_v - lo_v) & _M
    mult = (((1 << 16) % span) ** 2 & _M) % span
    offset = ((higher % span) * mult + lower % span) & _M
    return lo_v + offset % span


def _xor_words(words) -> int:
    return words[0] ^ words[1]


def ranks_from_permutation(perm: torch.Tensor) -> torch.Tensor:
    """int32 ``rank[..., v]`` = position of ``v`` in each permutation row."""
    n = perm.shape[-1]
    pos = torch.arange(n, dtype=torch.int32, device=perm.device).expand_as(perm)
    return torch.empty_like(perm, dtype=torch.int32).scatter_(-1, perm, pos)


__all__ = [
    "PRNGKey",
    "fold_in",
    "split",
    "key_words",
    "threefry2x32",
    "shuffle_rounds",
    "permutation",
    "permutation_batch",
    "randint",
    "ranks_from_permutation",
]
