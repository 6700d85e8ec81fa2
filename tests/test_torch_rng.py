"""The port's keys and permutations are bit-identical to ``jax.random``.

Every downstream parity claim rests on this: ranks come from
``jax.random.permutation(key, n)`` in the reference and from
``repro_torch.core.rng`` in the port, and the two must agree bit for bit —
across the sort-round boundaries of jax's shuffle (1 round up to n≈1625,
2 rounds above), for best-of-k ``fold_in`` keys, and where two 32-bit sort
keys of the last round collide, so the stable sort's tie order shows.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.api import sample_keys as ref_sample_keys
from repro.core.mis import random_permutation_ranks as ref_ranks
from repro_torch.core import rng
from repro_torch.core.api import sample_keys
from repro_torch.core.mis import (random_permutation_ranks,
                                  random_permutation_ranks_batch)

CPU = torch.device("cpu")

# n across the shuffle's round boundaries (0 rounds at n=1, 1 round up to
# 1625, 2 above) and the batch engine's bucket limits.
NS = [1, 2, 7, 8, 9, 1625, 1626, 4097, 32768]

# Found offline by scanning PRNGKey(0..199) at n = 32768: PRNGKey(1) is the
# first key whose last-round 32-bit sort keys hold a duplicate value, so
# the final order of that pair is decided by the stable sort's tie rule.
TIE_N, TIE_SEED = 32768, 1


def _words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key))


def test_key_derivation_matches_jax():
    for seed in (0, 1, 7, 2**31 - 1, 2**32 - 1):
        key = jax.random.PRNGKey(seed)
        assert (rng.PRNGKey(seed) == _words(key)).all()
        for data in (0, 1, 2, 1000):
            assert (rng.fold_in(_words(key), data)
                    == _words(jax.random.fold_in(key, data))).all()
        assert (rng.split(_words(key), 3)
                == np.asarray(jax.random.split(key, 3))).all()


@pytest.mark.parametrize("n", NS)
def test_ranks_bit_identical(n):
    base = jax.random.PRNGKey(n)
    ref_keys = ref_sample_keys(base, 3)
    keys = sample_keys(_words(base), 3)
    for rk, k in zip([base, *ref_keys], [_words(base), *keys]):
        assert (k == _words(rk)).all()
        expect = np.asarray(ref_ranks(n, rk))
        got = random_permutation_ranks(n, k, device="cpu").numpy()
        assert got.dtype == np.int32
        assert (got == expect).all(), n


def test_batch_rows_match_single_keys():
    keys = sample_keys(rng.PRNGKey(11), 4)
    batch = random_permutation_ranks_batch(300, keys, device="cpu")
    assert batch.shape == (4, 300) and batch.dtype == torch.int32
    for i, k in enumerate(keys):
        assert torch.equal(batch[i], random_permutation_ranks(300, k,
                                                              device="cpu"))


def test_last_round_sort_key_tie_at_32768():
    words = rng.key_words(rng.PRNGKey(TIE_SEED))
    rounds = rng.shuffle_rounds(TIE_N)
    assert rounds == 2
    for _ in range(rounds):
        words, sub = rng.split(np.array(words, np.uint32), 2)
    bits = rng._bits32(torch.tensor([[int(sub[0])]]), torch.tensor(
        [[int(sub[1])]]), TIE_N, CPU)[0]
    _, counts = torch.unique(bits, return_counts=True)
    assert int((counts > 1).sum()) >= 1, "the chosen key no longer ties"
    key = jax.random.PRNGKey(TIE_SEED)
    expect = np.asarray(ref_ranks(TIE_N, key))
    got = random_permutation_ranks(TIE_N, _words(key), device="cpu").numpy()
    assert (got == expect).all()


def test_keys_accept_tensors_and_lists():
    k = rng.PRNGKey(5)
    assert rng.key_words(torch.tensor(k.astype(np.int64))) == (0, 5)
    assert rng.key_words([0, 5]) == (0, 5)
    with pytest.raises(ValueError):
        rng.key_words(np.zeros(3, np.uint32))
    with pytest.raises(ValueError):
        rng.PRNGKey(2**32)
