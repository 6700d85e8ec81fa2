"""Kernels B1–B3 of the port: plain versions ≡ the reference, wrappers' rules.

The port's plain PyTorch versions (``repro_torch.kernels.ref``) define what
the hand-written CUDA kernels must compute. Here they are held, with exact
integer equality, against the reference's jnp oracles over many shapes and
against the Pallas kernels in interpret mode (one small case each: interpret
mode is slow). The CUDA kernels themselves run only on the card, in
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro.core.graph import build_graph as ref_build_graph
from repro.core.graph import random_arboric as ref_random_arboric
from repro.kernels import neighbor_min as ref_nm
from repro.kernels import ref as ref_ref
from repro_torch.core import mis
from repro_torch.core.graph import build_graph
from repro_torch.kernels import neighbor_min as nm
from repro_torch.kernels import ref

INF = 2**31 - 1

# (B, R, W): tiny, bucket-like, ragged (non-pow2) widths and rows.
SHAPES = [(1, 8, 4), (3, 16, 4), (2, 33, 7), (4, 64, 32), (2, 128, 130)]


def _inputs(B, R, W, seed, p_active=0.3, n_labels=4):
    """Random bucket state with the pad contract: ids in [0, R], slot R
    INF/inactive/-1, and one row whose neighbours are all inactive."""
    rng = np.random.default_rng(seed)
    ell = rng.integers(0, R + 1, (B, R, W)).astype(np.int32)
    ranks = rng.integers(0, 2**31 - 1, (B, R + 1)).astype(np.int32)
    ranks[:, R] = INF
    active = rng.random((B, R + 1)) < p_active
    active[:, R] = False
    ell[:, 0, :] = R                   # a row of pads only
    labels = rng.integers(0, n_labels, (B, R + 1)).astype(np.int32)
    labels[:, R] = -1
    return ell, ranks, active, labels


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_batch_kernels_match_reference_oracles(shape):
    B, R, W = shape
    ell, ranks, active, labels = _inputs(B, R, W, seed=R * W)
    got = nm.neighbor_min_ell_batch(_t(ell), _t(ranks), _t(active)).numpy()
    agree = nm.label_agree_ell_batch(_t(ell), _t(labels)).numpy()
    for b in range(B):
        expect = np.asarray(ref_ref.neighbor_min_ref(ell[b], ranks[b],
                                                     active[b]))
        assert (got[b] == expect).all()
        assert (agree[b] == np.asarray(ref_ref.label_agree_ref(
            ell[b], labels[b]))).all()
        # B3 is B1 on one graph.
        single = nm.neighbor_min_ell(_t(ell[b]), _t(ranks[b]), _t(active[b]))
        assert (single.numpy() == expect).all()
    assert (got[:, 0] == INF).all()     # all-inactive row
    assert got.dtype == np.int32 and agree.dtype == np.int32


def test_plain_versions_match_pallas_interpret():
    ell, ranks, active, labels = _inputs(2, 16, 8, seed=3, p_active=0.5)
    nm_b = ref_nm.neighbor_min_ell_batch(ell, ranks, active, block_rows=8,
                                         interpret=True)
    la_b = ref_nm.label_agree_ell_batch(ell, labels, block_rows=8,
                                        interpret=True)
    nm_1 = ref_nm.neighbor_min_ell(ell[1], ranks[1], active[1], block_rows=8,
                                   interpret=True)
    assert (nm.neighbor_min_ell_batch(_t(ell), _t(ranks), _t(active)).numpy()
            == np.asarray(nm_b)).all()
    assert (nm.label_agree_ell_batch(_t(ell), _t(labels)).numpy()
            == np.asarray(la_b)).all()
    assert (nm.neighbor_min_ell(_t(ell[1]), _t(ranks[1]), _t(active[1]))
            .numpy() == np.asarray(nm_1)).all()


def test_wide_rows_reduce_correctly():
    # W up to MAX_WIDTH: a row must reduce over every column.
    ell, ranks, active, labels = _inputs(1, 8, 4096, seed=9, p_active=0.01)
    ranks[0, :8] = np.arange(100, 108)
    active[0, :8] = False
    active[0, 5] = True
    ell[0, 3, :] = 8
    ell[0, 3, 4095] = 5                # the only active neighbour, last col
    got = nm.neighbor_min_ell_batch(_t(ell), _t(ranks), _t(active))
    assert int(got[0, 3]) == 105
    assert torch.equal(got, ref.neighbor_min_ref(_t(ell), _t(ranks),
                                                 _t(active)))


def test_graph_ell_and_pad_state_match_reference():
    rng = np.random.default_rng(4)
    edges, _ = ref_random_arboric(40, 3, rng)
    rg, tg = ref_build_graph(40, edges), build_graph(40, edges, device="cpu")
    ell = nm.ell_from_graph(tg)
    assert ell.dtype == torch.int32
    assert (ell.numpy() == np.asarray(ref_nm.ell_from_graph(rg))).all()
    ranks = np.arange(40, dtype=np.int32)[::-1].copy()
    active = ranks % 3 == 0
    rp, ap = nm.pad_state(_t(ranks), _t(active))
    rrp, rap = ref_nm.pad_state(ranks, active)
    assert (rp.numpy() == np.asarray(rrp)).all()
    assert (ap.numpy() == np.asarray(rap).astype(bool)).all()
    assert rp.dtype == torch.int32 and ap.dtype == torch.bool
    from repro.kernels import ops as ref_ops
    expect = np.asarray(ref_ops.neighbor_min(rg, ranks, active))
    for given in (None, ell):           # the MIS loop passes its table
        got = mis.neighbor_min_ranks(tg, _t(ranks), _t(active), ell=given)
        assert (got.numpy() == expect).all()


def test_wrappers_reject_bad_inputs():
    ell, ranks, active, labels = _inputs(2, 8, 4, seed=0)
    e, r, a, lab = _t(ell), _t(ranks), _t(active), _t(labels)
    with pytest.raises(ValueError):
        nm.neighbor_min_ell_batch(e.long(), r, a)           # dtype
    with pytest.raises(ValueError):
        nm.neighbor_min_ell_batch(e, r, a.int())            # active dtype
    with pytest.raises(ValueError):
        nm.neighbor_min_ell_batch(e, r[:, :-1], a)          # state width
    with pytest.raises(ValueError):
        nm.neighbor_min_ell_batch(e[0], r, a)               # rank
    with pytest.raises(ValueError):
        nm.neighbor_min_ell(e, r, a)                        # 3-D for B3
    with pytest.raises(ValueError):
        nm.label_agree_ell_batch(e, lab[:1])                # batch size


def test_plain_path_is_not_counted_as_a_launch():
    nm.reset_launch_counts()
    ell, ranks, active, labels = _inputs(2, 8, 4, seed=1)
    nm.neighbor_min_ell_batch(_t(ell), _t(ranks), _t(active))
    nm.label_agree_ell_batch(_t(ell), _t(labels))
    nm.neighbor_min_ell(_t(ell[0]), _t(ranks[0]), _t(active[0]))
    assert nm.launches == {"neighbor_min_ell_batch": 0,
                           "label_agree_ell_batch": 0,
                           "neighbor_min_ell": 0}


def test_kernel_build_is_lazy():
    # Importing the wrappers must not build or load anything: this machine
    # may have no nvcc and no GPU.
    assert nm._LIB is None or torch.cuda.is_available()
