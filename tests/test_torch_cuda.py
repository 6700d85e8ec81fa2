"""The port's CUDA kernels and main path on the card (skipped without one).

Kept free of ``jax`` and ``repro`` so it runs on a GPU machine that has
only PyTorch: ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
Each kernel is held to its plain PyTorch version with ``torch.equal``
(integer outputs, tolerance 0), and the batch path on the card to the
same path on the CPU.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import PRNGKey, build_graph, correlation_cluster_batch
from repro_torch.core.graph import random_arboric
from repro_torch.kernels import neighbor_min as nm
from repro_torch.kernels import ref

INF = 2**31 - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _inputs(B, R, W, seed, dev):
    rng = np.random.default_rng(seed)
    ell = rng.integers(0, R + 1, (B, R, W)).astype(np.int32)
    ell[:, 0, :] = R                              # a row of pads only
    ranks = rng.integers(0, INF, (B, R + 1)).astype(np.int32)
    ranks[:, R] = INF
    active = rng.random((B, R + 1)) < 0.3
    active[:, R] = False
    labels = rng.integers(0, 4, (B, R + 1)).astype(np.int32)
    labels[:, R] = -1
    return [torch.from_numpy(a).to(dev) for a in (ell, ranks, active, labels)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 8, 4), (3, 16, 4), (2, 33, 7),
                                   (4, 64, 32), (2, 128, 130),
                                   (8, 4096, 16), (1, 64, 4096)])
def test_cuda_kernels_equal_plain(cuda, shape):
    e, r, a, lab = _inputs(*shape, seed=sum(shape), dev=cuda)
    nm.reset_launch_counts()
    assert torch.equal(nm.neighbor_min_ell_batch(e, r, a),
                       ref.neighbor_min_ref(e, r, a))
    assert torch.equal(nm.label_agree_ell_batch(e, lab),
                       ref.label_agree_ref(e, lab))
    assert torch.equal(nm.neighbor_min_ell(e[0], r[0], a[0]),
                       ref.neighbor_min_ref(e[0], r[0], a[0]))
    assert nm.launches == {"neighbor_min_ell_batch": 1,
                           "label_agree_ell_batch": 1,
                           "neighbor_min_ell": 1}


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_inputs(cuda):
    e, r, a, _ = _inputs(2, 16, 8, seed=0, dev=cuda)
    with pytest.raises(ValueError):
        nm.neighbor_min_ell_batch(e.transpose(1, 2), r, a)   # contiguity
    with pytest.raises(ValueError):
        nm.neighbor_min_ell_batch(e, r.cpu(), a)             # device


@pytest.mark.cuda
def test_cuda_batch_path_equals_cpu(cuda):
    rng = np.random.default_rng(1)
    specs = [(n, random_arboric(n, 2, rng)[0]) for n in (7, 9, 40, 300, 700)]
    keys = [PRNGKey(i) for i in range(len(specs))]
    out = {}
    for dev in ("cpu", cuda):
        graphs = [build_graph(n, e, device=dev) for n, e in specs]
        out[str(dev)] = correlation_cluster_batch(
            graphs, keys=keys, num_samples=3, device=dev)
    for a, b in zip(out["cpu"], out[str(cuda)]):
        assert (a.labels == b.labels).all()
        assert a.cost == b.cost and a.info == b.info
