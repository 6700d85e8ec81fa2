"""The port's CUDA kernels and main paths on the card (skipped without one).

Kept free of ``jax`` and ``repro`` so it runs on a GPU machine that has
only PyTorch: ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
B1–B3 are held to their plain PyTorch versions with ``torch.equal``
(integer outputs, tolerance 0) and the batch path on the card to the same
path on the CPU. B4 is held to its plain version within 2e-5 (f32) and
2e-2 (bf16), the reference's own kernel tolerances (sums in another
order; a bf16 output may round one unit apart), and the smoke LM's
prefill on the card to the CPU's within 1e-4 (two f32 layers).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import PRNGKey, build_graph, correlation_cluster_batch
from repro_torch.configs import get_smoke
from repro_torch.core.graph import random_arboric
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import neighbor_min as nm
from repro_torch.kernels import ref
from repro_torch.models import build_model

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


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 9, 3, 130, 130, 64, True, "float32"),
                                   (2, 4, 2, 100, 333, 128, False,
                                    "bfloat16")])
def test_cuda_flash_attention_equals_plain(cuda, shape):
    b, h, kh, sq, sk, d, causal, dtype = shape
    g = torch.Generator(device=cuda).manual_seed(sq)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(s, generator=g, device=cuda).to(dt)
               for s in ((b, h, sq, d), (b, kh, sk, d), (b, kh, sk, d)))
    fa.reset_launch_counts()
    got = fa.flash_attention(q, k, v, causal=causal)
    want = ref.attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == 1
    assert got.dtype == dt and got.shape == q.shape
    tol = 2e-5 if dt == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() < tol


@pytest.mark.cuda
def test_cuda_smoke_prefill_equals_cpu(cuda):
    cfg = get_smoke("smollm-135m")
    cpu = build_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    card = build_model(cfg, device="meta").to_empty(device=cuda)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(2, cfg.vocab_size, (2, 37)))
    want, want_caches = cpu.prefill(tokens, cache_len=48)
    fa.reset_launch_counts()
    got, caches = card.prefill(tokens.to(cuda), cache_len=48)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == cfg.num_layers
    assert (got.cpu() - want).abs().max().item() < 1e-4
    for name in ("k", "v"):
        # The same f32 values rounded to bf16: at most one unit apart.
        want_kv = want_caches[name].float()
        diff = (caches[name].cpu().float() - want_kv).abs()
        assert (diff <= want_kv.abs() * 2.0**-7).all()
