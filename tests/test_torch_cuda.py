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
    flat = ell.reshape(-1)
    flat[3::17] = -3                              # ids outside [0, S):
    flat[5::19] = R + 5                           # they count for nothing
    ranks = rng.integers(0, INF, (B, R + 1)).astype(np.int32)
    ranks[:, R] = INF
    active = rng.random((B, R + 1)) < 0.3
    active[:, R] = False
    labels = rng.integers(0, 4, (B, R + 1)).astype(np.int32)
    labels[:, ::7] = -1                           # rows labelled as the pad
    labels[:, R] = -1
    return [torch.from_numpy(a).to(dev) for a in (ell, ranks, active, labels)]


# Every route of the launch plan (neighbor_min.launch_plan): staged with
# many small graphs a block, at the narrowest widths, with R not a power of
# two, at R = 2^15 (131 KB of shared memory) and with wide rows; l2 under
# 2 MiB of ELL, for odd W (B3's raw widths) and for state above 227 KB.
ROUTE_SHAPES = [(2048, 64, 8), (64, 4096, 4), (64, 4096, 8), (64, 4097, 16),
                (24, 32768, 16), (8, 32768, 16), (16, 512, 256),
                (512, 64, 8), (3, 999, 7), (1, 60000, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 8, 4), (3, 16, 4), (2, 33, 7),
                                   (4, 64, 32), (2, 128, 130),
                                   (8, 4096, 16), (1, 64, 4096)]
                         + ROUTE_SHAPES)
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
    # The staged route reads 16 bytes at a time: an ELL that starts one
    # element into its buffer is refused, not read unaligned.
    e, r, a, _ = _inputs(2048, 64, 8, seed=0, dev=cuda)
    assert nm.launch_plan(2048, 64, 8, 65).route == "staged"
    buf = torch.empty(e.numel() + 1, dtype=torch.int32, device=cuda)
    shifted = buf[1:].view(e.shape)
    shifted.copy_(e)
    with pytest.raises(ValueError):
        nm.neighbor_min_ell_batch(shifted, r, a)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2048, 64, 8), (64, 4097, 16),
                                   (8, 32768, 16)])
@pytest.mark.parametrize("skip", [(1, 1), (3, 3), (2, 0), (0, 1)])
def test_cuda_staged_route_reads_sliced_state(cuda, shape, skip):
    # The state as a row slice state[k:] of a larger (B + k, S) tensor
    # starts k·S words in, off a 16-byte boundary for odd S; ranks and
    # active sliced alike, or only one of them, so that they sit at
    # different offsets from a boundary.
    B, R, W = shape
    assert nm.launch_plan(B, R, W, R + 1).route == "staged"
    e, r, a, lab = _inputs(B, R, W, seed=B + skip[0], dev=cuda)

    def sliced(t, k):
        buf = torch.zeros((B + k, R + 1), dtype=t.dtype, device=cuda)
        buf[k:] = t
        return buf[k:]

    rs, as_, labs = sliced(r, skip[0]), sliced(a, skip[1]), sliced(lab,
                                                                   skip[0])
    assert torch.equal(nm.neighbor_min_ell_batch(e, rs, as_),
                       ref.neighbor_min_ref(e, r, a))
    assert torch.equal(nm.label_agree_ell_batch(e, labs),
                       ref.label_agree_ref(e, lab))


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


def _attention_inputs(shape, dev, seed):
    b, h, kh, sq, sk, d, causal, dtype = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            .to(dev, getattr(torch, dtype))
            for s in ((b, h, sq, d), (b, kh, sk, d), (b, kh, sk, d))]


# The edges of the tensor-core kernel (B, H, KH, Sq, Sk, D, causal, dtype):
# Sq and Sk off multiples of 64 and 16, Sq = 1, Sq < Sk causal (the row
# offset), non-causal ragged Sk, groups H/KH of 1, 3 and 8, every head dim,
# B > 1, both dtypes; the f32 tile at D = 128 takes 32 keys.
B4_EDGES = [
    (1, 4, 4, 77, 77, 64, True, "float32"),
    (1, 4, 4, 77, 77, 64, True, "bfloat16"),
    (2, 9, 3, 45, 203, 32, True, "float32"),
    (2, 9, 3, 45, 203, 32, True, "bfloat16"),
    (3, 8, 1, 1, 300, 64, True, "float32"),
    (3, 8, 1, 1, 300, 64, True, "bfloat16"),
    (1, 2, 2, 1, 1, 16, True, "float32"),
    (1, 3, 1, 70, 131, 64, False, "float32"),
    (1, 3, 1, 70, 131, 64, False, "bfloat16"),
    (2, 8, 8, 130, 7, 16, False, "float32"),
    (1, 8, 1, 129, 129, 16, True, "bfloat16"),
    (2, 6, 2, 100, 161, 128, True, "float32"),
    (2, 6, 2, 100, 161, 128, True, "bfloat16"),
    (1, 2, 1, 33, 33, 128, False, "float32"),
    (2, 16, 2, 200, 200, 64, True, "float32"),
    (1, 9, 3, 257, 1000, 64, True, "bfloat16"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", B4_EDGES, ids=str)
def test_cuda_flash_attention_edges(cuda, shape):
    q, k, v = _attention_inputs(shape, cuda, seed=sum(shape[:6]))
    causal, dtype = shape[6], shape[7]
    fa.reset_launch_counts()
    got = fa.flash_attention(q, k, v, causal=causal)
    want = ref.attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == 1
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = 2e-5 if dtype == "float32" else 2e-2
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() < tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_flash_attention_unaligned(cuda, dtype):
    """Views that start off a 16-byte boundary are copied by the wrapper,
    not misread, and the C entry refuses such a pointer outright
    (cudaErrorMisalignedAddress) instead of launching. The shape has rows
    whose second key half starts above the diagonal."""
    shape = (2, 9, 3, 150, 150, 64, True, dtype)
    q, k, v = _attention_inputs(shape, cuda, seed=7)
    want = ref.attention_ref(q, k, v, causal=True)
    tol = 2e-5 if dtype == "float32" else 2e-2
    got = fa.flash_attention(q, k, v, causal=True)
    assert (got.float() - want.float()).abs().max().item() < tol
    q2, k2, v2 = (torch.cat([t.reshape(-1)[:1], t.reshape(-1)])[1:]
                  .view(t.shape) for t in (q, k, v))
    assert all(t.data_ptr() % 16 for t in (q2, k2, v2))
    got = fa.flash_attention(q2, k2, v2, causal=True)
    assert (got.float() - want.float()).abs().max().item() < tol
    out = torch.empty_like(q)
    code = fa._lib().fa_forward(
        q2.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 2, 9, 3,
        150, 150, 64, 1, int(dtype == "bfloat16"),
        *fa._build.device_and_stream(q))
    assert fa._lib().fa_error_string(code).decode() == \
        "misaligned address"


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
