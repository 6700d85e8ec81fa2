"""The port's CUDA kernels and main paths on the card (skipped without one).

Kept free of ``jax`` and ``repro`` so it runs on a GPU machine that has
only PyTorch: ``python -m pytest -q -m cuda tests/test_torch_cuda.py``.
B1, B2, the ELL neighbour-min of one graph, the fused per-graph
PIVOT (B3, both launch routes) and its window mode (both routes, on
chained windows), the precluster agreement kernel (both
routes, the smem route's fallback too, at replicas 1 and 3) are held to
their plain PyTorch versions with ``torch.equal`` (integer outputs,
tolerance 0), and the batch (pivot and precluster, both objectives) and
per-graph paths on the card (every method) to the same paths on the
CPU; the async
executor keeps two in-flight flushes of one shape on two staging buffers
and returns from ``submit`` before the flush ends. B4 is held to its plain version within 2e-5 (f32) and
2e-2 (bf16), the reference's own kernel tolerances (sums in another
order; a bf16 output may round one unit apart), at outputs in
[4.5, 7.5] within 2e-2 of the plain version's f32 output, and the smoke LM's
prefill on the card to the CPU's within 1e-4 (two f32 layers), each other
family's too (decode within 1e-2, through bf16 carries). The
autotuner's cases: every candidate launch plan of B1 and B2 at a staged
and an l2 default equal to the plain version, ``sweep_bucket`` recording a
winner no faster than its roofline model, ``bucket_impl`` under every
candidate pair bit-equal to the untuned program, and
``dedup_corpus_batched`` on the card equal to the CPU (120 documents).
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (PRNGKey, build_graph, correlation_cluster,
                              correlation_cluster_batch)
from repro_torch.configs import get_smoke
from repro_torch.core.graph import random_arboric, star
from repro_torch.core.mis import random_permutation_ranks_batch
from repro_torch.core import executor as ex
from repro_torch.core import plan as tplan
from repro_torch.kernels import agreement as ag
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import measure
from repro_torch.kernels import mis_pivot as mp
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


def _mis_edges(name, n):
    rng = np.random.default_rng(n)
    if name.startswith("star"):
        return star(n)
    return random_arboric(n, 2, rng)[0] if n > 1 else np.zeros((0, 2))


# (name, n, k, cap) of the fused per-graph PIVOT: the eligible vertices
# are those of degree <= cap, all where cap is None, none at -1. No
# vertex, one, none eligible; a hub of degree n - 1 that a warp walks
# (uncapped, on both routes and at 40,000 vertices on the grid route)
# and that the cap leaves out; k = 8; the per-graph path's sizes, one
# above a block's shared memory, and there k = 65, two grid launches.
MIS_CASES = [("empty", 0, 3, None), ("single", 1, 2, None),
             ("ineligible", 300, 3, -1), ("star", 5000, 3, None),
             ("star_capped", 5000, 3, 12), ("star_big", 40000, 1, None),
             ("arboric", 64, 8, 24), ("arboric", 4096, 3, 24),
             ("arboric", 4096, 8, None), ("arboric", 32768, 3, 24),
             ("arboric", 60000, 3, 24), ("arboric", 50000, 65, 24)]
MIS_RUNS = [(case, route) for case in MIS_CASES for route in ("block", "grid")
            if route == "grid" or mp.block_plan(case[2], case[1])]


@pytest.mark.cuda
@pytest.mark.parametrize("case,route", MIS_RUNS, ids=str)
def test_cuda_mis_pivot_equals_plain(cuda, case, route):
    name, n, k, cap = case
    g = build_graph(n, _mis_edges(name, n), device=cuda)
    ranks = random_permutation_ranks_batch(n, [PRNGKey(7 * i + n)
                                               for i in range(k)],
                                           device=cuda)
    eligible = torch.ones(n, dtype=torch.bool, device=cuda) if cap is None \
        else g.deg <= cap
    plan = mp.block_plan(k, n) if route == "block" else mp.grid_plan(k, n)
    mp.reset_launch_counts()
    got = mp.mis_pivot_csr(g.row_offsets, g.dst, ranks, eligible, plan=plan)
    want = ref.mis_pivot_ref(g.row_offsets, g.dst, ranks, eligible)
    torch.cuda.synchronize()
    assert mp.launches["mis_pivot"] == -(-k // plan.samples)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    if cap == -1:       # every vertex removed from the start, no round
        assert (got[0] == 2).all() and (got[2] == 0).all()


@pytest.mark.cuda
def test_cuda_mis_pivot_rejects_bad_inputs(cuda):
    g = build_graph(600, random_arboric(600, 2, np.random.default_rng(0))[0],
                    device=cuda)
    ranks = random_permutation_ranks_batch(600, [PRNGKey(1), PRNGKey(2)],
                                           device=cuda)
    elig = torch.ones(600, dtype=torch.bool, device=cuda)
    want = ref.mis_pivot_ref(g.row_offsets, g.dst, ranks, elig)
    # Rows of a larger tensor are contiguous and fine.
    buf = torch.zeros((3, 600), dtype=torch.int32, device=cuda)
    buf[1:] = ranks
    got = mp.mis_pivot_csr(g.row_offsets, g.dst, buf[1:], elig)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    strided = torch.zeros((600, 2), dtype=torch.int32, device=cuda).t()
    strided.copy_(ranks)
    for args in [(g.row_offsets, g.dst, strided, elig),      # contiguity
                 (g.row_offsets, g.dst, ranks, elig.cpu()),  # device
                 (g.row_offsets.cpu(), g.dst, ranks, elig),
                 (g.row_offsets, g.dst, ranks.long(), elig),  # dtype
                 (g.row_offsets, g.dst, ranks, elig.int()),
                 (g.row_offsets, g.dst, ranks[:, :599], elig),  # shape
                 (g.row_offsets, g.dst[::2], ranks, elig)]:   # strided ids
        with pytest.raises(ValueError):
            mp.mis_pivot_csr(*args)
    # A plan the kernel cannot run is refused by the C entry, never run:
    # a grid of more blocks than the card holds at once, too little
    # shared memory for a block's state, and a block count that is not k.
    mp.reset_launch_counts()
    for plan, msg in [(mp.MisPlan("grid", 1024, 100_000, 0, 2),
                       "cooperative launch"),
                      (mp.MisPlan("block", 1024, 2, 5 * 600 - 1, 2),
                       "invalid"),
                      (mp.MisPlan("block", 1024, 3, 5 * 600, 2), "invalid")]:
        with pytest.raises(RuntimeError, match=msg):
            mp.mis_pivot_csr(g.row_offsets, g.dst, ranks, elig, plan=plan)
    assert mp.launches["mis_pivot"] == 0


def _window_chain(n, rng):
    """Windows chained from an empty status: empty, the upper half first
    (its winners remove undecided vertices below it), random ones, then
    [0, n)."""
    out = [(0, 0), (n // 2, n), (n // 2, n // 2)]
    for _ in range(3):
        lo = int(rng.integers(0, max(1, n)))
        out.append((lo, lo + int(rng.integers(1, max(2, n // 4)))))
    return out + [(-5, n + 9)]


# (name, n) of B3's window mode: no vertex, one, a hub of degree n - 1,
# the per-graph sizes on either side of BLOCK_MAX_N, one above a block's
# shared memory.
WINDOW_CASES = [("empty", 0), ("single", 1), ("star", 5000),
                ("arboric", 4096), ("arboric", 32768), ("arboric", 60000)]
WINDOW_RUNS = [(case, route) for case in WINDOW_CASES
               for route in ("block", "grid")
               if route == "grid" or mp.block_plan(1, case[1])]


@pytest.mark.cuda
@pytest.mark.parametrize("case,route", WINDOW_RUNS, ids=str)
def test_cuda_mis_window_equals_plain(cuda, case, route):
    name, n = case
    g = build_graph(n, _mis_edges(name, n), device=cuda)
    ranks = random_permutation_ranks_batch(n, [PRNGKey(n + 3)],
                                           device=cuda)[0]
    plan = mp.block_plan(1, n) if route == "block" else mp.grid_plan(1, n)
    status = torch.zeros(n, dtype=torch.int32, device=cuda)
    want_status = status.clone()
    mp.reset_launch_counts()
    windows = _window_chain(n, np.random.default_rng(n))
    for lo, hi in windows:
        status, rounds = mp.mis_window_csr(g.row_offsets, g.dst, ranks,
                                           status, lo, hi, plan=plan)
        want_status, want_rounds = ref.mis_window_ref(
            g.row_offsets, g.dst, ranks, want_status, lo, hi)
        torch.cuda.synchronize()
        assert torch.equal(status, want_status), (lo, hi)
        assert torch.equal(rounds, want_rounds), (lo, hi)
    assert (status != 0).all()
    assert mp.launches["mis_window"] == len(windows)
    assert mp.launches["mis_pivot"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["pivot_phased", "forest_exact",
                                    "forest_approx", "cliques"])
def test_cuda_paper_methods_equal_cpu(cuda, method):
    rng = np.random.default_rng(8)
    mp.reset_launch_counts()
    for n, lam in [(300, 1), (4096, 2), (9000, 1)]:
        edges = random_arboric(n, lam, rng)[0]
        out = [correlation_cluster(build_graph(n, edges, device=dev),
                                   method=method, key=PRNGKey(n),
                                   num_samples=2, device=dev)
               for dev in ("cpu", cuda)]
        assert (out[0].labels == out[1].labels).all()
        assert out[0].cost == out[1].cost and out[0].info == out[1].info
    if method == "pivot_phased":
        assert mp.launches["mis_window"] > 0
        assert mp.launches["mis_pivot"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["pivot", "pivot_raw"])
def test_cuda_correlation_cluster_equals_cpu(cuda, method):
    rng = np.random.default_rng(3)
    mp.reset_launch_counts()
    nm.reset_launch_counts()
    for n, k in [(7, 1), (300, 3), (4096, 3), (50_000, 2)]:
        edges = random_arboric(n, 2, rng)[0]
        out = [correlation_cluster(build_graph(n, edges, device=dev),
                                   method=method, lam=2, key=PRNGKey(n),
                                   num_samples=k, device=dev)
               for dev in ("cpu", cuda)]
        assert (out[0].labels == out[1].labels).all()
        assert out[0].cost == out[1].cost and out[0].info == out[1].info
    # One launch a graph, all samples in it; no ELL kernel on this path.
    assert mp.launches["mis_pivot"] == 4
    assert nm.launches["neighbor_min_ell"] == 0


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
    (1, 4, 2, 100, 161, 80, True, "float32"),      # zamba2-2.7b's head dim
    (2, 4, 4, 77, 77, 80, True, "bfloat16"),
    (1, 4, 1, 70, 200, 160, True, "float32"),      # stablelm-12b's
    (1, 2, 2, 130, 130, 160, False, "bfloat16"),
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
    assert fa.instance_launches == {(dtype, shape[5], causal): 1}
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = 2e-5 if dtype == "float32" else 2e-2
    assert torch.isfinite(got.float()).all()
    assert (got.float() - want.float()).abs().max().item() < tol


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_an_unbuilt_head_dim(cuda):
    q, k, v = _attention_inputs((1, 2, 2, 16, 16, 48, True, "float32"),
                                cuda, seed=1)
    with pytest.raises(ValueError, match="no kernel instance"):
        fa.flash_attention(q, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 80, 160])
def test_cuda_flash_attention_bf16_large_outputs(cuda, d):
    """bf16 outputs in [4.5, 7.5], where one bf16 unit is 2^-5: within 2e-2
    of the plain version's f32 output, as only P @ V in f32 precision
    (P split into bf16 hi and lo) keeps it."""
    rng = np.random.default_rng(d)
    shape = (1, 4, 2, 300, 300, d, True, "bfloat16")
    q, k, v, want = measure.b4_large_output_inputs(shape, rng, cuda)
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert measure.B4_TOL["bfloat16"] == 2e-2
    measure.b4_large_output_check(got, want, shape)


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


# B4's launches in one prefill of each family's smoke model, by
# (dtype, head dim, causal): the hybrid's shared block once a group,
# whisper's encoder and cross-attention non-causal, the VLM's cross
# layers non-causal, none for RWKV.
FAMILY_B4 = {
    "rwkv6-1.6b": {},
    "zamba2-2.7b": {("float32", 16, True): 2},
    "whisper-base": {("float32", 16, True): 2, ("float32", 16, False): 4},
    "llama-3.2-vision-90b": {("float32", 16, True): 2,
                             ("float32", 16, False): 2},
}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", sorted(FAMILY_B4))
def test_cuda_family_prefill_and_decode_equal_cpu(cuda, arch):
    """Each other family's smoke model on the card against the same
    weights on the CPU, with seeded stub embeddings: prefill logits within
    1e-4 (a few f32 layers), B4 at the family's attention layers only, and
    three decode steps within 1e-2 (through bf16 carries, where a value
    rounded the other way moves a logit by ~1e-3 at this size)."""
    from repro_torch.models.transformer import STUB_INPUTS

    cfg = get_smoke(arch)
    cpu = build_model(cfg, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    card = build_model(cfg, device="meta").to_empty(device=cuda)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(2, cfg.vocab_size, (2, 21)))
    stubs = {}
    if cfg.family in STUB_INPUTS:
        n = cfg.encoder_seq or cfg.num_image_tokens
        stubs[STUB_INPUTS[cfg.family]] = torch.from_numpy(
            rng.standard_normal((2, n, cfg.d_model), np.float32))
    want, cc = cpu.prefill(tokens, cache_len=32, **stubs)
    fa.reset_launch_counts()
    got, cg = card.prefill(tokens.to(cuda), cache_len=32,
                           **{k: v.to(cuda) for k, v in stubs.items()})
    torch.cuda.synchronize()
    assert fa.instance_launches == FAMILY_B4[arch]
    assert (got.cpu() - want).abs().max().item() < 1e-4
    for step in range(3):
        tok = torch.from_numpy(rng.integers(2, cfg.vocab_size, (2,)))
        want, cc = cpu.decode_step(tok, cc, 21 + step)
        got, cg = card.decode_step(tok.to(cuda), cg, 21 + step)
        assert (got.cpu() - want).abs().max().item() < 1e-2


def _clustered(n, rng):
    """Dense groups of 3–9 vertices with sparse edges across, so that the
    precluster agreement test passes on many edges."""
    cuts = np.cumsum(rng.integers(3, 10, n))
    group = np.searchsorted(cuts, np.arange(n), side="right")
    u, v = np.triu_indices(n, 1)
    keep = rng.random(len(u)) < np.where(group[u] == group[v], 0.85, 0.01)
    return np.stack([u[keep], v[keep]], axis=1)


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["disagree", "minmax"])
def test_cuda_precluster_and_minmax_equal_cpu(cuda, objective):
    rng = np.random.default_rng(3)
    specs = [(n, _clustered(n, rng)) for n in (31, 32, 33, 300, 1100)]
    specs += [(n, random_arboric(n, 2, rng)[0]) for n in (500, 4097)]
    keys = [PRNGKey(i) for i in range(len(specs))]
    out = {}
    for dev in ("cpu", cuda):
        gs = [build_graph(n, e, device=dev) for n, e in specs]
        nm.reset_launch_counts()
        out[str(dev)] = correlation_cluster_batch(
            gs, keys=keys, method="precluster", objective=objective,
            num_samples=3, device=dev)
        if dev == cuda:
            assert nm.launches["neighbor_min_ell_batch"] == \
                3 * len({(r.info["bucket"]) for r in out[str(dev)]})
    for a, b in zip(out["cpu"], out[str(cuda)]):
        assert (a.labels == b.labels).all() and a.cost == b.cost
        assert a.info == b.info
    assert any(r.info["depth"] > 0 for r in out["cpu"])
    n, e = specs[3]
    a = correlation_cluster(build_graph(n, e, device="cpu"),
                            method="precluster", key=PRNGKey(9),
                            num_samples=3, device="cpu")
    b = correlation_cluster(build_graph(n, e, device=cuda),
                            method="precluster", key=PRNGKey(9),
                            num_samples=3, device=cuda)
    assert (a.labels == b.labels).all() and a.cost == b.cost
    assert a.info == b.info


@pytest.mark.cuda
def test_cuda_async_executor_overlaps_and_keeps_leases_apart(cuda):
    """Two in-flight flushes of one R = 2^15 shape get two staging buffer
    generations (pinned), ``submit`` returns before the flush's event has
    completed, and the results equal the sync executor's."""
    rng = np.random.default_rng(5)
    gs = [build_graph(n, random_arboric(n, 2, rng)[0], device=cuda)
          for n in (30000, 31000, 32000, 32500)]
    plans = [tplan.plan_graph(g) for g in gs]
    W = max(p.W for p in plans)
    plans = [tplan.promote_plan(p, 1 << 15, W) for p in plans]
    keys = [[PRNGKey(i)] for i in range(4)]
    pool = tplan.BucketBufferPool(device=cuda)
    assert pool.pinned
    asy = ex.AsyncExecutor(device=cuda)
    h1, _ = ex.pack_and_submit(plans[:2], keys[:2], 1, asy, pool=pool)
    assert not h1.ready()
    h2, _ = ex.pack_and_submit(plans[2:], keys[2:], 1, asy, pool=pool)
    assert pool.leased == 2 and pool.n_buffers == 2
    got = [h.result() for h in asy.drain()]
    assert pool.leased == 0
    assert h1.returned_seconds < h1.wall_seconds
    sync = ex.SyncExecutor(device=cuda)
    for h, ps, ks in ((got[0], plans[:2], keys[:2]),
                      (got[1], plans[2:], keys[2:])):
        want = ex.pack_and_submit(ps, ks, 1, sync)[0].result()
        for a, b in zip(h, want):
            assert (a == b).all()
    asy.close()
    shard = ex.ShardedExecutor([cuda])
    again = ex.pack_and_submit(plans[:2], keys[:2], 1, shard)[0].result()
    for a, b in zip(again, got[0]):
        assert (a == b).all()
    shard.close()


def _symmetric_ell(B, R, W, deg, seed):
    """A batch of random undirected graphs as an ELL (pad id R): cliques of
    2 to ``deg`` + 1 vertices, most of whose edges agree, plus random edges
    across while rows have room, each row's slots in random order."""
    rng = np.random.default_rng(seed)
    ell = np.full((B, R, W), R, dtype=np.int32)
    for b in range(B):
        fill = np.zeros(R, dtype=np.int64)
        nbrs = [set() for _ in range(R)]
        start = 0
        while start < R:
            size = int(rng.integers(2, deg + 2))
            members = range(start, min(R, start + size))
            for u in members:
                nbrs[u].update(v for v in members if v != u)
            start += size
        for _ in range(R // 4):
            u, v = (int(x) for x in rng.integers(0, R, 2))
            if u != v and len(nbrs[u]) < W and len(nbrs[v]) < W:
                nbrs[u].add(v)
                nbrs[v].add(u)
        for u in range(R):
            row = np.array(sorted(nbrs[u])[:W], dtype=np.int32)
            fill[u] = len(row)
            ell[b, u, : len(row)] = row
            ell[b, u] = ell[b, u, rng.permutation(W)]
    # A neighbour cut by the W limit above leaves an edge one-sided; the
    # kernel and the plain version take the ELL as it is.
    return ell


def _agreement_plans(B, R, W, replicas):
    """Every plan the agreement kernel can take at this shape: the launch
    plan's, the warp route, and where it can run the smem route, also with
    the least shared memory it takes, which stages about R ids, too few for
    these graphs (a graph it cannot stage runs on the warp route's code in
    the same launch)."""
    plans = {"launch plan": ag.agreement_launch_plan(B, R, W, replicas),
             "warp": ag.warp_plan(B, R, W, replicas)}
    if ag.smem_plan(B, R, W, replicas) is not None:
        plans["smem"] = ag.smem_plan(B, R, W, replicas)
        plans["smem, graph too large"] = ag.smem_plan(
            B, R, W, replicas, smem_bytes=ag.smem_least_bytes(R))
    return plans


def _packed_layout(ell):
    """The rows of ``ell`` laid out as ``pack_bucket`` writes them: the
    neighbours above u ascending, then those below ascending, pads last."""
    B, R, W = ell.shape
    out = np.full_like(ell, R)
    for b in range(B):
        for u in range(R):
            ids = np.sort(ell[b, u][ell[b, u] != R])
            row = np.concatenate([ids[ids > u], ids[ids <= u]])
            out[b, u, : len(row)] = row
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["permuted", "packed"])
@pytest.mark.parametrize("replicas", [1, 3])
@pytest.mark.parametrize("B,R,W,deg", [(3, 64, 8, 8), (2, 500, 16, 12),
                                       (2, 300, 48, 40), (1, 200, 64, 64),
                                       (4, 1024, 4, 4), (1, 32768, 8, 6),
                                       (1, 64, 4096, 64), (2, 4096, 32, 30)])
def test_cuda_agreement_kernel_equals_plain(cuda, B, R, W, deg, replicas,
                                            layout):
    """Every route, at ``replicas`` 1 and 3 (groups of identical entries),
    equal to the plain version; one launch a call; peak memory the output
    plus at most a (B / replicas, R) int32 scratch. Rows with their slots
    permuted take the smem route's fallback, rows as ``pack_bucket`` lays
    them out its staged path; (2, 4096, 32) holds more ids a graph than the
    default smem block stages."""
    ell = _symmetric_ell(B, R, W, deg, seed=R + W)
    if layout == "packed":
        ell = _packed_layout(ell)
    ell = torch.from_numpy(ell).to(cuda)
    ell = ell.repeat_interleave(replicas, dim=0)
    want = ref.agreement_ell_ref(ell, replicas=replicas)
    assert torch.equal(want, ref.agreement_ell_ref(ell))
    assert (want != R).any(), "no edge agrees: the case tests nothing"
    if (B, R, W) == (2, 4096, 32):
        plan = ag.smem_plan(*ell.shape, replicas)
        assert int((ell[0] != R).sum()) > ag.smem_capacity(plan, R)
    for name, plan in _agreement_plans(*ell.shape, replicas).items():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ag.reset_launch_counts()
        got = ag.agreement_ell_batch(ell, replicas=replicas, plan=plan)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        assert ag.launches["agreement_ell_batch"] == 1
        assert torch.equal(got, want), name
        assert peak <= got.numel() * 4 + B * R * 4 + 512, name
        del got
    assert ag.agreement_ell_batch(ell[:0], replicas=replicas).shape == \
        (0, R, W)
    with pytest.raises(ValueError, match="replicas"):
        ag.agreement_ell_batch(ell[:1], replicas=2)


# --- The autotuner's candidates and the dedup path ---------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(192, 4096, 32), (64, 8, 4)])
def test_cuda_every_candidate_plan_equals_plain(cuda, shape):
    """Every launch plan the autotuner may pick for B1 and B2, at a staged
    and an l2 default, against the plain version."""
    from repro_torch.kernels import autotune as at

    e, r, a, lab = _inputs(*shape, seed=sum(shape), dev=cuda)
    cands = at.candidate_plans(*shape, cuda)
    assert {c.route for c in cands} == {"l2", "staged"}
    want_nm = ref.neighbor_min_ref(e, r, a)
    want_la = ref.label_agree_ref(e, lab)
    for choice in cands:
        plan = choice.launch_plan(*shape)
        assert torch.equal(nm.neighbor_min_ell_batch(e, r, a, plan=plan),
                           want_nm), choice.name
        assert torch.equal(nm.label_agree_ell_batch(e, lab, plan=plan),
                           want_la), choice.name


def _tuning_graphs(cuda, count=6, n=(300, 900), seed=4):
    rng = np.random.default_rng(seed)
    return [build_graph(int(m), random_arboric(int(m), 2, rng)[0],
                        device=cuda)
            for m in rng.integers(n[0], n[1], count)]


@pytest.mark.cuda
def test_cuda_sweep_records_a_winner(cuda, tmp_path):
    from repro_torch.core.api import sample_keys
    from repro_torch.kernels import autotune as at
    from repro_torch.launch.roofline import ell_kernel_roofline

    prev = at.set_tuning_cache(at.TuningCache(str(tmp_path / "t.json")))
    try:
        graphs = _tuning_graphs(cuda)
        plans = [tplan.plan_graph(g) for g in graphs]
        bucket = plans[0].bucket
        plans = [p for p in plans if p.bucket == bucket]
        keys = [sample_keys(PRNGKey(i), 3) for i in range(len(plans))]
        ell, ranks, elig, _, _ = tplan.pack_bucket(plans, keys, k=3)
        args = [torch.from_numpy(x).to(cuda) for x in (ell, ranks, elig)]
        records = at.sweep_bucket(*args, repeats=2)
        B, R, W = ell.shape
        cache = at.tuning_cache()
        for rec in records:
            assert rec["equal"] and rec["winner"] in rec["candidates"]
            assert rec["default"] == rec["candidates"][0]
            assert rec["winner_ms"] <= rec["default_ms"]
            model = ell_kernel_roofline(rec["kernel"], B, R, W).t_model
            for ms in rec["timings_ms"].values():
                assert ms * 1e-3 >= model, rec
            assert cache.get(rec["kernel"], R, W, at.batch_tier(B),
                             device=cuda).name == rec["winner"]
        assert at.TuningCache(str(tmp_path / "t.json")).get(
            "neighbor_min", R, W, at.batch_tier(B), device=cuda) is not None
    finally:
        at.set_tuning_cache(prev)


@pytest.mark.cuda
@pytest.mark.parametrize("program,objective", [("pivot", "disagree"),
                                               ("precluster", "minmax")])
def test_cuda_tuned_bucket_impl_equals_untuned(cuda, program, objective):
    """bucket_impl under every candidate plan pair is bit-equal to the
    untuned program."""
    from repro_torch.core import programs
    from repro_torch.core.api import sample_keys
    from repro_torch.kernels import autotune as at

    graphs = _tuning_graphs(cuda, seed=5)
    plans = [tplan.plan_graph(g, method=program) for g in graphs]
    plans = [p for p in plans if p.bucket == plans[0].bucket]
    keys = [sample_keys(PRNGKey(i), 3) for i in range(len(plans))]
    host = tplan.pack_bucket(plans, keys, k=3)[:4]
    args = [torch.from_numpy(x).to(cuda) for x in host]
    want = programs.bucket_impl(*args, k=3, program=program,
                                objective=objective)
    B, R, W = host[0].shape
    for choice in at.candidate_plans(B, R, W, cuda):
        for pair in ((choice, choice), (choice, at.PlanChoice("l2"))):
            got = programs.bucket_impl(*args, k=3, program=program,
                                       objective=objective, plans=pair)
            for a, b in zip(want, got):
                assert torch.equal(a, b), (choice.name, pair)


@pytest.mark.cuda
def test_cuda_dedup_batched_equals_cpu(cuda):
    from repro_torch.data import dedup, synthetic

    corpus = synthetic.synthetic_corpus(n_docs=120, dup_fraction=0.4,
                                        mutate_p=0.05, seed=2)
    want = dedup.dedup_corpus_batched(corpus, threshold=0.45, seed=3,
                                      device="cpu")
    nm.reset_launch_counts()
    got = dedup.dedup_corpus_batched(corpus, threshold=0.45, seed=3,
                                     device=cuda)
    assert nm.launches["neighbor_min_ell_batch"] > 0
    assert nm.launches["label_agree_ell_batch"] > 0
    assert np.array_equal(got.labels, want.labels)
    assert np.array_equal(got.keep, want.keep)
    assert got.clustering.cost == want.clustering.cost
    assert got.clustering.info == want.clustering.info
    assert got.n_edges == want.n_edges
