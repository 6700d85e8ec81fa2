"""The launch plans of kernels B1–B3 (``neighbor_min.launch_plan``) and of
the precluster agreement kernel (``agreement.agreement_launch_plan``).

The plan is a pure function of the shape ``(B, R, W, S)``, so its rules are
checked here on the CPU; the kernels that follow it run only on the card
(``tests/test_torch_cuda.py``). For every shape: each global row ``b·R + r``
belongs to exactly one block; a staged block stages whole graphs' state,
one segment of its rows at a time, in shared memory that holds every graph
of the segment and stays within what a block may use; staged launches are
one wave. The agreement plan fits the card (two smem blocks an SM, the
fallback's bitmaps in the ids' room) and takes the smem route only where
its rows fit a warp. Also :func:`measure.bind_baseline`, which picks the
argument list of an earlier kernel library from the ABI version it reports.
"""

import ctypes
import types

import numpy as np
import pytest

from repro_torch.kernels import agreement as ag
from repro_torch.kernels import measure
from repro_torch.kernels import neighbor_min as nm

# (B, R, W): the main path's buckets (R and W powers of two, B = G_pad·k),
# the R = 2^15 bucket, the wide shape, a capped block, and per-graph B3
# shapes (B = 1, W the raw max degree), including state above a block's
# shared memory.
SHAPES = [(768, 4096, 32), (768, 4096, 16), (768, 4096, 8), (64, 4096, 4),
          (512, 64, 8), (1536, 8, 4), (48, 1024, 64), (96, 8192, 16),
          (8, 32768, 16), (24, 32768, 16), (16, 4096, 4096), (2, 128, 256),
          (1, 4096, 16), (1, 32312, 18), (1, 300, 20), (1, 64, 4096),
          (1, 60000, 8), (3, 999, 7), (2, 33, 7), (3, 16, 4), (5, 4097, 16),
          (7, 1000, 12)]


def _blocks(plan, total):
    starts = np.arange(plan.blocks, dtype=np.int64) * plan.rows_per_block
    return starts, np.minimum(starts + plan.rows_per_block, total)


def _segments(plan, R, S, row0, row1):
    """The kernel's walk over one block's rows: (first row, end row, first
    graph, last graph) of each segment whose state it stages together."""
    stage_graphs = plan.smem_bytes // (4 * S)
    seg0 = row0
    while seg0 < row1:
        g0 = seg0 // R
        seg1 = min(row1, (g0 + stage_graphs) * R)
        yield seg0, seg1, g0, (seg1 - 1) // R
        seg0 = seg1


def _check_segments(plan, R, S, starts, ends):
    for row0, row1 in zip(starts.tolist(), ends.tolist()):
        covered = row0
        for seg0, seg1, g0, g1 in _segments(plan, R, S, row0, row1):
            assert seg0 == covered and seg1 > seg0
            covered = seg1
            # The staged slice is the whole state of the segment's graphs,
            # within the block's shared memory.
            assert g0 == seg0 // R and (g1 + 1) * R >= seg1
            assert (g1 - g0 + 1) * S * 4 <= plan.smem_bytes
        assert covered == row1


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_covers_rows_once_and_stages_whole_graphs(shape):
    B, R, W = shape
    S = R + 1
    plan = nm.launch_plan(B, R, W, S)
    total = B * R
    starts, ends = _blocks(plan, total)
    assert plan.route in nm.ROUTES
    # Every row exactly once: blocks are contiguous, in order, none empty.
    assert starts[0] == 0 and ends[-1] == total
    assert (starts[1:] == ends[:-1]).all() and (ends > starts).all()
    if plan.route == "l2":
        assert plan.smem_bytes == 0 and plan.threads == nm.THREADS
        return
    assert W % 4 == 0                      # int4 loads: 16-byte rows
    # One wave: a block of 1,024 threads on every SM, at most.
    assert plan.threads == nm.STAGED_THREADS and plan.blocks <= nm.SMS
    assert S * 4 <= plan.smem_bytes <= nm.SMEM_BYTES_MAX
    assert total * W * 4 >= nm.MIN_STAGED_BYTES
    _check_segments(plan, R, S, starts, ends)
    # A block stages each graph of its run once when they fit together.
    assert plan.smem_bytes // (4 * S) == min(
        B, (plan.rows_per_block - 1) // R + 2, nm.SMEM_BYTES_MAX // (4 * S))


@pytest.mark.parametrize("shape", [(1, 58112, 8), (1, 60000, 16),
                                   (2, 65536, 4)])
def test_state_above_shared_memory_takes_l2(shape):
    B, R, W = shape
    assert (R + 1) * 4 > nm.SMEM_BYTES_MAX
    plan = nm.launch_plan(B, R, W, R + 1)
    assert plan.route == "l2"
    assert plan.rows_per_block == nm.THREADS // min(32, 1 << (W - 1).bit_length())


@pytest.mark.parametrize("W", [1, 2, 3, 5, 7, 18, 30, 130])
def test_unaligned_rows_take_int32_loads(W):
    # B3's width is the raw max degree: rows that are not 16 bytes long
    # cannot be read as int4, whatever B and R.
    for B, R in ((1, 32312), (1, 100), (4, 256)):
        assert nm.launch_plan(B, R, W, R + 1).route == "l2"


def test_main_path_buckets_are_staged():
    # Every bucket the batch path forms (R, W powers of two, B = G_pad·k)
    # with at least MIN_STAGED_BYTES of ELL stages its state in shared
    # memory, up to the R = 2^15 bucket (131 KB); smaller ones are bound
    # by launch latency and take l2.
    for B in (24, 96, 768):
        for R in (2**p for p in range(3, 16)):
            for W in (4, 8, 16, 32, 64):
                plan = nm.launch_plan(B, R, W, R + 1)
                big = B * R * W * 4 >= nm.MIN_STAGED_BYTES
                assert plan.route == ("staged" if big else "l2"), (B, R, W)


def test_few_long_graphs_over_many_blocks_take_l2():
    # A B3-like launch with aligned rows: every block would stage the whole
    # 129 KB state to read ~20 KB of ELL.
    assert nm.launch_plan(1, 32312, 20, 32313).route == "l2"
    assert nm.launch_plan(8, 32768, 16, 32769).route == "staged"


def test_plan_is_a_function_of_shape():
    a = nm.launch_plan(768, 4096, 32, 4097)
    assert a == nm.launch_plan(768, 4096, 32, 4097)
    assert a == nm.staged_plan(768, 4096, 32, 4097)
    assert a.route == "staged" and a.blocks == nm.SMS
    assert a.args() == (nm.ROUTES["staged"], a.rows_per_block,
                        nm.STAGED_THREADS, a.smem_bytes)
    l2 = nm.launch_plan(1, 32312, 18, 32313)
    assert l2 == nm.l2_plan(1, 32312, 18) and l2.args()[0] == nm.ROUTES["l2"]


@pytest.mark.parametrize("shape", [(768, 4096, 32), (512, 64, 8),
                                   (8, 32768, 16), (16, 4096, 4096)])
@pytest.mark.parametrize("block_rows", [4096, 1024, 256, 100])
def test_capped_staged_plan_covers_rows_and_fits(shape, block_rows):
    # block_rows caps the rows of a block (the sweep's tunable): more,
    # shorter blocks, each staging the graphs its shorter run touches.
    B, R, W = shape
    S, total = R + 1, B * R
    plan = nm.staged_plan(B, R, W, S, block_rows=block_rows)
    one_wave = nm.staged_plan(B, R, W, S)
    assert plan.rows_per_block == min(block_rows, one_wave.rows_per_block)
    assert plan.blocks == -(-total // plan.rows_per_block)
    starts, ends = _blocks(plan, total)
    assert starts[0] == 0 and ends[-1] == total
    assert (starts[1:] == ends[:-1]).all() and (ends > starts).all()
    assert S * 4 <= plan.smem_bytes <= one_wave.smem_bytes
    _check_segments(plan, R, S, starts, ends)
    assert plan.smem_bytes // (4 * S) == min(
        B, (plan.rows_per_block - 1) // R + 2, nm.SMEM_BYTES_MAX // (4 * S))


@pytest.mark.parametrize("shape", [(1, 32312, 18), (1, 60000, 8),
                                   (4, 256, 30)])
def test_staged_plan_refuses_what_it_cannot_run(shape):
    B, R, W = shape
    assert nm.staged_plan(B, R, W, R + 1) is None
    assert nm.staged_plan(B, R, W, R + 1, block_rows=64) is None


class _Entry:
    """Stands in for a ctypes function: takes argtypes and restype."""


def _fake_lib(version=None):
    lib = types.SimpleNamespace(nm_neighbor_min=_Entry(),
                                nm_label_agree=_Entry())
    if version is not None:
        def report():
            return version
        lib.nm_abi_version = report
    return lib


def test_baseline_binds_the_abi_its_library_reports():
    # A source without nm_abi_version is the one before the launch plan:
    # its entries take (..., S, device, stream).
    old = _fake_lib()
    assert measure.bind_baseline(old) == 1
    assert len(old.nm_neighbor_min.argtypes) == 10
    assert len(old.nm_label_agree.argtypes) == 9
    # This source's ABI: the plan's four ints before device and stream.
    new = _fake_lib(nm.ABI_VERSION)
    assert measure.bind_baseline(new) == nm.ABI_VERSION
    assert len(new.nm_neighbor_min.argtypes) == 14
    assert len(new.nm_label_agree.argtypes) == 13
    assert new.nm_neighbor_min.argtypes[-2] is ctypes.c_int
    assert new.nm_neighbor_min.argtypes[-1] is ctypes.c_void_p


@pytest.mark.parametrize("version", [0, 3, nm.ABI_VERSION + 1])
def test_baseline_refuses_an_abi_it_cannot_call(version):
    with pytest.raises(ValueError):
        measure.bind_baseline(_fake_lib(version))


# ---------------------------------------------------------------------------
# The agreement kernel's launch plan (``agreement.agreement_launch_plan``).
# ---------------------------------------------------------------------------

# (B, R, W, replicas): the smoke's precluster buckets, narrow and wide
# rows, few graphs, R = 2^15, W = 4096.
AG_SHAPES = [(768, 4096, 32, 3), (768, 4096, 16, 3), (24, 32768, 32, 3),
             (768, 4096, 32, 1), (192, 1024, 8, 3), (3, 64, 4, 3),
             (8, 200, 64, 1), (2, 64, 4096, 1), (96, 8192, 16, 3),
             (1536, 256, 4, 3), (0, 64, 8, 1)]


@pytest.mark.parametrize("shape", AG_SHAPES)
def test_agreement_plan_fits_the_card(shape):
    B, R, W, rep = shape
    p = ag.agreement_launch_plan(B, R, W, rep)
    assert p.route in ag.ROUTES and p.blocks >= 1
    assert p.smem_bytes <= nm.SMEM_BYTES_MAX
    if p.route == "warp":
        assert p.threads == 32 * ag.WARP_WARPS
        # A warp a row, a bitmap of R bits a warp; no more blocks than
        # rows need, eight an SM at most.
        assert p.smem_bytes == ag.WARP_WARPS * -(-R // 32) * 4
        assert p.blocks <= max(1, -(-(B // rep) * R // ag.WARP_WARPS))
        assert p.blocks <= ag.SMS * ag.WARP_BLOCKS_PER_SM
    else:
        # A block a graph, two an SM: rows no wider than a warp, and the
        # staged rows' fixed part leaves room for the ids.
        assert W <= ag.SMEM_MAX_WIDTH and R <= ag.SMEM_MAX_R
        assert p.threads == 32 * ag.SMEM_WARPS
        assert p.blocks == min(B // rep, 2 * ag.SMS)
        assert 2 * (p.smem_bytes + 1024 + 8) <= 233_472
        assert p.smem_bytes >= ag.smem_least_bytes(R)
        assert ag.smem_capacity(p, R) >= R


def test_agreement_plan_is_a_function_of_shape():
    for shape in AG_SHAPES:
        assert ag.agreement_launch_plan(*shape) == \
            ag.agreement_launch_plan(*shape)


@pytest.mark.parametrize("shape", [(24, 32768, 32, 3), (8, 200, 64, 1),
                                   (2, 64, 4096, 1), (96, 16384, 16, 3)])
def test_agreement_smem_route_refuses_what_it_cannot_stage(shape):
    """Rows wider than a warp, and graphs whose fixed part (meta and agree
    words) leaves no room for the fallback's bitmaps, take the warp
    route."""
    assert ag.smem_plan(*shape) is None
    assert ag.agreement_launch_plan(*shape).route == "warp"


def test_agreement_plan_of_the_smoke_buckets():
    """The smoke's 768-entry buckets stage their graphs; the R = 2^15
    bucket, whose rows do not fit, and launches of few graphs take the
    warp route."""
    assert ag.agreement_launch_plan(768, 4096, 32, 3).route == "smem"
    assert ag.agreement_launch_plan(768, 4096, 16, 3).route == "smem"
    assert ag.agreement_launch_plan(24, 32768, 32, 3).route == "warp"
    assert ag.agreement_launch_plan(3, 64, 4, 3).route == "warp"
    # A smaller block stages fewer ids.
    small = ag.smem_plan(768, 4096, 32, 3, smem_bytes=50_000)
    assert ag.smem_capacity(small, 4096) < \
        ag.smem_capacity(ag.smem_plan(768, 4096, 32, 3), 4096)
