"""The LM half of the port's roofline (``repro_torch.launch.roofline``)
against the reference's (``repro.launch.roofline``).

The analytic counts are the reference's arithmetic term for term, so every
(arch × shape) cell must give the same float (``==``, no tolerance):
``forward_flops`` (with ``kv_len`` and ``is_decode``), ``step_flops`` for
the ``sort`` and ``einsum`` MoE impls, ``model_flops``,
``active_param_count`` and ``hbm_bytes`` on the same byte counts.
``Roofline`` given the reference's rates gives the reference's bottleneck,
useful share and roofline fraction; by default it takes the H100's. The
reference's analytic tests (``tests/test_roofline.py``) are mirrored on
the port.
"""

import pytest

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.launch import roofline as ref
from repro_torch.configs import ARCH_NAMES, SHAPES, get_config
from repro_torch.kernels.measure import (BF16_TENSOR_OPS_PER_S,
                                         HBM_BYTES_PER_S,
                                         INFINIBAND_BYTES_PER_S,
                                         NON_TENSOR_OPS_PER_S,
                                         NVLINK_BYTES_PER_S)
from repro_torch.launch import roofline as rl

CELLS = [(a, s) for a in ARCH_NAMES for s in SHAPES]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_analytic_counts_equal_the_reference(arch, shape):
    cfg, rcfg = get_config(arch), ref_config(arch)
    sh, rsh = SHAPES[shape], REF_SHAPES[shape]
    b, s = sh.global_batch, sh.seq_len
    assert rl.forward_flops(cfg, b, s) == ref.forward_flops(rcfg, b, s)
    for kv in (None, 1, s // 2):
        for dec in (False, True):
            for impl in ("sort", "einsum"):
                assert rl.forward_flops(
                    cfg, b, 1 if dec else s, kv_len=kv, moe_impl=impl,
                    is_decode=dec) == ref.forward_flops(
                    rcfg, b, 1 if dec else s, kv_len=kv, moe_impl=impl,
                    is_decode=dec)
    for impl in ("sort", "einsum"):
        assert rl.step_flops(cfg, sh, moe_impl=impl) \
            == ref.step_flops(rcfg, rsh, moe_impl=impl)
    assert rl.model_flops(cfg, sh) == ref.model_flops(rcfg, rsh)
    assert rl.active_param_count(cfg) == ref.active_param_count(rcfg)
    pb = 2 * rcfg.param_count()
    for cache, opt in ((0, 0), (96_636_764_160, 0), (0, 8 * pb)):
        assert rl.hbm_bytes(cfg, sh, pb, cache, opt) \
            == ref.hbm_bytes(rcfg, rsh, pb, cache, opt)


ROOFS = [dict(chips=256, flops=1e18, bytes_hbm=1e12, coll_bytes=1e12),
         dict(chips=512, flops=3e15, bytes_hbm=9e13, coll_bytes=2e11),
         dict(chips=256, flops=1e14, bytes_hbm=1e11, coll_bytes=8e13),
         dict(chips=1, flops=0.0, bytes_hbm=0.0, coll_bytes=0.0)]


@pytest.mark.parametrize("terms", ROOFS)
def test_roofline_at_the_reference_rates_equals_the_reference(terms):
    """Same terms, same rates: same times, bottleneck and shares."""
    mf = 0.8 * terms["flops"]
    want = ref.Roofline(hlo_flops_raw=0.0, hlo_bytes_raw=0.0,
                        model_flops_=mf, **terms)
    got = rl.Roofline(hlo_flops_raw=None, hlo_bytes_raw=None,
                      model_flops_=mf, peak_flops=ref.PEAK_FLOPS_BF16,
                      mem_bw=ref.HBM_BW, link_bw=ref.ICI_BW, **terms)
    for prop in ("t_compute", "t_memory", "t_collective", "bottleneck",
                 "useful_ratio", "roofline_fraction"):
        assert getattr(got, prop) == getattr(want, prop), prop
    a, b = got.as_dict(), want.as_dict()
    assert list(a) == list(b)
    assert a["hlo_flops_raw"] is None and a["hlo_bytes_raw"] is None


def test_roofline_defaults_are_the_h100_rates():
    """bf16 tensor peak, HBM rate, NVLink within a node and InfiniBand
    beyond; a caller running f32 passes its own peak."""
    r = rl.Roofline(chips=256, flops=1e18, bytes_hbm=1e12, coll_bytes=1e12,
                    hlo_flops_raw=None, hlo_bytes_raw=None, model_flops_=8e17)
    assert r.t_compute == 1e18 / (256 * BF16_TENSOR_OPS_PER_S)
    assert r.t_memory == 1e12 / (256 * HBM_BYTES_PER_S)
    assert r.t_collective == 1e12 / (256 * INFINIBAND_BYTES_PER_S)
    one = rl.Roofline(chips=8, flops=1e15, bytes_hbm=0.0, coll_bytes=8e9,
                      hlo_flops_raw=None, hlo_bytes_raw=None,
                      model_flops_=1e15, peak_flops=NON_TENSOR_OPS_PER_S)
    assert one.t_collective == 8e9 / (8 * NVLINK_BYTES_PER_S)
    assert one.t_compute == 1e15 / (8 * NON_TENSOR_OPS_PER_S)
    assert one.roofline_fraction == 1.0


# -- the reference's analytic tests (tests/test_roofline.py), on the port --


def test_analytic_flops_scale_with_tokens():
    cfg = get_config("qwen3-8b")
    f1 = rl.forward_flops(cfg, 1, 1024)
    f2 = rl.forward_flops(cfg, 2, 1024)
    assert 1.9 < f2 / f1 < 2.1
    # ~2·N·D at short seq (attention negligible)
    n = cfg.param_count()
    assert 0.8 < f1 / (2 * n * 1024) < 1.3


def test_moe_active_params():
    cfg = get_config("olmoe-1b-7b")
    total = cfg.param_count()
    active = rl.active_param_count(cfg)
    assert active < 0.35 * total  # 8/64 experts active (+dense parts)


def test_train_flops_is_3x_forward():
    cfg = get_config("granite-3-2b")
    shape = SHAPES["train_4k"]
    assert abs(rl.step_flops(cfg, shape)
               / (3 * rl.forward_flops(cfg, shape.global_batch,
                                       shape.seq_len)) - 1) < 1e-6


def test_decode_flops_excludes_encoder():
    cfg = get_config("whisper-base")
    f_dec = rl.step_flops(cfg, SHAPES["decode_32k"])
    f_pre = rl.step_flops(cfg, SHAPES["prefill_32k"])
    assert f_dec < 0.05 * f_pre  # one token vs 32k prompt + encoder


def test_roofline_terms_and_bottleneck():
    r = rl.Roofline(chips=256, flops=1e18, bytes_hbm=1e12, coll_bytes=1e12,
                    hlo_flops_raw=None, hlo_bytes_raw=None,
                    model_flops_=8e17)
    assert r.t_compute > r.t_memory
    assert r.bottleneck == "compute"
    assert 0.79 < r.useful_ratio < 0.81
    assert abs(r.roofline_fraction - 0.8) < 1e-6
