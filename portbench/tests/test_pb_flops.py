"""The yardstick's FLOP and byte counts against numbers worked by hand."""

import pytest

from harness import flops
from reference.decoder import Spec

# d 4, 2 query heads and 1 key/value head of 2, SwiGLU 8, vocabulary 10
# held as 16 rows, one layer.
TINY = Spec(layers=1, d_model=4, heads=2, kv_heads=1, head_dim=2, d_ff=8,
            vocab=10, padded_vocab=16, tied=True, rope_theta=1e4, eps=1e-5)
TINY_MOE = Spec(layers=1, d_model=4, heads=2, kv_heads=1, head_dim=2,
                d_ff=8, vocab=10, padded_vocab=16, tied=False,
                rope_theta=1e4, eps=1e-5, experts=4, top_k=2)


def test_causal_pairs():
    # 3 rows against 3 keys: 1 + 2 + 3; against 5 keys: 3 + 4 + 5.
    assert flops.causal_pairs(3, 3) == 6
    assert flops.causal_pairs(3, 5) == 12


def test_dense_layer_and_prefill():
    # 3 tokens: projections 2·3·4·(2·4 + 2·2) = 288; scores and values
    # 4·6 pairs·2 heads·2 = 96; SwiGLU 6·3·4·8 = 576.
    assert flops.layer_flops(TINY, 3, 6) == 288 + 96 + 576
    # The head of the last position: 2·4·16 = 128.
    assert flops.prefill_flops(TINY, 3) == 960 + 128


def test_moe_layer():
    # Router 2·3·4·4 = 96 and two experts of 8: 6·3·4·8·2 = 1,152.
    assert flops.layer_flops(TINY_MOE, 3, 6) == 288 + 96 + 96 + 1152


def test_train_step():
    # Three forwards of 1 × 3 tokens, the head at every position:
    # 3 · (960 + 2·3·4·16).
    assert flops.train_step_flops(TINY, 1, 3) == 3 * (960 + 384)


def test_b4_at_granite_shape():
    # (1, 32, 8, 1719, 1719), D = 64, f32: 1,478,340 causal pairs;
    # 4·64·32·pairs FLOPs; 4·64·(2·32 + 2·8)·1719 bytes; the FLOPs at
    # 165 TFLOP/s bound it: 0.0734 ms, the kernel table's bound.
    ops, nbytes = flops.b4_ops_bytes(32, 8, 1719, 1719, 64)
    assert ops == 4 * 64 * 32 * 1_478_340
    assert nbytes == 35_205_120
    spec = Spec(layers=40, d_model=2048, heads=32, kv_heads=8, head_dim=64,
                d_ff=8192, vocab=49155, padded_vocab=49408, tied=True,
                rope_theta=1e4, eps=1e-5)
    assert flops.b4_bound_s(spec, 1719) == pytest.approx(ops / 165e12)
    assert flops.b4_bound_s(spec, 1719) * 1e3 == pytest.approx(0.0734,
                                                               abs=5e-5)


def test_peak_is_three_tf32_passes():
    assert flops.F32_PEAK_FLOPS == pytest.approx(165e12)
