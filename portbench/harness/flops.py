"""The yardstick's arithmetic: the H100's peaks, a decoder's model FLOPs
and kernel B4's operations and bytes, from the shapes alone.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, at 700 W): 3.35
TB/s of HBM, 67 TFLOP/s of float32 outside the tensor cores, 495 TFLOP/s
of TF32 and 989 TFLOP/s of bf16 on them. The cells run float32 with TF32
off; the fastest product that keeps float32 accuracy on this chip is three
TF32 passes (``hi·hi + hi·lo + lo·hi``), which B4 already takes, so every
share of a float32 peak here is against 495 / 3 = 165 TFLOP/s.

Model FLOPs count two per multiply-add of the products a decoder needs:
the q, k, v and output projections; the SwiGLU, or the router and the
``top_k`` experts a token visits at their width; the attention scores and
values over the causal half that the mask lets through; and the head over
the padded vocabulary for each position whose logits are taken (the last
one of a prefill, every one in training). Training counts three forwards.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FMA_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
F32_PEAK_FLOPS = TF32_FLOPS / 3


def causal_pairs(rows: int, keys: int) -> int:
    """(query, key) pairs a causal mask keeps, rows offset by keys - rows:
    row ``i`` sees keys ``0 .. i + keys - rows``."""
    return rows * (keys - rows + 1) + rows * (rows - 1) // 2


def layer_flops(spec, tokens: int, pairs: int) -> float:
    """One decoder layer over ``tokens`` positions with ``pairs`` causal
    (query, key) pairs per head."""
    d, hd = spec.d_model, spec.head_dim
    nq, nkv = spec.heads * hd, spec.kv_heads * hd
    proj = 2.0 * tokens * d * (2 * nq + 2 * nkv)
    attn = 4.0 * pairs * spec.heads * hd
    if spec.moe:
        ffn = 2.0 * tokens * d * spec.experts \
            + 6.0 * tokens * d * spec.d_ff * spec.top_k
    else:
        ffn = 6.0 * tokens * d * spec.d_ff
    return proj + attn + ffn


def forward_flops(spec, batch: int, seq: int, head_positions: int) -> float:
    """A forward over ``batch`` sequences of ``seq`` tokens, the head over
    ``head_positions`` positions."""
    body = spec.layers * layer_flops(spec, batch * seq,
                                     batch * causal_pairs(seq, seq))
    return body + 2.0 * head_positions * spec.d_model * spec.padded_vocab


def prefill_flops(spec, seq: int) -> float:
    """One prompt of ``seq`` tokens, logits of its last position."""
    return forward_flops(spec, 1, seq, 1)


def train_step_flops(spec, batch: int, seq: int) -> float:
    """Forward and backward over ``batch`` × ``seq`` tokens."""
    return 3.0 * forward_flops(spec, batch, seq, batch * seq)


def b4_ops_bytes(heads: int, kv_heads: int, rows: int, keys: int,
                 head_dim: int, itemsize: int = 4):
    """(FLOPs, bytes) of one causal B4 launch over one sequence: the score
    and value products over the kept pairs; q, k, v read once and the
    output written once."""
    ops = 4.0 * head_dim * heads * causal_pairs(rows, keys)
    nbytes = itemsize * head_dim * (2 * heads * rows + 2 * kv_heads * keys)
    return ops, nbytes


def b4_bound_s(spec, seq: int) -> float:
    """The least time of one B4 launch of a ``seq``-token prefill: the
    larger of its FLOPs at the float32 peak and its bytes at HBM's rate."""
    ops, nbytes = b4_ops_bytes(spec.heads, spec.kv_heads, seq, seq,
                               spec.head_dim)
    return max(ops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


__all__ = ["HBM_BYTES_PER_S", "F32_PEAK_FLOPS", "causal_pairs",
           "layer_flops", "forward_flops", "prefill_flops",
           "train_step_flops", "b4_ops_bytes", "b4_bound_s"]
