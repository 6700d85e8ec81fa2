"""The Mamba2 chunked scan's (SSD's) operations and bytes, from the shapes
alone, whatever computes the scan: the yardstick of
``metrics/ssd_roofline.prefill.py``.

For one token of one layer, with H heads of P channels, a state of N and
chunks of Q tokens:

* FLOPs, the chunked form's least at chunk Q on the causal half: within a
  chunk a token meets Q/2 others on average, each pair costing 2·N for
  ``C_t·B_s`` (shared by the heads) and 2·H·P for the weighted sum of
  ``x_s``, so ``2·(Q/2)·(N + H·P)``; and ``4·H·N·P`` for its part of the
  chunk's state and of the state's read-out.
* Bytes: x (H·P), dt (H), B and C (N each) read and y (H·P) written, once
  each, in float32.

Both are linear in tokens, so the bound of a run of scans is that of
their tokens together. Peaks are ``harness/flops.py``'s (165 TFLOP/s of
float32 accuracy, 3.35 TB/s).
"""

from __future__ import annotations

from .flops import F32_PEAK_FLOPS, HBM_BYTES_PER_S

F32_BYTES = 4


def flops_per_token(heads: int, head_dim: int, state: int,
                    chunk: int) -> float:
    return 2.0 * (chunk / 2) * (state + heads * head_dim) \
        + 4.0 * heads * state * head_dim


def bytes_per_token(heads: int, head_dim: int, state: int) -> float:
    return float(F32_BYTES * (2 * heads * head_dim + heads + 2 * state))


def bound_s(spec, tokens: int) -> float:
    """The least time the card could take to scan ``tokens`` tokens (summed
    over layers) of ``spec``'s shape: the larger of the FLOPs at the
    float32 peak and the bytes at the HBM rate."""
    f = flops_per_token(spec.ssm_heads, spec.ssm_head_dim, spec.ssm_state,
                        spec.chunk)
    b = bytes_per_token(spec.ssm_heads, spec.ssm_head_dim, spec.ssm_state)
    return tokens * max(f / F32_PEAK_FLOPS, b / HBM_BYTES_PER_S)


__all__ = ["flops_per_token", "bytes_per_token", "bound_s"]
