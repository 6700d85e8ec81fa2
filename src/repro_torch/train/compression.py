"""Int8 error-feedback gradient compression for cross-pod data parallelism.

The port of ``repro/train/compression.py``: before the cross-pod gradient
reduction each gradient leaf is quantized to int8 with a per-leaf scale,
and the quantization error is added back on the next step (error feedback
keeps the scheme unbiased in the long run). As in the reference, the
reduction itself is not compressed here: the int8 round trip is applied
and the dequantized values go on.

A leaf is the reference's: its layers are stacked in one array there, so
the port's per-layer tensors of one reference leaf (``blocks.<l>.attn.wq``
for every l) share one scale, the largest over all of them.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from ..models.weights import reference_path


def compress_decompress(grads: Mapping[str, torch.Tensor],
                        err: Mapping[str, torch.Tensor]
                        ) -> Tuple[Dict[str, torch.Tensor],
                                   Dict[str, torch.Tensor]]:
    """int8 quantize → dequantize with error feedback, per reference leaf.

    Returns (dequantized f32 grads, new error tensors), both keyed like
    ``grads``. Rounding is half to even, as ``jnp.round``'s.
    """
    target = {n: g.float() + err[n] for n, g in grads.items()}
    leaves: Dict[tuple, list] = {}
    for n in grads:
        leaves.setdefault(reference_path(n)[0], []).append(n)
    deq, new_err = {}, {}
    for names in leaves.values():
        amax = torch.stack([target[n].abs().max() for n in names]).max()
        scale = torch.clamp(amax, min=1e-12) / 127.0
        for n in names:
            q = torch.clamp(torch.round(target[n] / scale), -127, 127).to(
                torch.int8)
            deq[n] = q.float() * scale
            new_err[n] = target[n] - deq[n]
    return deq, new_err


__all__ = ["compress_decompress"]
