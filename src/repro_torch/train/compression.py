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

from typing import Dict, Mapping, Optional, Tuple

import torch

from ..models.weights import reference_path
from .optimizer import reduce_by_axes


def compress_decompress(grads: Mapping[str, torch.Tensor],
                        err: Mapping[str, torch.Tensor], layout=None,
                        axes: Optional[Mapping[str, Tuple[str, ...]]] = None
                        ) -> Tuple[Dict[str, torch.Tensor],
                                   Dict[str, torch.Tensor]]:
    """int8 quantize → dequantize with error feedback, per reference leaf.

    Returns (dequantized f32 grads, new error tensors), both keyed like
    ``grads``. Rounding is half to even, as ``jnp.round``'s. On a mesh
    (``layout``) the tensors are the rank's blocks and ``axes`` names each
    leaf's split mesh axes: a leaf's scale is the max of ``|g + err|``
    over the whole leaf, its blocks' maxima all-reduced (max) over those
    axes, not the block's own.
    """
    target = {n: g.float() + err[n] for n, g in grads.items()}
    leaves: Dict[tuple, list] = {}
    for n in grads:
        leaves.setdefault(reference_path(n)[0], []).append(n)
    amaxes = [torch.stack([target[n].abs().max() for n in names]).max()
              for names in leaves.values()]
    if layout is not None:
        amaxes = reduce_by_axes(amaxes, [axes[names[0]] for names in
                                         leaves.values()], layout, "max")
    deq, new_err = {}, {}
    for names, amax in zip(leaves.values(), amaxes):
        scale = torch.clamp(amax, min=1e-12) / 127.0
        for n in names:
            q = torch.clamp(torch.round(target[n] / scale), -127, 127).to(
                torch.int8)
            deq[n] = q.float() * scale
            new_err[n] = target[n] - deq[n]
    return deq, new_err


__all__ = ["compress_decompress"]
