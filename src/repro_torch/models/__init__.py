"""The dense language model: served through kernel B4, trained through
chunked attention.

  common.py      — init, norms, RoPE, linears
  attention.py   — GQA attention: naive, chunked and B4 impls; decode on
                   a KV cache
  mlp.py         — SwiGLU
  transformer.py — ``RunConfig``, dense weights as modules, blocks,
                   forward, head, the chunked cross-entropy loss
  decoding.py    — prefill / decode_step with (L, B, S, KH, hd) caches
  model.py       — ``Model`` (weights, ``RunConfig``, entry points),
                   ``build_model``
  weights.py     — the reference's params tree and train state carried to
                   and from the port

Each mirrors its namesake in ``repro.models``, cut to the dense family.
"""

from .model import Model, build_model

__all__ = ["Model", "build_model"]
