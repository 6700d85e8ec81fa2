"""The dense language model, served through kernel B4.

  common.py      — init, norms, RoPE, linears
  attention.py   — GQA attention: prefill through B4, decode on a KV cache
  mlp.py         — SwiGLU
  transformer.py — dense weights as modules, blocks, forward, head
  decoding.py    — prefill / decode_step with (L, B, S, KH, hd) caches
  model.py       — ``Model`` (weights + entry points), ``build_model``
  weights.py     — the reference's params tree carried into a ``Model``

Each mirrors its namesake in ``repro.models``, cut to the dense family.
"""

from .model import Model, build_model

__all__ = ["Model", "build_model"]
