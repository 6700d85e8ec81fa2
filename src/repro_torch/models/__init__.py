"""The language models of every family: served through kernel B4,
trained through chunked attention.

  common.py      — init, norms, RoPE, linears
  attention.py   — GQA attention: naive, chunked and B4 impls, causal or
                   not, self or gated cross; decode on a KV cache
  mlp.py         — SwiGLU and mixture of experts (sort and einsum
                   dispatch, token chunks)
  rwkv.py        — RWKV6 time and channel mix (exact scan, chunked form)
  ssm.py         — Mamba2 / SSD (chunked scan, decode step)
  transformer.py — ``RunConfig``, weights as modules, blocks of every
                   family, encoder, forward, head, the chunked
                   cross-entropy loss
  decoding.py    — prefill / decode_step with each family's caches
  model.py       — ``Model`` (weights, ``RunConfig``, entry points),
                   ``build_model``
  weights.py     — the reference's params tree and train state carried to
                   and from the port

Each mirrors its namesake in ``repro.models`` (sharding waits for ROADMAP
A18d).
"""

from .model import Model, build_model

__all__ = ["Model", "build_model"]
