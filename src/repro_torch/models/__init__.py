"""The language models of every family: served through kernel B4,
trained through chunked attention.

  common.py      — weights with their logical axes, init, norms, RoPE,
                   linears (row-parallel, reduce dtype), constrain
  sharding.py    — the plan (logical axes → mesh axes), local blocks
  parallel.py    — a rank's place on a mesh (or a stand-in mesh's),
                   counted collectives
  attention.py   — GQA attention: naive, chunked and B4 impls, causal or
                   not, self or gated cross; decode on a KV cache
  mlp.py         — SwiGLU and mixture of experts (sort and einsum
                   dispatch, token chunks, moe_ep_local)
  rwkv.py        — RWKV6 time and channel mix (exact scan, chunked form)
  ssm.py         — Mamba2 / SSD (chunked scan, decode step)
  transformer.py — ``RunConfig``, weights as modules, blocks of every
                   family, encoder, forward, head, the chunked
                   cross-entropy loss
  decoding.py    — prefill / decode_step with each family's caches
  model.py       — ``Model`` (weights, ``RunConfig``, entry points, spec
                   trees, the dry run's abstract trees), ``build_model``
                   (on a mesh with a plan)
  weights.py     — the reference's params tree and train state carried to
                   and from the port, whole or as a rank's blocks

Each mirrors its namesake in ``repro.models``; a model of every family
runs on a ``torch.distributed`` device mesh (``build_model(plan=,
mesh=)``), served and trained.
"""

from .model import Model, build_model

__all__ = ["Model", "build_model"]
