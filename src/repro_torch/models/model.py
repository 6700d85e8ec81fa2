"""Model facade: the weights as an ``nn.Module`` with the entry points
``loss`` (training), ``prefill`` and ``decode_step`` (serving).

The port of ``repro/models/model.py``. The reference's ``Model`` holds a
config, a sharding plan and a ``RunConfig`` and takes the params on every
call; here the module owns its weights and its ``RunConfig``, so the calls
take none. ``build_model(plan=, mesh=)`` places a model of any family on a
``torch.distributed`` device mesh: each rank draws every leaf whole, in
the unsharded build's order and from the same generator, keeps its block
and frees the rest, so the ranks together hold exactly the unsharded
model's weights and none ever holds more than one whole leaf.
:meth:`Model.param_specs` and :meth:`Model.cache_specs` are the spec
trees of the reference's ``abstract_params`` and ``abstract_caches``
(the port's per-layer names; ``weights.reference_specs`` stacks them).
The rest of the dry run waits for ROADMAP 18e.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs.base import ModelConfig
from ..util import DeviceLike, resolve_device
from . import decoding, transformer
from .common import drawing_blocks, param_specs
from .parallel import Layout
from .sharding import ShardingPlan
from .transformer import RunConfig


class Model(transformer.Transformer):
    """A model's weights, its ``RunConfig`` and its entry points.

    An encdec model's entry points take the stub frame embeddings
    ``audio_embeds`` (B, encoder_seq, d), a VLM's the stub patch
    embeddings ``image_embeds`` (B, num_image_tokens, d), under the
    reference's batch keys; without them they raise ``ValueError`` naming
    the key."""

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator],
                 dtype: torch.dtype, device: torch.device,
                 rc: Optional[RunConfig] = None):
        super().__init__(cfg, generator, dtype, device)
        self.rc = rc or RunConfig()
        self.rc.check(cfg.family)

    def forward(self, tokens: torch.Tensor,
                audio_embeds: Optional[torch.Tensor] = None,
                image_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        return transformer.forward(self, self.cfg, self.rc, tokens,
                                   audio_embeds=audio_embeds,
                                   image_embeds=image_embeds)

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Mean next-token loss of ``{"tokens", "labels"}`` (B, S), with
        ``audio_embeds`` or ``image_embeds`` where the family reads
        them."""
        return transformer.loss_fn(self, self.cfg, self.rc, batch)

    def prefill(self, tokens: torch.Tensor, cache_len: Optional[int] = None,
                cache_dtype: torch.dtype = torch.bfloat16,
                audio_embeds: Optional[torch.Tensor] = None,
                image_embeds: Optional[torch.Tensor] = None):
        return decoding.prefill(self, self.cfg, tokens, cache_len=cache_len,
                                cache_dtype=cache_dtype, rc=self.rc,
                                audio_embeds=audio_embeds,
                                image_embeds=image_embeds)

    def decode_step(self, token: torch.Tensor,
                    caches: Dict[str, torch.Tensor], pos: int):
        return decoding.decode_step(self, self.cfg, token, caches, pos,
                                    rc=self.rc)

    def param_specs(self, plan: Optional[ShardingPlan] = None
                    ) -> Dict[str, tuple]:
        """Each weight's spec under ``plan`` (the model's own plan, or
        the null plan, when None), keyed like ``state_dict``."""
        return param_specs(self, plan or self.plan)

    def cache_specs(self, plan: Optional[ShardingPlan] = None
                    ) -> Dict[str, tuple]:
        """Each cache leaf's spec under ``plan`` (as above)."""
        return decoding.cache_specs(self.cfg, plan or self.plan)

    @property
    def plan(self) -> ShardingPlan:
        return (self.layout.plan if self.layout is not None
                else ShardingPlan.null())


def build_model(cfg: ModelConfig, device: DeviceLike = None,
                dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None,
                rc: Optional[RunConfig] = None,
                plan: Optional[ShardingPlan] = None, mesh=None) -> Model:
    """A model with weights drawn from ``generator`` (a fresh CPU generator
    seeded 0 when None) and placed on ``device``, running with ``rc``
    (``RunConfig()`` when None: chunked attention in ``forward`` and
    ``loss``; serving always takes kernel B4).

    ``device=None`` means CUDA and raises without it; ``"cpu"`` runs the
    plain path; ``"meta"`` builds the shapes and allocates nothing.

    With an active ``plan`` and a ``DeviceMesh`` ``mesh`` (both, or
    neither: ``ValueError``) every rank of the mesh calls this together
    and holds its blocks (module docstring); ``rc.mesh``, which
    ``moe_impl='ep_local'`` reads, must then be None or this mesh. Every
    family shards; the RWKV and Mamba2 mixers need their heads to divide
    over the plan's ``ff`` axes (``ValueError`` on the first call where
    they do not).
    """
    meta = device is not None and torch.device(device).type == "meta"
    dev = torch.device("meta") if meta else resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator().manual_seed(0)
    active = plan is not None and plan.active
    if active != (mesh is not None):
        raise ValueError("a sharded model needs both an active plan and a "
                         "mesh")
    if not active:
        return Model(cfg, generator, dtype, dev, rc)
    if rc is not None and rc.mesh is not None and rc.mesh is not mesh:
        raise ValueError("RunConfig.mesh and build_model's mesh differ")
    layout = Layout(plan, mesh)
    with drawing_blocks(layout):
        model = Model(cfg, generator, dtype, dev, rc)
    model.layout = layout
    return model


__all__ = ["Model", "build_model"]
