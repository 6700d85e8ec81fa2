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

The dry run's trees (``launch/dryrun.py``): :meth:`Model.abstract_params`,
:meth:`Model.abstract_caches` and :meth:`Model.input_specs` return an
:class:`AbstractTree`, whose leaves are meta tensors (shapes and dtypes,
nothing allocated): the global tree, its spec tree, and with a ``mesh``
(a ``DeviceMesh`` or a stand-in, ``launch/mesh.standin_mesh``) the
blocks the rank at the mesh's coordinates holds, each
``sharding.local_block`` of its whole leaf. :meth:`Model.input_shardings`
is the reference's spec tree of the inputs. The reference traces its init
under ``jax.eval_shape``; here the shapes come from the model's own
tensors (a model built on the meta device allocates none).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..util import DeviceLike, resolve_device
from . import decoding, transformer
from .common import drawing_blocks, param_specs
from .parallel import Layout
from .sharding import (ShardingPlan, Spec, axes_span, entry_axes,
                       local_block, mesh_axis_sizes, mesh_coords)
from .transformer import RunConfig


class AbstractTree(NamedTuple):
    """A tree of leaves by name: ``whole`` the global leaves as meta
    tensors, ``specs`` each leaf's spec, ``local`` the rank's blocks on a
    mesh as meta tensors (None without a mesh)."""
    whole: Any
    specs: Any
    local: Any = None


def tree_bytes(tree: Optional[Mapping[str, torch.Tensor]]) -> int:
    """Bytes of a tree's tensors (None: 0)."""
    if tree is None:
        return 0
    return sum(t.numel() * t.element_size() for t in tree.values())


def _abstract_tree(leaves: Mapping[str, tuple], specs: Mapping[str, Spec],
                   mesh=None) -> AbstractTree:
    """An :class:`AbstractTree` of ``leaves`` ({name: (shape, dtype)})
    with ``specs``; with ``mesh``, the rank's blocks too."""
    whole = {n: torch.empty(tuple(shape), dtype=dt, device="meta")
             for n, (shape, dt) in leaves.items()}
    local = None
    if mesh is not None:
        sizes, coords = mesh_axis_sizes(mesh), mesh_coords(mesh)
        local = {n: torch.empty(
            tuple(sl.stop - sl.start for sl in local_block(
                shape, specs[n], sizes, coords)), dtype=dt, device="meta")
            for n, (shape, dt) in leaves.items()}
    return AbstractTree(whole, dict(specs), local)


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

    # -- the dry run's trees (module docstring) --------------------------

    def _whole_shape(self, name: str, p: torch.Tensor) -> tuple:
        """The global shape of weight ``name``, whose block ``p`` is."""
        if self.layout is None:
            return tuple(p.shape)
        spec = self.layout.plan.P(*self.param_axes[name])
        return tuple(n * axes_span(entry_axes(spec[d]), self.layout.sizes)
                     if d < len(spec) else n for d, n in enumerate(p.shape))

    def abstract_params(self, mesh=None) -> AbstractTree:
        """Every weight, by ``state_dict`` name: its global shape and
        dtype, its spec under the model's plan, and with ``mesh`` the
        rank's block."""
        leaves = {n: (self._whole_shape(n, p), p.dtype)
                  for n, p in self.named_parameters()}
        return _abstract_tree(leaves, self.param_specs(), mesh)

    def abstract_caches(self, batch: int, seq_len: int,
                        cache_dtype: torch.dtype = torch.bfloat16,
                        mesh=None) -> AbstractTree:
        """The caches of ``batch`` sequences of ``seq_len`` positions
        (recurrent states in f32, the rest in ``cache_dtype``), their specs
        under the model's plan, and with ``mesh`` the rank's blocks, as
        ``decoding.init_caches`` allocates them."""
        leaves = {n: (shape, torch.float32 if f32 else cache_dtype)
                  for n, (shape, f32) in decoding.cache_shapes(
                      self.cfg, batch, seq_len).items()}
        return _abstract_tree(leaves, self.cache_specs(), mesh)

    def input_specs(self, shape: ShapeConfig,
                    act_dtype: torch.dtype = torch.bfloat16,
                    mesh=None) -> AbstractTree:
        """Every model input of ``shape``, the reference's keys, shapes
        and dtypes: ``tokens`` (and ``labels`` to train) int32 (B, S), or
        one decode ``token`` int32 (B,); ``audio_embeds`` /
        ``image_embeds`` in ``act_dtype`` where the family reads them
        (not to decode); their specs (:meth:`input_shardings`) and with
        ``mesh`` the rank's blocks. The entry points themselves take the
        whole batch on every rank and keep their rows."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        i32 = torch.int32
        if shape.kind == "train":
            leaves = {"tokens": ((b, s), i32), "labels": ((b, s), i32)}
        elif shape.kind == "prefill":
            leaves = {"tokens": ((b, s), i32)}
        else:   # decode: one new token against a seq_len cache
            leaves = {"token": ((b,), i32)}
        if cfg.family == "encdec" and shape.kind != "decode":
            leaves["audio_embeds"] = ((b, cfg.encoder_seq, cfg.d_model),
                                      act_dtype)
        if cfg.family == "vlm" and shape.kind != "decode":
            leaves["image_embeds"] = ((b, cfg.num_image_tokens,
                                       cfg.d_model), act_dtype)
        return _abstract_tree(leaves, self.input_shardings(shape), mesh)

    def input_shardings(self, shape: ShapeConfig) -> Dict[str, Spec]:
        """The inputs' specs under the model's plan: the batch dim over
        the plan's ``batch`` axes, the rest whole."""
        plan = self.plan
        p_batch_seq = plan.P("batch", None)
        if shape.kind == "decode":
            out = {"token": plan.P("batch")}
        elif shape.kind == "prefill":
            out = {"tokens": p_batch_seq}
        else:
            out = {"tokens": p_batch_seq, "labels": p_batch_seq}
        p_embed3 = plan.P("batch", None, None)
        if self.cfg.family == "encdec" and shape.kind != "decode":
            out["audio_embeds"] = p_embed3
        if self.cfg.family == "vlm" and shape.kind != "decode":
            out["image_embeds"] = p_embed3
        return out

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
    they do not). The hybrid_moe family runs on one device only, and
    holds the block of experts its config names.
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
    if cfg.family == "hybrid_moe":
        raise NotImplementedError("the hybrid_moe family is not sharded "
                                  "over a mesh yet (ROADMAP E)")
    if rc is not None and rc.mesh is not None and rc.mesh is not mesh:
        raise ValueError("RunConfig.mesh and build_model's mesh differ")
    layout = Layout(plan, mesh)
    with drawing_blocks(layout):
        model = Model(cfg, generator, dtype, dev, rc)
    model.layout = layout
    return model


__all__ = ["Model", "build_model", "AbstractTree", "tree_bytes"]
