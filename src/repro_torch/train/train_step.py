"""Train step: microbatched gradient accumulation + AdamW.

The port of ``repro/train/train_step.py``. ``accum_steps > 1`` reshapes the
global batch (B, S) → (A, B/A, S), takes each microbatch's gradient in
turn and sums them in ``accum_dtype`` from zeros, then divides by A; the
loss is the mean of the microbatch losses. ``compress_cross_pod`` applies
the int8 error-feedback round trip (``train/compression.py``) to the
gradients before the update.

The parameters of a :class:`TrainState` are the model's own tensors, by
name, and the step updates them in place. The step itself sets no global
mode: ``launch/train.py`` runs it under
``torch.use_deterministic_algorithms(True)`` on the card, which makes the
loss trajectory reproducible bit for bit across a restart.

On a sharded dense or moe model (``build_model(plan=, mesh=)``) the same
step trains the rank's blocks. Every rank is given the whole batch and
runs its rows of it (``Layout.rows``, in ``loss_fn``); the loss is the
global batch's mean. A leaf sharded over data axes (ZeRO) is gathered
just before use and its gradient arrives reduce-scattered over those axes
(``parallel.gather_from``); every other leaf's gradient, and any data axis
its spec does not cover, is all-reduced after the backward (summed over
the microbatches first), one bucket a set of axes. The gradient norm, the
clipping and AdamW then run on each rank's blocks
(``optimizer.opt_update`` with the leaves' axes), compression with one
scale a whole leaf. With ``accum_steps > 1`` each microbatch must divide
over the batch's axes; the step raises where it does not (the dry run,
``launch/dryrun.py``, halves ``accum`` as the reference's does).

:func:`abstract_train_state` is the dry run's state: the params, the AdamW
moments in ``OptConfig.state_dtype`` and, with compression, the f32 error
tensors, as meta tensors (global shapes, their specs, and a rank's blocks
on a mesh), allocating nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from .. import spans
from ..models.model import AbstractTree, Model
from .compression import compress_decompress
from .optimizer import (OptConfig, OptState, _DTYPES, opt_init,
                        opt_state_specs, opt_update, sharded_axes,
                        state_dtype)


class TrainState(NamedTuple):
    params: Dict[str, torch.nn.Parameter]
    opt: OptState
    err: Optional[Dict[str, torch.Tensor]]   # error feedback, or None


@dataclasses.dataclass(frozen=True)
class StepConfig:
    accum_steps: int = 1
    compress_cross_pod: bool = False
    accum_dtype: str = "float32"     # grad accumulator (bf16 for >=90B)


def init_train_state(model: Model, oc: OptConfig,
                     sc: Optional[StepConfig] = None) -> TrainState:
    """The model's weights made trainable, zero moments and, with
    compression, zero f32 error tensors. The weights are the model's
    (drawn when it was built); the reference draws them here from a key."""
    sc = sc or StepConfig()
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    err = ({n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for n, p in params.items()} if sc.compress_cross_pod else None)
    return TrainState(params=params, opt=opt_init(params, oc), err=err)


def abstract_train_state(model: Model, oc: OptConfig,
                         sc: Optional[StepConfig] = None,
                         mesh=None) -> AbstractTree:
    """The :class:`TrainState` of ``model`` as an ``AbstractTree`` of
    ``TrainState`` s: the params (``Model.abstract_params``), each moment
    in ``oc.state_dtype`` with its parameter's spec, step 0, and with
    ``sc.compress_cross_pod`` the f32 error tensors; with ``mesh`` the
    rank's blocks too."""
    sc = sc or StepConfig()
    params = model.abstract_params(mesh=mesh)
    sdt = state_dtype(oc)

    def like(tree, dt):
        if tree is None:
            return None
        return {n: torch.empty(t.shape, dtype=dt, device="meta")
                for n, t in tree.items()}

    def state(tree):
        if tree is None:
            return None
        return TrainState(
            params=tree, opt=OptState(mu=like(tree, sdt), nu=like(tree, sdt),
                                      step=0),
            err=like(tree, torch.float32) if sc.compress_cross_pod else None)

    specs = TrainState(params=params.specs, opt=opt_state_specs(params.specs),
                       err=(dict(params.specs) if sc.compress_cross_pod
                            else None))
    return AbstractTree(state(params.whole), specs, state(params.local))


def state_bytes(state: TrainState) -> int:
    """Bytes of a state's params, moments and error tensors."""
    parts = (state.params, state.opt.mu, state.opt.nu, state.err or {})
    return sum(t.numel() * t.element_size()
               for part in parts for t in part.values())


def _value_and_grad(model: Model, params: Dict[str, torch.Tensor], batch
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    names = list(params)
    with spans.span("train.forward"):
        loss = model.loss(batch)
    with spans.span("train.backward"):
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)
    return loss.detach(), {
        n: torch.zeros_like(params[n]) if g is None else g
        for n, g in zip(names, grads)}


def _reduce_over_data(grads: Dict[str, torch.Tensor],
                      data_axes: Dict[str, Tuple[str, ...]], layout
                      ) -> Dict[str, torch.Tensor]:
    """Each gradient summed over the data axes its leaf's spec leaves
    whole (``data_axes[name]``; those its spec splits were reduce-scattered
    in the backward): one all-reduce of the flattened gradients of every
    (axes, dtype) group."""
    out = dict(grads)
    groups: Dict[tuple, list] = {}
    for n, g in grads.items():
        if data_axes[n]:
            groups.setdefault((data_axes[n], g.dtype), []).append(n)
    for (ax, _), names in groups.items():
        flat = layout.all_reduce(torch.cat([grads[n].reshape(-1)
                                            for n in names]), ax)
        for n, part in zip(names, flat.split([grads[n].numel()
                                              for n in names])):
            out[n] = part.view_as(grads[n])
    return out


def make_train_step(model: Model, oc: OptConfig,
                    sc: Optional[StepConfig] = None
                    ) -> Callable[[TrainState, Dict[str, torch.Tensor]],
                                  Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns ``train_step(state, batch) → (state, metrics)``; metrics
    ``loss``, ``grad_norm`` and ``lr`` are 0-d f32 tensors."""
    sc = sc or StepConfig()
    accum = sc.accum_steps
    if sc.accum_dtype not in _DTYPES:
        raise ValueError(f"accum_dtype {sc.accum_dtype!r} is not one of "
                         f"{tuple(_DTYPES)}")
    adt = _DTYPES[sc.accum_dtype]
    layout = model.layout
    axes = data_axes = None
    span = 1
    if layout is not None:
        batch_axes = layout.axes("batch")
        span = layout.span(batch_axes)
        axes = {n: sharded_axes(layout, spec)
                for n, spec in model.param_specs().items()}
        data_axes = {n: tuple(a for a in batch_axes if a not in ax)
                     for n, ax in axes.items()}

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        with spans.span("train.step"):
            return step(state, batch)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        b = batch["tokens"].shape[0]
        if (b // accum) % span:
            raise ValueError(f"a microbatch of {b // accum} rows does not "
                             f"divide over the batch's {span} ranks")
        if accum == 1:
            loss, grads = _value_and_grad(model, params, batch)
        else:
            if b % accum:
                raise ValueError(f"global batch {b} is not a multiple of "
                                 f"accum_steps {accum}")
            mbs = {k: v.reshape(accum, b // accum, *v.shape[1:])
                   for k, v in batch.items()}
            gsum = {n: torch.zeros(p.shape, dtype=adt, device=p.device)
                    for n, p in params.items()}
            lsum = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(accum):
                loss_i, g = _value_and_grad(
                    model, params, {k: v[i] for k, v in mbs.items()})
                gsum = {n: gsum[n] + g[n].to(adt) for n in gsum}
                lsum = lsum + loss_i
            grads = {n: gs / accum for n, gs in gsum.items()}
            loss = lsum / accum
        if layout is not None:
            grads = _reduce_over_data(grads, data_axes, layout)

        err = state.err
        if sc.compress_cross_pod:
            grads, err = compress_decompress(grads, err, layout, axes)

        with spans.span("train.optimizer"):
            params, opt, metrics = opt_update(grads, state.opt, params, oc,
                                              layout, axes)
        metrics["loss"] = loss
        return TrainState(params=params, opt=opt, err=err), metrics

    return train_step


__all__ = ["TrainState", "StepConfig", "init_train_state", "make_train_step",
           "abstract_train_state", "state_bytes"]
