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

``abstract_train_state`` belongs to the dry run and the sharded layout,
which are not ported yet (ROADMAP A18).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from ..models.model import Model
from .compression import compress_decompress
from .optimizer import OptConfig, OptState, _DTYPES, opt_init, opt_update


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


def _value_and_grad(model: Model, params: Dict[str, torch.Tensor], batch
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    names = list(params)
    loss = model.loss(batch)
    grads = torch.autograd.grad(loss, [params[n] for n in names],
                                allow_unused=True)
    return loss.detach(), {
        n: torch.zeros_like(params[n]) if g is None else g
        for n, g in zip(names, grads)}


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

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params = state.params
        if accum == 1:
            loss, grads = _value_and_grad(model, params, batch)
        else:
            b = batch["tokens"].shape[0]
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

        err = state.err
        if sc.compress_cross_pod:
            grads, err = compress_decompress(grads, err)

        params, opt, metrics = opt_update(grads, state.opt, params, oc)
        metrics["loss"] = loss
        return TrainState(params=params, opt=opt, err=err), metrics

    return train_step


__all__ = ["TrainState", "StepConfig", "init_train_state", "make_train_step"]
