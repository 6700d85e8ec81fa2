"""Checkpointing: atomic step snapshots and restart.

The port of ``repro/train/checkpoint.py``, with its on-disk layout, so a
checkpoint written by either package restores in the other::

    <dir>/step_00000123/
        manifest.json     — step, per-leaf shape and dtype, per-leaf SHA1,
                            extra
        arrays.npz        — flat leaf arrays keyed by the reference's tree
                            path strings (``.params/['embed']``, layers
                            stacked on a leading axis, ``.opt/.step``)

* **Atomicity**: written to ``step_X.tmp``, then renamed; a crash while
  writing never corrupts the latest valid checkpoint.
* **Integrity**: each leaf's SHA1 is checked on load.
* **Data cursor**: the pipeline is a pure function of the step, so the
  manifest's ``step`` alone resumes the token order.

* **Elastic re-layout**: the arrays are saved whole (gathered on the
  host). ``restore_checkpoint(..., shardings=(plan, mesh))`` lays them out
  for the mesh the job restarted with: each rank reads every array,
  checks its hash and keeps its block of each leaf by the leaf's spec
  (``sharding.local_block``), so a template of a sharded model's blocks
  restores from any checkpoint of the same model.
* **Saving from a sharded state**: ``save_checkpoint(..., layout=)`` gathers
  every leaf of the parameters, moments and error feedback by its spec
  (``Layout.gather_spec``, an all-gather a split dim, on every rank); rank
  0 of the default group writes and renames, and every rank waits on a
  barrier after the rename, so no rank reads a half-written step. The
  arrays equal an unsharded save of the same values, byte for byte.
"""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch.distributed as dist

from ..models.sharding import local_block, mesh_axis_sizes, mesh_coords
from ..models.weights import (load_train_state_arrays, train_state_arrays,
                              train_state_keys)
from .train_step import TrainState


def _arrays(state: TrainState, layout=None):
    """The flat leaves of ``state``; of the whole leaves gathered from a
    sharded state's blocks where ``layout`` is given (every rank gathers;
    ranks other than 0 get None)."""
    if layout is None:
        return train_state_arrays(state.params, state.opt.mu, state.opt.nu,
                                  state.opt.step, state.err)
    keep = dist.get_rank() == 0
    specs = {n: layout.plan.P(*p.axes) for n, p in state.params.items()}

    def whole(tensors):
        out = {}
        for n, t in tensors.items():
            w = layout.gather_spec(t.detach().contiguous(), specs[n])
            if keep:
                out[n] = w.cpu()
        return out

    parts = [whole(t) for t in (state.params, state.opt.mu, state.opt.nu)]
    err = whole(state.err) if state.err is not None else None
    return (train_state_arrays(*parts, state.opt.step, err) if keep
            else None)


def save_checkpoint(directory: str | Path, step: int, state: TrainState,
                    extra: Optional[dict] = None, layout=None) -> Path:
    """Write ``state`` as step ``step`` under ``directory``; returns the
    step's directory. ``layout``: the model's ``Layout`` where ``state``
    holds a sharded model's blocks; every rank of the default group then
    calls this together (module docstring)."""
    directory = Path(directory)
    final = directory / f"step_{step:08d}"
    arrays = _arrays(state, layout)
    if arrays is not None:
        _write(directory, step, arrays, extra)
    if layout is not None:
        dist.barrier()
    return final


def _write(directory: Path, step: int, arrays: dict,
           extra: Optional[dict]) -> None:
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    hashes, meta = {}, {}
    for k, arr in arrays.items():
        hashes[k] = hashlib.sha1(arr.tobytes()).hexdigest()
        dtype = "bfloat16" if arr.dtype == np.dtype("V2") else str(arr.dtype)
        meta[k] = {"shape": list(arr.shape), "dtype": dtype}
    np.savez(tmp / "arrays.npz", **arrays)
    manifest = {
        "step": step,
        "leaves": meta,
        "hashes": hashes,
        "extra": extra or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in directory.iterdir()
                   if p.is_dir() and p.name.startswith("step_")
                   and not p.name.endswith(".tmp"))
    return steps[-1] if steps else None


def _blocks(template: TrainState, shardings):
    """The ``block`` cut of ``load_stacked`` for ``shardings = (plan,
    mesh)``: each layer of a leaf cut to this rank's block by the spec of
    the parameter of the same name (moments and error feedback take
    their parameter's)."""
    plan, mesh = shardings
    sizes, coords = mesh_axis_sizes(mesh), mesh_coords(mesh)
    specs = {}
    for name, p in template.params.items():
        if not hasattr(p, "axes"):
            raise ValueError(f"template parameter {name} records no axes; "
                             "restore into a model built by build_model")
        specs[name] = plan.P(*p.axes)

    def block(name, part):
        return part[local_block(part.shape, specs[name], sizes, coords)]
    return block


def restore_checkpoint(directory: str | Path, template: TrainState,
                       step: Optional[int] = None, shardings=None,
                       verify: bool = True) -> Tuple[TrainState, dict]:
    """Restore into ``template``'s tensors, in place (their devices and
    dtypes kept), and return it with its step and the manifest.

    ``shardings``: ``(plan, mesh)`` where the template holds a sharded
    model's blocks; each rank keeps its block of every saved (whole)
    leaf. Raises ``IOError`` where a leaf's SHA1 differs from the
    manifest's, ``KeyError`` for a missing leaf, ``ValueError`` for a
    shape mismatch.
    """
    directory = Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = directory / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    wanted = train_state_keys(template.params, template.err is not None)
    with np.load(path / "arrays.npz") as data:
        arrays = {}
        for k in wanted:
            if k not in data:
                raise KeyError(f"checkpoint missing leaf {k}")
            arr = data[k]
            if verify and manifest["hashes"].get(k) != hashlib.sha1(
                    arr.tobytes()).hexdigest():
                raise IOError(f"checkpoint corruption detected at leaf {k}")
            arrays[k] = arr
    opt_step = load_train_state_arrays(
        arrays, template.params, template.opt.mu, template.opt.nu,
        template.err,
        block=None if shardings is None else _blocks(template, shardings))
    state = TrainState(params=template.params,
                       opt=template.opt._replace(step=opt_step),
                       err=template.err)
    return state, manifest


def prune_checkpoints(directory: str | Path, keep: int = 3):
    directory = Path(directory)
    steps = sorted(p for p in directory.iterdir()
                   if p.is_dir() and p.name.startswith("step_"))
    for p in steps[:-keep]:
        shutil.rmtree(p)


__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "prune_checkpoints"]
