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

The arrays are saved gathered on the host. The reference's re-layout onto
another mesh on restore (``shardings=``) waits for the sharded port
(ROADMAP A18).
"""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..models.weights import (load_train_state_arrays, train_state_arrays,
                              train_state_keys)
from .train_step import TrainState


def _arrays(state: TrainState):
    return train_state_arrays(state.params, state.opt.mu, state.opt.nu,
                              state.opt.step, state.err)


def save_checkpoint(directory: str | Path, step: int, state: TrainState,
                    extra: Optional[dict] = None) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    arrays = _arrays(state)
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
    return final


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = sorted(int(p.name.split("_")[1]) for p in directory.iterdir()
                   if p.is_dir() and p.name.startswith("step_")
                   and not p.name.endswith(".tmp"))
    return steps[-1] if steps else None


def restore_checkpoint(directory: str | Path, template: TrainState,
                       step: Optional[int] = None, verify: bool = True
                       ) -> Tuple[TrainState, dict]:
    """Restore into ``template``'s tensors, in place (their devices and
    dtypes kept), and return it with its step and the manifest.

    Raises ``IOError`` where a leaf's SHA1 differs from the manifest's,
    ``KeyError`` for a missing leaf, ``ValueError`` for a shape mismatch.
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
    opt_step = load_train_state_arrays(arrays, template.params,
                                       template.opt.mu, template.opt.nu,
                                       template.err)
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
