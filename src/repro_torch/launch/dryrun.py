"""Dry run of the LM grid: every (arch × shape) cell sized and counted for
one rank of the production mesh, on the meta device.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape train_4k [--multi-pod] [--out artifacts/dryrun_torch/...json]

The port of ``repro/launch/dryrun.py``: :func:`run_cell` takes the
reference's arguments, resolves the reference's plan on the production
mesh (``(data 16, model 16)``, or ``(pod 2, data 16, model 16)`` with
``multi_pod``), applies the reference's :data:`POLICY` and its
accumulation clamp, and returns a dict with the reference's keys. Exit
code 0 means the cell ran (``ok``) or is outside the grid (``skipped``);
an exception is recorded as ``status: "error"`` with its traceback and
exits 1, as the reference's does.

The reference lowers and compiles each cell for 256 or 512 placeholder
devices and reads XLA's analyses. Eager PyTorch compiles nothing, so the
port runs the cell's step itself, for one rank: the model is built on the
meta device (shapes only, nothing allocated) with that rank's blocks on a
stand-in mesh (``launch/mesh.standin_mesh``: the mesh's axes and the
rank's coordinates, no process group), and the train step, the prefill or
the decode step runs on meta tensors at the cell's global shape, of which
the rank takes its share as on a live mesh. Each collective returns the
shape a live rank would get and is counted as a live rank counts it
(``models/parallel.py``); kernel B4 runs its meta form and counts the
launches the card would make (``flash_attention.meta_launches``); the MoE
dispatch runs on meta as it is (``models/mlp.py``). Where the reference
reports XLA's figures, the port reports its own under the same keys:

- ``memory``: ``argument_bytes`` are the rank's blocks of what the step
  takes (params, AdamW moments and error tensors to train, caches to
  decode, and its block of the inputs); ``output_bytes`` what the step
  returns on the rank (the state and three f32 metrics; the logits and
  the caches); ``alias_bytes`` the outputs that are the inputs' own
  tensors, written in place (the state to train, the caches to decode);
  ``temp_bytes`` is None (eager PyTorch has no compile-time figure of its
  temporaries); ``per_device_total`` is argument + output − alias, the sum
  of what is known.
- ``collectives``: calls and bytes of one step of the rank by the port's
  three kinds (``all_reduce``, ``all_gather``, ``reduce_scatter``); a
  one-rank group is a counted pass-through, as on a live mesh. The
  roofline's collective bytes are the rank's bytes times the ranks.
- ``meta_step_s``: the wall time of the meta step, where the reference
  has ``lower_s`` and ``compile_s``.
- ``b4_launches``: kernel B4's launches a rank in the step.

The flops and HBM bytes are the reference's analytic counts
(``launch/roofline.py``), with one more forward where remat recomputes it,
as the reference adds. (The counted collectives of a remat step include
the forward's issued again in the backward, since
``torch.utils.checkpoint`` reruns them.) ``roofline`` is a model at the
H100's datasheet rates, not a measurement.

:func:`count_train_step` runs one train step of any config on any mesh
the same way, for checks that hold the count to a live run's.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, Mapping, Optional

import torch

from ..configs import SHAPES, get_config, supports_shape
from ..configs.base import ModelConfig
from ..kernels import flash_attention as fa
from ..models import build_model, common, parallel
from ..models.model import Model, tree_bytes
from ..models.sharding import ShardingPlan, axes_span, entry_axes, resolve_plan
from ..models.transformer import RunConfig
from ..train.optimizer import OptConfig
from ..train.train_step import (StepConfig, abstract_train_state,
                                init_train_state, make_train_step,
                                state_bytes)
from . import roofline as rl
from .mesh import production_axes, standin_mesh

# Per-arch scale policy: grad-accum steps for train_4k, optimizer-state
# dtype and the gradient accumulator's: the reference's values as they are.
POLICY = {
    "whisper-base":         dict(accum=1,  state_dtype="float32"),
    "qwen3-8b":             dict(accum=8,  state_dtype="float32"),
    "granite-3-2b":         dict(accum=4,  state_dtype="float32"),
    "stablelm-12b":         dict(accum=8,  state_dtype="float32"),
    "smollm-135m":          dict(accum=1,  state_dtype="float32"),
    "olmoe-1b-7b":          dict(accum=2,  state_dtype="float32"),
    "grok-1-314b":          dict(accum=16, state_dtype="bfloat16",
                                 accum_dtype="bfloat16"),
    "zamba2-2.7b":          dict(accum=8,  state_dtype="float32"),
    "rwkv6-1.6b":           dict(accum=4,  state_dtype="float32"),
    "llama-3.2-vision-90b": dict(accum=16, state_dtype="bfloat16",
                                  accum_dtype="bfloat16"),
}

def clamp_accum(accum: int, global_batch: int, plan: ShardingPlan,
                axes: Mapping[str, int]) -> int:
    """The reference's clamp: halve ``accum`` until each microbatch
    divides over the batch's mesh axes."""
    span = axes_span(entry_axes(plan.axes.get("batch")), axes)
    while accum > 1 and (global_batch // accum) % span != 0:
        accum //= 2
    return accum


def _run_config(cfg: ModelConfig, attn_impl: str, moe_impl: str,
                moe_token_chunk: int, remat: bool, mesh) -> RunConfig:
    """The cell's ``RunConfig``: the MoE fields for the moe family only
    (``RunConfig.check``), the mesh for ``ep_local``."""
    moe = {}
    if cfg.family == "moe":
        moe = dict(moe_impl=moe_impl, moe_token_chunk=moe_token_chunk)
    return RunConfig(attn_impl=attn_impl, remat=remat,
                     mesh=mesh if moe_impl == "ep_local" else None, **moe)


def _stub_batch(cfg: ModelConfig, b: int, s: int,
                dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """A whole training batch of (b, s) meta inputs, stub embeddings in
    ``dtype`` where the family reads them."""
    tok = torch.empty((b, s), dtype=torch.int32, device="meta")
    batch = {"tokens": tok, "labels": torch.empty_like(tok)}
    if cfg.family == "encdec":
        batch["audio_embeds"] = torch.empty(
            (b, cfg.encoder_seq, cfg.d_model), dtype=dtype, device="meta")
    if cfg.family == "vlm":
        batch["image_embeds"] = torch.empty(
            (b, cfg.num_image_tokens, cfg.d_model), dtype=dtype,
            device="meta")
    return batch


def _reset() -> None:
    parallel.reset_counts()
    fa.meta_launches["flash_attention"] = 0


def _counted() -> dict:
    snap = parallel.snapshot()
    return {"bytes": {k: snap[k]["bytes"] for k in parallel.KINDS},
            "counts": {k: snap[k]["calls"] for k in parallel.KINDS}}


def _tensors(tree) -> list:
    """Every tensor of a nest of dicts, tuples and lists."""
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, Mapping):
        tree = tree.values()
    elif not isinstance(tree, (tuple, list)):
        return []
    return [t for x in tree for t in _tensors(x)]


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _memory(args, outs) -> dict:
    """The rank's argument, output and alias bytes (module docstring):
    an output is aliased where it is one of the arguments' tensors."""
    a, o = _tensors(args), _tensors(outs)
    seen = {id(t) for t in a}
    alias = _nbytes(t for t in o if id(t) in seen)
    arg, out = _nbytes(a), _nbytes(o)
    return dict(argument_bytes=arg, output_bytes=out, temp_bytes=None,
                alias_bytes=alias, per_device_total=arg + out - alias)


def _check_blocks(got: Mapping[str, torch.Tensor],
                  want: Mapping[str, torch.Tensor], what: str) -> None:
    """The tensors a meta build holds are the abstract tree's blocks."""
    bad = [n for n in want if n not in got
           or tuple(got[n].shape) != tuple(want[n].shape)
           or got[n].dtype != want[n].dtype]
    if bad or set(got) != set(want):
        raise AssertionError(f"{what}: the rank's tensors are not the "
                             f"abstract tree's blocks ({bad[:3]})")


def meta_train_step(model: Model, oc: OptConfig, sc: StepConfig,
                    batch: Dict[str, torch.Tensor],
                    input_blocks: Optional[Mapping[str, torch.Tensor]] = None
                    ) -> dict:
    """One train step of ``model`` (built on the meta device) on the
    whole meta ``batch``, counted from zero: ``collectives``,
    ``b4_launches``, ``state_bytes`` (params, moments and error tensors
    of the rank), ``memory`` (with ``input_blocks``, the rank's block of
    the batch, as its argument) and ``meta_step_s``."""
    mesh = model.layout.mesh if model.layout is not None else None
    abstract = abstract_train_state(model, oc, sc, mesh=mesh)
    want = abstract.local if mesh is not None else abstract.whole
    state = init_train_state(model, oc, sc)
    for part, got, exp in (("params", state.params, want.params),
                           ("mu", state.opt.mu, want.opt.mu),
                           ("nu", state.opt.nu, want.opt.nu),
                           ("err", state.err or {}, want.err or {})):
        _check_blocks(got, exp, f"train state {part}")
    step = make_train_step(model, oc, sc)
    args = (state, input_blocks if input_blocks is not None else batch)
    _reset()
    t0 = time.perf_counter()
    new, metrics = step(state, batch)
    took = time.perf_counter() - t0
    out = {"collectives": _counted(),
           "b4_launches": fa.meta_launches["flash_attention"],
           "state_bytes": state_bytes(state), "meta_step_s": took}
    out["memory"] = _memory(args, (new, metrics))
    return out


def count_train_step(cfg: ModelConfig, axes: Mapping[str, int],
                     batch: int, seq: int, *,
                     coords: Optional[Mapping[str, int]] = None,
                     rc: Optional[RunConfig] = None,
                     oc: Optional[OptConfig] = None,
                     sc: Optional[StepConfig] = None) -> dict:
    """One train step of ``cfg`` (f32 weights, as ``build_model`` draws
    them) on a ``batch`` × ``seq`` batch, for the rank at ``coords`` (the
    first when None) of the mesh ``axes``, under ``resolve_plan(cfg, None,
    axes)``, as a live mesh's ``build_model(plan=, mesh=)`` takes it:
    :func:`meta_train_step`'s record. Nothing is allocated and nothing
    communicated; the counts are those a live rank of that mesh makes."""
    mesh = standin_mesh(axes, coords)
    plan = resolve_plan(cfg, None, dict(axes))
    rc = rc or RunConfig()
    if rc.mesh is not None:
        raise ValueError("count_train_step makes its own stand-in mesh; "
                         "pass a RunConfig without one")
    if rc.moe_impl == "ep_local":
        rc = dataclasses.replace(rc, mesh=mesh)
    model = build_model(cfg, device="meta", rc=rc, plan=plan, mesh=mesh)
    return meta_train_step(model, oc or OptConfig(), sc or StepConfig(),
                           _stub_batch(cfg, batch, seq, torch.float32))


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             attn_impl: str = "chunked", moe_impl: str = "sort",
             accum: Optional[int] = None, remat: bool = True,
             compress: bool = False, expert_mode: str = "auto",
             moe_token_chunk: int = 8192, reduce_dtype: str = "f32",
             coords: Optional[Mapping[str, int]] = None) -> dict:
    """One cell of the grid for the rank at ``coords`` (the first when
    None) of the production mesh (module docstring). The arguments are
    the reference's, less ``save_hlo`` (no HLO); ``reduce_dtype`` is set
    for the call (``common.set_matmul_reduce_dtype``) and restored after
    it."""
    prev = ("bf16" if common.reduce_dtype(torch.bfloat16) == torch.bfloat16
            else "f32")
    common.set_matmul_reduce_dtype(reduce_dtype)
    try:
        return _run_cell(arch, shape_name, multi_pod, attn_impl, moe_impl,
                         accum, remat, compress, expert_mode,
                         moe_token_chunk, reduce_dtype, coords)
    finally:
        common.set_matmul_reduce_dtype(prev)


def _run_cell(arch, shape_name, multi_pod, attn_impl, moe_impl, accum,
              remat, compress, expert_mode, moe_token_chunk,
              reduce_dtype, coords) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = supports_shape(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": why}

    axes = production_axes(multi_pod)
    mesh = standin_mesh(axes, coords)
    chips = mesh.mesh.numel()
    plan = resolve_plan(cfg, shape, axes, expert_mode=expert_mode)
    pol = POLICY[arch]
    accum = accum if accum is not None else (
        pol["accum"] if shape.kind == "train" else 1)
    accum = clamp_accum(accum, shape.global_batch, plan, axes)

    rc = _run_config(cfg, attn_impl, moe_impl, moe_token_chunk,
                     remat and shape.kind == "train", mesh)
    model = build_model(cfg, device="meta", dtype=torch.bfloat16, rc=rc,
                        plan=plan, mesh=mesh)
    params = model.abstract_params(mesh=mesh)
    _check_blocks(dict(model.named_parameters()), params.local, "params")
    inputs = model.input_specs(shape, mesh=mesh)

    result = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "chips": chips, "kind": shape.kind,
        "plan": {k: str(v) for k, v in plan.axes.items()},
        "accum": accum, "attn_impl": attn_impl, "moe_impl": moe_impl,
        "expert_mode": expert_mode, "moe_token_chunk": moe_token_chunk,
        "reduce_dtype": reduce_dtype,
        "param_count": int(cfg.param_count()),
        "param_bytes": tree_bytes(params.whole),
    }

    opt_bytes = 0
    cache_bytes = 0
    if shape.kind == "train":
        oc = OptConfig(state_dtype=pol["state_dtype"])
        sc = StepConfig(accum_steps=accum, compress_cross_pod=compress,
                        accum_dtype=pol.get("accum_dtype", "float32"))
        opt_bytes = tree_bytes(
            abstract_train_state(model, oc, sc).whole.opt.mu) * 2
        rec = meta_train_step(model, oc, sc, inputs.whole,
                              input_blocks=inputs.local)
        memory, took = rec["memory"], rec["meta_step_s"]
    else:
        caches = model.abstract_caches(shape.global_batch, shape.seq_len,
                                       mesh=mesh)
        cache_bytes = tree_bytes(caches.whole)
        params_local = dict(model.named_parameters())
        _reset()
        t0 = time.perf_counter()
        with torch.no_grad():
            if shape.kind == "prefill":
                stubs = {k: v for k, v in inputs.whole.items()
                         if k != "tokens"}
                outs = model.prefill(inputs.whole["tokens"],
                                     cache_len=shape.seq_len, **stubs)
                args = (params_local, inputs.local)
            else:
                local = dict(caches.local)
                outs = model.decode_step(inputs.whole["token"], local,
                                         shape.seq_len - 1)
                args = (params_local, inputs.local, local)
        took = time.perf_counter() - t0
        memory = _memory(args, outs)
        rec = {"collectives": _counted(),
               "b4_launches": fa.meta_launches["flash_attention"]}

    result["opt_bytes"] = opt_bytes
    result["cache_bytes"] = cache_bytes

    flops = rl.step_flops(cfg, shape, moe_impl=moe_impl)
    if shape.kind == "train" and rc.remat:
        # remat recomputes the forward in the backward: ~4/3 of fwd+bwd.
        flops = flops + rl.forward_flops(cfg, shape.global_batch,
                                         shape.seq_len, moe_impl=moe_impl)
    bytes_hbm = rl.hbm_bytes(cfg, shape, result["param_bytes"], cache_bytes,
                             opt_bytes)
    coll = rec["collectives"]
    roof = rl.Roofline(
        chips=chips,
        flops=flops,
        bytes_hbm=bytes_hbm,
        coll_bytes=float(sum(coll["bytes"].values()) * chips),
        hlo_flops_raw=None,
        hlo_bytes_raw=None,
        model_flops_=rl.model_flops(cfg, shape),
    )

    result.update(
        status="ok",
        meta_step_s=round(took, 1),
        memory=memory,
        collectives=coll,
        b4_launches=rec["b4_launches"],
        roofline=roof.as_dict(),
    )
    return result


def _gib(n) -> str:
    return "not known" if n is None else f"{n / 2**30:.2f}GiB"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--attn-impl", default="chunked")
    ap.add_argument("--moe-impl", default="sort")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--expert-mode", default="auto",
                    choices=["auto", "ep", "tp"])
    ap.add_argument("--reduce-dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--moe-token-chunk", type=int, default=8192)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    try:
        res = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                       attn_impl=args.attn_impl, moe_impl=args.moe_impl,
                       accum=args.accum, remat=not args.no_remat,
                       compress=args.compress,
                       expert_mode=args.expert_mode,
                       moe_token_chunk=args.moe_token_chunk,
                       reduce_dtype=args.reduce_dtype)
    except Exception as e:  # record the failure mode — it is a bug signal
        res = {"arch": args.arch, "shape": args.shape,
               "multi_pod": args.multi_pod, "status": "error",
               "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()[-4000:]}

    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(res, indent=2))
    dump = {k: v for k, v in res.items() if k != "traceback"}
    print(json.dumps(dump, indent=2))
    if res["status"] == "ok":
        m = res["memory"]
        print(f"\n== {args.arch} × {args.shape} "
              f"{'(2 pods, 512 cards)' if args.multi_pod else '(1 pod, 256 cards)'} ==")
        print(f"per-device bytes: args={_gib(m['argument_bytes'])} "
              f"temp={_gib(m['temp_bytes'])} "
              f"total={_gib(m['per_device_total'])}")
        r = res["roofline"]
        print(f"roofline (a model at H100 datasheet rates): "
              f"compute={r['t_compute_s']:.4f}s "
              f"memory={r['t_memory_s']:.4f}s "
              f"collective={r['t_collective_s']:.4f}s "
              f"→ {r['bottleneck']}-bound; useful={r['useful_ratio']:.2f} "
              f"frac={r['roofline_fraction']:.2f}")
    return 0 if res["status"] in ("ok", "skipped") else 1


__all__ = ["POLICY", "run_cell", "count_train_step", "meta_train_step",
           "clamp_accum", "main"]


if __name__ == "__main__":
    sys.exit(main())
