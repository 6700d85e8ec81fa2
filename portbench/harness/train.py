"""The driver of ``kind: train`` mixes: the program's training step on
packed documents.

Set-up makes the weights from the seed, gives them to the program's model,
and builds one training state and one step (``make_train_step``, with the
training launcher's ``run_config`` and its deterministic mode). It drives
that step through its first ``first_steps`` steps on the mix's own feed,
reading what the check needs on the way, and hands the same state and
step to the window, which runs step after step until the window's time is
up; each step ends in its loss read back to the host.

After the window the program's state is freed. The reference
(``reference.decoder.loss`` and ``reference.adamw.step``) makes the same
weights again and follows the same first steps on the same rows. Three
numbers are compared:

* ``loss_gap``: the largest relative gap of a first step's loss;
* ``grad_gap``: of each leaf's first gradient as the optimizer took it
  (clipped; the program's read from its first moment after one step, ``mu
  / (1 - b1)``), the gap of the norms over the larger of the reference's
  norm of that leaf and of the median leaf: the worst leaf;
* ``update_gap``: the same of each leaf's change over the first steps,
  leaving out leaves whose reference gradient is under a thousandth of
  the median leaf's (round-off alone moves those under Adam).
"""

from __future__ import annotations

import dataclasses
import gc
import time
from typing import Dict, Iterable, Tuple

import torch

from reference import adamw, decoder
from . import traffic
from .model import as_dtype, make_weights, port_config, port_model, spec_of
from .outcome import Outcome

clock = time.perf_counter


def _to(batch: dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _norms(pairs: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, float]:
    """Each tensor's norm by name; ``pairs`` may make each tensor as it
    goes, so that no two of them need live together."""
    names, vals = [], []
    for n, t in pairs:
        names.append(n)
        vals.append(torch.linalg.vector_norm(t.float()))
    return dict(zip(names, torch.stack(vals).tolist()))


def run(conf: dict, mix: dict, seed: int, seconds: float, tracer, device,
        t_process: float, dtype: torch.dtype = torch.float32,
        fault=None) -> Outcome:
    """One run of the cell; ``dtype`` other than float32 builds the
    program in it (the control), ``fault`` plants one (tests only)."""
    from repro_torch.launch.train import deterministic, run_config
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import (StepConfig, init_train_state,
                                              make_train_step)

    phases = {"driver": clock() - t_process}
    spec = spec_of(conf)
    dev = torch.device(device)
    rc = run_config(port_config(conf), smoke=False, seq_len=mix["seq_len"])
    model = port_model(conf, as_dtype(make_weights(spec, seed, dev), dtype),
                       rc)
    oc = OptConfig(**mix["optimizer"])
    if fault == "unchanged":
        oc = dataclasses.replace(oc, lr=0.0)
    state = init_train_state(model, oc)
    step_fn = make_train_step(model, oc, StepConfig())
    feed = traffic.PackedRows(mix, spec.vocab, seed)
    tokens_a_step = mix["batch"] * mix["seq_len"]

    def one() -> float:
        nonlocal state
        with tracer.span("pb.feed"):
            rows = feed.batch()
            if fault == "half_batch":
                rows = {k: v[: len(v) // 2] for k, v in rows.items()}
            if fault == "answer":
                rows["tokens"][0, 0] = (rows["tokens"][0, 0] + 1) % spec.vocab
            batch = _to(rows, dev)
        with tracer.span("pb.step"):
            state, metrics = step_fn(state, batch)
        with tracer.span("pb.sync"):
            return float(metrics["loss"])

    phases["weights"] = clock() - t_process
    with deterministic(dev):
        losses, grads = [], None
        for i in range(mix["first_steps"]):
            losses.append(one())
            if i == 0:
                grads = {n: v / (1 - oc.b1)
                         for n, v in _norms(state.opt.mu.items()).items()}
        phases["first_steps"] = clock() - t_process
        start = make_weights(spec, seed, dev)
        moved = _norms((n, p.float() - start[n])
                       for n, p in state.params.items())
        del start
        if dev.type == "cuda":
            torch.cuda.synchronize()
        tracer.start()
        t0 = clock()
        setup_s = t0 - t_process
        t_trace, steps, traced, failures, t_last = \
            t0 + mix["trace_seconds"], 0, 0, [], t0
        while clock() < t0 + seconds:
            on = tracer.running
            try:
                one()
            except Exception as e:           # a failed step ends the window
                failures.append(f"{type(e).__name__}: {e}")
                break
            steps += 1
            traced += on
            t_last = clock()
            if tracer.running and t_last >= t_trace:
                tracer.stop()
        tracer.stop()
    window = t_last - t0
    e2e = {"train_tokens_per_s": steps * tokens_a_step / window
           if steps else 0.0, "setup_s": setup_s}
    peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0)
    del state, step_fn, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, left_out = check(spec, mix, seed, dev, losses, grads, moved)
    layer = {"kind": "train", "spec": spec, "reading": tracer.reading,
             "steps": traced, "batch": mix["batch"],
             "seq_len": mix["seq_len"]}
    return Outcome(e2e=e2e, attempted=steps + len(failures),
                   failed=len(failures), failures=failures, checks=checks,
                   memory_peak=peak, reading=tracer.reading, layer=layer,
                   notes={"first_losses": losses, "setup_phases_s": phases,
                          "update_gap_leaves_left_out": left_out})


def reference_steps(spec, mix: dict, seed: int, device):
    """The reference's first steps from the seed's weights and rows:
    (losses, first clipped gradients' norms, each leaf's change's norm)."""
    params = make_weights(spec, seed, device)
    for p in params.values():
        p.requires_grad_(True)
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    feed = traffic.PackedRows(mix, spec.vocab, seed)
    names = list(params)
    losses, grads = [], None
    for t in range(1, mix["first_steps"] + 1):
        b = _to(feed.batch(), device)
        loss = decoder.loss(params, spec, b["tokens"], b["labels"])
        g = torch.autograd.grad(loss, [params[n] for n in names])
        losses.append(float(loss.detach()))
        clipped = adamw.step(params, dict(zip(names, g)), mu, nu, t,
                             mix["optimizer"])
        del g
        if t == 1:
            grads = _norms(clipped.items())
        del clipped
    del mu, nu
    start = make_weights(spec, seed, device)
    with torch.no_grad():
        moved = _norms((n, p - start[n]) for n, p in params.items())
    return losses, grads, moved


def _leaf_gap(got: Dict[str, float], want: Dict[str, float],
              names) -> float:
    med = float(torch.tensor(list(want.values())).median())
    return max((abs(got[n] - want[n]) / max(want[n], med) for n in names),
               default=0.0)


def check(spec, mix, seed, device, losses, grads, moved):
    """(``loss_gap``, ``grad_gap`` and ``update_gap`` (module docstring);
    the leaves ``update_gap`` leaves out)."""
    ref_losses, ref_grads, ref_moved = reference_steps(spec, mix, seed,
                                                       device)
    med = float(torch.tensor(list(ref_grads.values())).median())
    moving = [n for n in ref_grads if ref_grads[n] >= 1e-3 * med]
    return {"loss_gap": max(abs(a - b) / abs(b)
                            for a, b in zip(losses, ref_losses)),
            "grad_gap": _leaf_gap(grads, ref_grads, ref_grads),
            "update_gap": _leaf_gap(moved, ref_moved, moving)}, \
        sorted(set(ref_grads) - set(moving))


__all__ = ["run", "check", "reference_steps"]
