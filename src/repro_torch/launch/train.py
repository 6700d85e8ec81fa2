"""Training launcher: the end-to-end loop with checkpoint/restart and the
dedup stage.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        [--smoke] [--device cpu] --steps 50 --ckpt-dir D [--resume] \\
        [--fail-at 30]

The port of ``repro/launch/train.py``, with its flags plus ``--device``
(CUDA by default; the call raises without a card unless the caller passes
``cpu``). It trains every family. The run configuration is the reference's
(:func:`run_config`): naive attention for the smoke configs, chunked
otherwise (kernel B4 has no backward, in the reference too),
``loss_chunk = min(256, seq_len)``, ``ssd_chunk=16`` for the hybrid
family, ``rwkv_impl`` "scan" at smoke size and "chunked" at full size for
the ssm family (each field passed only to the family that reads it), f32
weights and AdamW state, lr 1e-3 with 5 warmup steps. The encdec and vlm
batches carry the reference's zero stub embeddings (``audio_embeds``
(B, encoder_seq, d), ``image_embeds`` (B, num_image_tokens, d)).
Weights are drawn from a ``torch.Generator`` on the training device seeded
with ``seed`` (a full-width family's billions of weights drawn on the host
would take longer than its steps); a run
resumed from a checkpoint (``--resume``) replaces them with the
checkpoint's.
``--fail-at K`` raises :class:`SimulatedFailure` after step K's checkpoint
logic.

The dedup stage (``build_pipeline``) clusters the corpus' near-duplicate
graph with ``dedup_corpus``, one launch of kernel B3 on the card.

A resumed run continues the uninterrupted run's loss trajectory bit for
bit. On the card the step runs under
``torch.use_deterministic_algorithms(True)`` for that (the embedding's and
the loss gather's gradients otherwise accumulate with atomics in an order
that changes from run to run), which needs ``CUBLAS_WORKSPACE_CONFIG``
set before the first matrix product on the card: ``main`` (and any other
program that trains on the card) calls :func:`set_cublas_workspace`
before CUDA starts, and :func:`deterministic` raises on the card when the
variable is unset.
"""

from __future__ import annotations

import argparse
import contextlib
import os
from typing import Optional

import numpy as np
import torch

from ..configs import get_config, get_smoke
from ..data.dedup import dedup_corpus
from ..data.pipeline import PipelineConfig, TokenPipeline
from ..data.synthetic import synthetic_corpus, token_stream
from ..models import build_model
from ..models.transformer import RunConfig
from ..train.checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..train.fault import SimulatedFailure, StepWatchdog
from ..train.optimizer import OptConfig
from ..train.train_step import StepConfig, init_train_state, make_train_step
from ..util import DeviceLike, resolve_device

CUBLAS_DETERMINISTIC = ":4096:8"


def set_cublas_workspace() -> None:
    """Sets ``CUBLAS_WORKSPACE_CONFIG`` to :data:`CUBLAS_DETERMINISTIC`
    unless the caller set it; cuBLAS reads it only before CUDA starts, so
    call this first."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_DETERMINISTIC)


def run_config(cfg, smoke: bool, seq_len: int) -> RunConfig:
    """The reference launcher's ``RunConfig``, each field passed only to the
    family that reads it (``RunConfig.check``)."""
    family = {"ssm": {"rwkv_impl": "scan" if smoke else "chunked"},
              "hybrid": {"ssd_chunk": 16}}.get(cfg.family, {})
    return RunConfig(attn_impl="naive" if smoke else "chunked",
                     loss_chunk=min(256, seq_len), **family)


def stub_batch(cfg, global_batch: int, device) -> dict:
    """The reference launcher's zero stub embeddings for the encdec and
    vlm families, by batch key (empty for the others)."""
    shape = {"encdec": ("audio_embeds", cfg.encoder_seq),
             "vlm": ("image_embeds", cfg.num_image_tokens)}.get(cfg.family)
    if shape is None:
        return {}
    key, n = shape
    return {key: torch.zeros((global_batch, n, cfg.d_model),
                             dtype=torch.float32, device=device)}


def dedup_stage(cfg, seed: int = 0, device: DeviceLike = None):
    """The pipeline's corpus (300 synthetic documents) and its dedup
    (threshold 0.5, best of 4 PIVOT draws) on ``device``."""
    corpus = synthetic_corpus(n_docs=300, vocab=cfg.vocab_size,
                              dup_fraction=0.4, seed=seed)
    return corpus, dedup_corpus(corpus, threshold=0.5, device=device)


def build_pipeline(cfg, seq_len: int, global_batch: int, dedup: bool = True,
                   seed: int = 0, device: DeviceLike = None) -> TokenPipeline:
    """The reference's token pipeline: :func:`dedup_stage`'s corpus, its
    kept documents only when ``dedup``, the stream tiled to cover four
    batches."""
    if dedup:
        corpus, res = dedup_stage(cfg, seed, device)
        keep = res.keep
    else:
        corpus = synthetic_corpus(n_docs=300, vocab=cfg.vocab_size,
                                  dup_fraction=0.4, seed=seed)
        keep = None
    stream = token_stream(corpus, keep=keep)
    # repeat stream to cover the requested steps
    reps = max(1, (global_batch * (seq_len + 1) * 4) // max(1, len(stream)))
    stream = np.tile(stream, reps + 1)
    return TokenPipeline(stream, PipelineConfig(seq_len=seq_len,
                                                global_batch=global_batch,
                                                seed=seed))


@contextlib.contextmanager
def deterministic(dev: torch.device):
    """``torch.use_deterministic_algorithms(True)`` on the card for the
    block, the previous mode restored after; nothing on the CPU, whose
    kernels here are deterministic already. Raises on the card when
    ``CUBLAS_WORKSPACE_CONFIG`` is unset (see :func:`set_cublas_workspace`):
    setting it here would come after cuBLAS read it."""
    if dev.type != "cuda":
        yield
        return
    if not os.environ.get("CUBLAS_WORKSPACE_CONFIG"):
        raise RuntimeError(
            "deterministic training on the card needs CUBLAS_WORKSPACE_CONFIG"
            f" (e.g. {CUBLAS_DETERMINISTIC}) set before CUDA starts; call "
            "repro_torch.launch.train.set_cublas_workspace() first")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)


def run(arch: str, smoke: bool, steps: int, ckpt_dir: Optional[str],
        resume: bool, fail_at: Optional[int], seq_len: int,
        global_batch: int, ckpt_every: int = 10, dedup: bool = True,
        seed: int = 0, log_every: int = 5, device: DeviceLike = None
        ) -> dict:
    """Train ``steps`` steps; returns ``{"losses", "final_step", "step_s"}``
    (the losses of the steps this call ran, and their walls in seconds,
    each ending in the loss's read back to the host)."""
    dev = resolve_device(device)
    cfg = get_smoke(arch) if smoke else get_config(arch)
    rc = run_config(cfg, smoke, seq_len)
    model = build_model(cfg, device=dev, dtype=torch.float32,
                        generator=torch.Generator(dev).manual_seed(seed),
                        rc=rc)
    oc = OptConfig(lr=1e-3, warmup_steps=5, total_steps=max(steps, 10))
    sc = StepConfig(accum_steps=1)

    pipe = build_pipeline(cfg, seq_len, global_batch, dedup=dedup, seed=seed,
                          device=dev)
    state = init_train_state(model, oc, sc)
    start_step = 0
    if resume and ckpt_dir and latest_step(ckpt_dir) is not None:
        state, manifest = restore_checkpoint(ckpt_dir, state)
        start_step = manifest["step"]
        print(f"resumed from step {start_step}")

    step_fn = make_train_step(model, oc, sc)
    watchdog = StepWatchdog()
    losses = []
    stubs = stub_batch(cfg, global_batch, dev)
    with deterministic(dev):
        for step in range(start_step, steps):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipe.batch_at(step).items()}
            batch.update(stubs)
            watchdog.start()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            straggler = watchdog.stop()
            losses.append(loss)
            if step % log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e}"
                      + (" [straggler]" if straggler else ""), flush=True)
            if ckpt_dir and (step + 1) % ckpt_every == 0:
                save_checkpoint(ckpt_dir, step + 1, state,
                                extra={"arch": arch, "loss": loss})
            if fail_at is not None and step + 1 == fail_at:
                raise SimulatedFailure(
                    f"simulated host failure at step {step + 1}")
    return {"losses": losses, "final_step": steps,
            "step_s": watchdog.times}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--no-dedup", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    set_cublas_workspace()
    run(args.arch, smoke=args.smoke, steps=args.steps,
        ckpt_dir=args.ckpt_dir, resume=args.resume, fail_at=args.fail_at,
        seq_len=args.seq_len, global_batch=args.global_batch,
        ckpt_every=args.ckpt_every, dedup=not args.no_dedup,
        device=args.device)


if __name__ == "__main__":
    main()
