"""The training slice on the card (skipped without one).

Kept free of ``jax`` and ``repro``, like ``tests/test_torch_cuda.py``, so it
runs on a GPU machine that has only PyTorch: ``python -m pytest -q -m cuda
tests/test_torch_cuda.py tests/test_torch_cuda_train.py``. B4 refuses
CUDA inputs that require grad and launches for them under ``no_grad``
(within 2e-5 of its plain version); the smoke model's train step on the
card (chunked attention; accumulation and compression) is within the CPU
tests' tolerances of the CPU's from the same state (loss 1e-5, grad_norm
1e-4, or 1e-3 with compression, where a value near a half quantum may
round either way); the launcher's fail-and-resume run on the card equals
its uninterrupted run bit for bit, its dedup stage launching B3 and its
naive attention never B4.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.launch.train import set_cublas_workspace
from repro_torch.models import build_model

# Deterministic training on the card needs the cuBLAS workspace set before
# the first product; collection imports this module before any test runs.
set_cublas_workspace()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_flash_attention_refuses_inputs_that_require_grad(cuda):
    q = torch.randn(1, 9, 40, 64, device=cuda)
    k = torch.randn(1, 3, 40, 64, device=cuda)
    v = torch.randn(1, 3, 40, 64, device=cuda)
    for leaf in (q, k, v):
        leaf.requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            fa.flash_attention(q, k, v)
        leaf.requires_grad_(False)
    q.requires_grad_(True)
    fa.reset_launch_counts()
    with torch.no_grad():
        got = fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.launches["flash_attention"] == 1
    want = ref.attention_ref(q.detach().cpu(), k.cpu(), v.cpu(), causal=True)
    assert (got.cpu() - want).abs().max().item() < 2e-5


@pytest.mark.cuda
@pytest.mark.parametrize("accum,compress", [(1, False), (2, True)])
def test_cuda_train_step_equals_cpu(cuda, accum, compress):
    """Two smoke steps on the card from the CPU's state (chunked
    attention): loss within 1e-5, grad_norm within 1e-4 (1e-3 with
    compression), lr equal."""
    from repro_torch.launch.train import deterministic
    from repro_torch.models.transformer import RunConfig
    from repro_torch.train import optimizer, train_step

    cfg = get_smoke("smollm-135m")
    oc = optimizer.OptConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    sc = train_step.StepConfig(accum_steps=accum, compress_cross_pod=compress)
    sides = []
    for dev in ("cpu", cuda):
        model = build_model(cfg, device=dev, rc=RunConfig(loss_chunk=16),
                            generator=torch.Generator().manual_seed(0))
        state = train_step.init_train_state(model, oc, sc)
        sides.append([state, train_step.make_train_step(model, oc, sc)])
    rng = np.random.default_rng(0)
    for i in range(2):
        cpu, card = sides
        with torch.no_grad():
            for a, b in ((cpu[0].params, card[0].params),
                         (cpu[0].opt.mu, card[0].opt.mu),
                         (cpu[0].opt.nu, card[0].opt.nu),
                         (cpu[0].err or {}, card[0].err or {})):
                for n in a:
                    b[n].copy_(a[n])
        card[0] = card[0]._replace(opt=card[0].opt._replace(
            step=cpu[0].opt.step))
        batch = {k: torch.from_numpy(rng.integers(0, 512, (4, 40)).astype(
            np.int32)) for k in ("tokens", "labels")}
        cpu[0], want = cpu[1](cpu[0], batch)
        with deterministic(cuda):
            card[0], got = card[1](card[0], {k: v.to(cuda)
                                             for k, v in batch.items()})
        assert abs(float(got["loss"]) - float(want["loss"])) <= \
            1e-5 * float(want["loss"])
        gtol = 1e-3 if compress else 1e-4
        assert abs(float(got["grad_norm"]) - float(want["grad_norm"])) <= \
            gtol * float(want["grad_norm"])
        assert float(got["lr"]) == float(want["lr"])


@pytest.mark.cuda
def test_cuda_train_launcher_restart_is_bitwise(cuda, tmp_path):
    from repro_torch.kernels import mis_pivot
    from repro_torch.launch import train
    from repro_torch.train.fault import SimulatedFailure

    common = dict(arch="smollm-135m", smoke=True, seq_len=64,
                  global_batch=4, ckpt_every=4, dedup=True, seed=0,
                  log_every=100, device=cuda, steps=12)
    mis_pivot.reset_launch_counts()
    fa.reset_launch_counts()
    whole = train.run(ckpt_dir=None, resume=False, fail_at=None, **common)
    assert mis_pivot.launches["mis_pivot"] >= 1      # the dedup stage
    assert fa.launches["flash_attention"] == 0       # naive attention
    with pytest.raises(SimulatedFailure):
        train.run(ckpt_dir=str(tmp_path), resume=False, fail_at=8, **common)
    out = train.run(ckpt_dir=str(tmp_path), resume=True, fail_at=None,
                    **common)
    assert out["losses"] == whole["losses"][8:]


@pytest.mark.cuda
def test_cuda_train_dedup_stage_equals_cpu(cuda, monkeypatch):
    """The launcher's dedup stage at full width on the card: B3 on every
    route equal to its plain version at the inputs the stage gives it
    (k = 4, n = 300), and the kept documents, labels and batches equal to
    the CPU's."""
    import importlib

    from repro_torch.configs import get_config
    from repro_torch.kernels import mis_pivot
    from repro_torch.launch import train

    pivot = importlib.import_module("repro_torch.core.pivot")
    kept = []

    def keep(*args, **kw):
        kept.append([t.clone() for t in args])
        return mis_pivot.mis_pivot_csr(*args, **kw)

    monkeypatch.setattr(pivot, "mis_pivot_csr", keep)
    cfg = get_config("smollm-135m")
    mis_pivot.reset_launch_counts()
    _, on_card = train.dedup_stage(cfg, 0, cuda)
    assert mis_pivot.launches["mis_pivot"] >= 1
    _, on_cpu = train.dedup_stage(cfg, 0, "cpu")
    np.testing.assert_array_equal(on_card.keep, on_cpu.keep)
    np.testing.assert_array_equal(on_card.labels, on_cpu.labels)
    assert len(kept) == 2 and kept[0][2].shape == (4, 300)
    row_offsets, dst, ranks, eligible = kept[0]
    want = ref.mis_pivot_ref(row_offsets, dst, ranks, eligible)
    k, n = ranks.shape
    for plan in (mis_pivot.block_plan(k, n), mis_pivot.grid_plan(k, n)):
        if plan is None:
            continue
        got = mis_pivot.mis_pivot_csr(row_offsets, dst, ranks, eligible,
                                      plan=plan)
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b.cpu()), plan.route
    pipes = [train.build_pipeline(cfg, 1024, 8, dedup=True, seed=0,
                                  device=d) for d in (cuda, "cpu")]
    for step in range(4):
        a, b = (p.batch_at(step) for p in pipes)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key])
