"""The check that decides ``correct``, at the smoke size on the CPU: the
program as the cells run it passes; the control (the program built in
bf16) and each fault a cell can have, planted under a run, fail.

Faults: a step that returns its state unchanged (a prefill's caches left
at zeros; a training step at learning rate 0), half of the batch left out
(half the prompt; half the rows), and an answer altered where it is made
(the served token; one token of the training feed). The cells run on one
chip, so no exchange between chips can be left out."""

import json
import time

import pytest
import torch

from conftest import BENCH, smoke_conf, smoke_mix
from harness import main, prefill, train
from harness.trace import Tracer

CELLS = {c["name"]: c for c in json.loads(
    (BENCH.parent / "BENCHMARK.json").read_text())["workloads"]}
DRIVERS = {"prefill": prefill, "train": train}
SEED = 2**31 + 4321


def _run(cell, dtype=torch.float32, fault=None):
    c = CELLS[cell]
    torch.manual_seed(0)
    mix = smoke_mix(c["traffic"])
    out = DRIVERS[mix["kind"]].run(
        smoke_conf(c["config"]), mix, SEED, 0.3,
        Tracer(False), "cpu", time.perf_counter(), dtype=dtype, fault=fault)
    limits = main.load_json(BENCH / "limits" / f"{cell}.json")
    return out, main.judge(out, limits)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_program_passes(cell):
    out, ok = _run(cell)
    assert ok, out.checks
    assert out.attempted > 0 and out.failed == 0


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails(cell):
    out, ok = _run(cell, dtype=torch.bfloat16)
    assert not ok, out.checks


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "answer"])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fault_fails(cell, fault):
    out, ok = _run(cell, fault=fault)
    assert not ok, out.checks
