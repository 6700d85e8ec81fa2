"""``harness/hybrid_prefill.py`` at a smoke size on the CPU: the program
as the cell runs it passes the check; the control (the program built in
bf16) and each fault a cell can have, planted under a run, fail it.

``test_pb_check.py`` covers the cells whose kinds and smoke sizes it
names (``prefill``, ``train``); this file gives the granite-4.0-h-small
cell the same three checks at the program's smoke widths
(``configs/granite_4_0_h_small.py`` ``smoke()``)."""

import json
import time

import pytest
import torch

from conftest import BENCH, load
from harness import hybrid_prefill, main
from harness.trace import Tracer

CELL = "granite-4.0-h-small.prefill-long"
SEED = 2**31 + 4321


def smoke_conf() -> dict:
    conf = load("configs", "granite-4.0-h-small")
    conf.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
                head_dim=16, intermediate_size=32,
                shared_intermediate_size=48, vocab_size=512,
                mamba_n_heads=8, mamba_d_head=16, mamba_d_state=16,
                mamba_chunk_size=16, num_local_experts=2,
                num_experts_per_tok=4, num_hidden_layers=4,
                layer_types=["mamba", "attention", "mamba", "mamba"],
                attention_multiplier=1 / 16)
    conf["run"] = {**conf["run"], "vocab_round": 64, "moe_token_chunk": 64}
    conf["deployment"] = {**conf["deployment"], "router_experts": 16,
                          "experts_first": 2}
    return conf


def smoke_mix() -> dict:
    """Prompts of 24-128 tokens, some routed in two chunks of 64."""
    mix = load("traffic", "prefill-long")
    mix["prompt_len"] = {**mix["prompt_len"], "median": 48, "min": 24,
                         "max": 128}
    mix["cache_round"] = 16
    mix["trace_seconds"] = 0.5
    return mix


def _run(dtype=torch.float32, fault=None):
    torch.manual_seed(0)
    out = hybrid_prefill.run(smoke_conf(), smoke_mix(), SEED, 0.3,
                             Tracer(False), "cpu", time.perf_counter(),
                             dtype=dtype, fault=fault)
    limits = main.load_json(BENCH / "limits" / f"{CELL}.json")
    return out, main.judge(out, limits)


def test_the_cell_runs_this_module():
    assert main.parts(main.manifest(), CELL).mix["kind"] == "hybrid_prefill"
    assert json.loads((BENCH / "limits" / f"{CELL}.json").read_text())


def test_program_passes():
    out, ok = _run()
    assert ok, out.checks
    assert out.attempted > 0 and out.failed == 0
    assert out.notes["compared"] >= 2


def test_control_fails():
    out, ok = _run(dtype=torch.bfloat16)
    assert not ok, out.checks


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "answer"])
def test_fault_fails(fault):
    out, ok = _run(fault=fault)
    assert not ok, out.checks
