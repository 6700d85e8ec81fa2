"""Puts the benchmark's folder and the program's sources on the path, and
gives the tests each cell's configuration cut to the program's smoke size
(its ``get_smoke`` widths) with a short window."""

import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

# The smoke sizes of the program's registry (configs/<arch>.py smoke()).
SMOKE = {
    "granite-3-2b": {"num_hidden_layers": 2, "hidden_size": 64,
                     "num_attention_heads": 4, "num_key_value_heads": 2,
                     "intermediate_size": 128, "vocab_size": 512,
                     "head_dim": 16, "run": {"vocab_round": 64}},
    "olmoe-1b-7b": {"num_hidden_layers": 2, "hidden_size": 64,
                    "num_attention_heads": 4, "num_key_value_heads": 4,
                    "intermediate_size": 64, "vocab_size": 512,
                    "head_dim": 16, "num_experts": 8,
                    "num_experts_per_tok": 2, "run": {"vocab_round": 64}},
}


def load(kind: str, name: str) -> dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def smoke_conf(name: str) -> dict:
    conf = load("configs", name)
    cut = dict(SMOKE[name])
    conf["run"] = {**conf["run"], **cut.pop("run")}
    conf.update(cut)
    return conf


def smoke_mix(name: str) -> dict:
    """A mix at the smoke size: short prompts and rows."""
    mix = load("traffic", name)
    if mix["kind"] == "prefill":
        mix["prompt_len"] = {**mix["prompt_len"], "median": 24, "min": 8,
                             "max": 64}
        mix["cache_round"] = 16
        mix["trace_seconds"] = 0.5
        mix["rate"] = 200.0
    else:
        mix.update(seq_len=32, trace_seconds=0.5)
        mix["doc_len"] = {**mix["doc_len"], "median": 12, "min": 2,
                          "max": 80}
    return mix


os.environ.setdefault("OMP_NUM_THREADS", "2")
