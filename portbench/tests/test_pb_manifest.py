"""BENCHMARK.json keeps to the contract's form, and the harness finds every
file of every cell by name."""

import dataclasses
import json
import re

import pytest

from conftest import BENCH, load
from harness import main

ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH_JSON = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_names():
    b = BENCH_JSON
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = [c["name"] for c in b["configs"]] + [
        w["name"] for w in b["workloads"]] + [
        m["name"] for m in b["end_to_end"] + b["per_layer"]]
    for n in names + [w["traffic"] for w in b["workloads"]]:
        assert NAME.match(n), n
    metrics = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in b["end_to_end"]} >= {"setup_s"}
    assert 1 <= b["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_cell_reports_what_it_must():
    b = BENCH_JSON
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for w in b["workloads"]:
        mine = [m for m in b["end_to_end"] if main.applies(m, w["name"])]
        assert "setup_s" in {m["name"] for m in mine}
        assert len(mine) >= 2
        layer = [m for m in b["per_layer"] if main.applies(m, w["name"])]
        assert layer, w["name"]
        for m in layer:
            assert main.applies(e2e[m["moves"]], w["name"]), (m, w)


def test_files_found_by_name():
    b = BENCH_JSON
    for w in b["workloads"]:
        p = main.parts(b, w["name"])
        assert (BENCH / (p.driver.replace(".", "/") + ".py")).is_file()
        assert set(p.limits) and all(v > 0 for v in p.limits.values())
    for c in b["configs"]:
        assert c["file"].startswith("portbench/")
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"]
    for m in b["per_layer"]:
        assert callable(main.reader(m["name"]))
    for p in b["paths"]:
        assert (ROOT / p).is_dir()


@pytest.mark.parametrize("name", ["granite-3-2b", "olmoe-1b-7b"])
def test_configuration_is_the_programs(name):
    from repro_torch.configs import get_config
    from harness.model import port_config

    assert dataclasses.asdict(port_config(load("configs", name))) == \
        dataclasses.asdict(get_config(name))
