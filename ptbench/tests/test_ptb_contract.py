"""BENCHMARK.json against the benchmark's contract, and every
configuration, traffic mix, check file and metric reader found by name."""
import json
import re
import shutil

import pytest

from conftest import ROOT
from ptbench import harness

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024
    assert BENCH["paths"] == ["ptbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    # a full check of 24 cells: 2 + 14 x 24 runs, each run_seconds + 60,
    # 2 x 90 s a cell to compile, 1200 s spare, within 43,200 s
    n = 24
    assert ((2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 180 + 1200
            <= 43200)


def test_names_units_and_keys():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in METRICS]
    for n in names:
        assert NAME.match(n), n
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({e["name"] for e in group}) == len(group)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("ptbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in METRICS:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = harness.cell(ROOT, cell)
    assert c.config["name"] == c.workload["config"]
    assert (c.dir / "jobs" / f"{c.traffic['job']}.py").is_file()
    assert "limits" in c.checks
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_found_by_name(metric):
    mod = harness.load_module(harness.reader_path(ROOT / "ptbench", metric),
                              f"reader_{metric}")
    assert callable(mod.read)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_as_run(config):
    entry = {c["name"]: c for c in BENCH["configs"]}[config]
    conf = json.loads((ROOT / entry["file"]).read_text())
    assert conf["name"] == config and conf["source"] == entry["source"]
    assert conf["reduced"] == entry["reduced"]
    assert conf["width"] == 1280 and conf["height"] == 960


def test_a_new_cell_is_data_alone(tmp_path, monkeypatch):
    """A cell added by data alone (a BENCHMARK.json entry, a traffic mix
    and a check file, beside unchanged copies of the others) resolves by
    name and runs."""
    import time

    import torch

    from conftest import shrink

    shutil.copytree(ROOT / "ptbench", tmp_path / "ptbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({
        "name": "reference-render-256", "config": "reference",
        "traffic": "render_frames_256", "chips": 1, "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "ptbench" / "traffic" / "render_frames_256.json"
     ).write_text(json.dumps({"job": "render_frames", "samples": 256}))
    checks = json.loads(
        (ROOT / "ptbench" / "checks" / "reference-render.json").read_text())
    (tmp_path / "ptbench" / "checks" / "reference-render-256.json"
     ).write_text(json.dumps(checks))
    c = harness.cell(tmp_path, "reference-render-256")
    assert c.traffic["samples"] == 256 and c.dir == tmp_path / "ptbench"
    real = harness.cell
    monkeypatch.setattr(harness, "cell",
                        lambda root, name: shrink(real(root, name)))
    res, _ = harness.run(["--workload", "reference-render-256", "--seed",
                          "5", "--seconds", "0.2"], time.perf_counter(),
                         root=tmp_path, device=torch.device("cpu"))
    assert res["correct"] and res["attempted"] >= 1
