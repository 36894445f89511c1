"""The port's bench (`python -m pathtracer_tpu_torch.bench`) on the CPU
through the kernels' plain versions (BENCH_DEVICE=cpu) at 16x12 and 1-2
spp: its one JSON line parses and carries bench.py's keys; the wavefront
backend and the wavefront autograd path (BENCH_DIFF_BACKEND=wavefront,
`fwd_bwd_textures`) measure; without a card and without
BENCH_DEVICE=cpu it prints an error line and exits 1, and it runs where
`import jax` fails."""
import json
import os
import subprocess
import sys

import pytest
import torch

from pathtracer_tpu_torch import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"BENCH_DEVICE": "cpu", "BENCH_WIDTH": "16", "BENCH_HEIGHT": "12",
         "BENCH_SPP": "2", "BENCH_EXTRA": "0"}


def _run(monkeypatch, capsys, **env):
    for k, v in {**SMALL, **env}.items():
        monkeypatch.setenv(k, v)
    rc = bench.main()
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return rc, json.loads(lines[0])


def test_bench_headline_record(monkeypatch, capsys):
    rc, rec = _run(monkeypatch, capsys)
    assert rc == 0
    assert rec["metric"] == "reference_16x12_Msamples_per_sec"
    assert rec["unit"] == "Msamples/s" and rec["value"] > 0
    assert rec["vs_baseline"] == pytest.approx(
        rec["value"] / bench.BASELINE_MSPS, abs=1e-4)
    assert rec["torch_device"] == "cpu" and "extra" not in rec


@pytest.mark.parametrize("extra,key", [
    ("fwd_teapot", "fwd_teapot"),
    ("torch_fwd_reference_nee", "torch_fwd_reference_nee"),
    ("fwd_bwd_textures", "fwd_bwd_textures"),
])
def test_bench_one_extra(monkeypatch, capsys, extra, key):
    rc, rec = _run(monkeypatch, capsys, BENCH_EXTRA=extra)
    assert rc == 0 and list(rec["extra"]) == [key]
    got = rec["extra"][key]
    assert got["Msamples_per_sec"] > 0
    # vs_baseline for the forward records of a baseline scene alone
    assert ("vs_baseline" in got) == (key != "fwd_bwd_textures")
    assert got.get("stand_in", False) == (key == "fwd_teapot")


def test_bench_wavefront_and_unported(monkeypatch, capsys):
    rc, rec = _run(monkeypatch, capsys, BENCH_BACKEND="wavefront",
                   BENCH_SPP="1")
    assert rc == 0 and rec["value"] > 0
    # bench.py's bench_diff_wavefront: the wavefront autograd path's SGD
    # steps (was "not ported" before it was)
    rc, rec = _run(monkeypatch, capsys, BENCH_BACKEND="diff",
                   BENCH_DIFF_BACKEND="wavefront")
    assert rc == 0 and rec["value"] > 0 and "skipped" not in rec
    assert rec["metric"] == "reference_fwd_bwd_16x12_Msamples_per_sec"


def test_bench_needs_a_card_and_no_jax():
    # no card and no BENCH_DEVICE=cpu: an error line and exit code 1, in a
    # process where `import jax` fails
    env = {k: v for k, v in os.environ.items() if k != "BENCH_DEVICE"}
    env["PYTHONPATH"] = ROOT
    code = ("import sys, runpy; sys.modules['jax'] = None; "
            "runpy.run_module('pathtracer_tpu_torch.bench', "
            "run_name='__main__')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode == 1, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["value"] is None and "no CUDA device" in rec["error"]
