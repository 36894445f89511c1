"""On the card (marked cuda; skipped without one): each cell of
BENCHMARK.json runs at its own size for a short window and its check
holds."""
import json
import time

import pytest

from conftest import ROOT
from ptbench import harness

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    res, lines = harness.run(
        ["--workload", cell, "--seed", "9000000001", "--seconds", "2",
         "--trace", "0"], time.perf_counter(), root=ROOT, device=card)
    assert res["correct"] is True, lines
    assert res["device"]["platform"] == "gpu" and res["attempted"] >= 1
