"""On the card: each cell's run through run.py for a short window, the
contract's line with every metric of the cell, and the control at the
cell's own size coming out as not correct. Skip without an NVIDIA GPU;
run on one with

    python -m pytest portbench/tests/test_portbench_card.py -q
"""

import json
import subprocess
import sys

import pytest

from portbench import control, spec

CELLS = [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())
         ["workloads"]]

pytestmark = pytest.mark.portbench_card


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell, trace):
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", cell,
                        "--seed", str(2**31 + 5), "--seconds", "3", "--trace",
                        str(trace)], cwd=spec.ROOT, capture_output=True, text=True,
                       timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    c = spec.load_cell(cell)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    assert set(line["metrics"]) == want
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == c.chips
    for m in line["metrics"].values():
        assert m["value"] >= 0
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert {"device_ops", "idle_gaps"} <= set(line["breakdown"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(card, cell):
    rows = control.readings(cell, [1, 2, 3], "control", device=card)
    assert [ok for _, _, ok in rows] == [False, False, False], rows
