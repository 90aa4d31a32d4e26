"""The CPU dry run: every cell's whole run at a tiny size through the
harness's hook (no card, no device metric), the contract's last line,
the faults that ``correct`` has to catch, and the control."""

import json
import subprocess
import sys

import pytest

from portbench import control, harness, spec

CELLS = [w["name"] for w in json.loads((spec.ROOT / "BENCHMARK.json").read_text())
         ["workloads"]]
SEED = 2**31 + 11  # seeds run past 32 signed bits


def dry_run(cell, trace=0, patch=None, seed=SEED):
    hook = harness.Hook(patch=patch)
    argv = ["--workload", cell, "--seed", str(seed), "--seconds", "0.3",
            "--trace", str(trace)]
    assert harness.main(argv, hook=hook) == 0
    return hook


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line_keys(cell, trace, capsys):
    hook = dry_run(cell, trace)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device",
                          "checks"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["metrics"] == {}  # a CPU run reports no device metric
    assert line["device"]["platform"] == "cpu"
    assert set(line["checks"]) == set(spec.load_cell(cell).mix["limits"])
    c = spec.load_cell(cell)
    want = {m["name"] for m in (c.per_layer if trace else c.end_to_end)}
    # what the readers would report: the host-clock metrics, none of the
    # device ones off the card
    device = {m["name"] for m in c.per_layer if m["source"] == "device_trace"
              or m["name"].startswith("mfu")}
    assert set(hook.metrics) == want - (device if trace else set())


def inputs(cell, seed):
    c = spec.load_cell(cell)
    return harness.make_inputs(c.config, c.mix, 50, seed, "cpu",
                               spec.model(c.config["model"]), spec.kind(c.mix["kind"]))


def test_same_seed_same_inputs():
    a, b, other = inputs(CELLS[0], SEED), inputs(CELLS[0], SEED), inputs(CELLS[0], 5)
    assert all((x == y).all() for x, y in zip(a["pool"], b["pool"]))
    assert all((x == y).all() for x, y in zip(a["leaves"], b["leaves"]))
    assert not (a["pool"][0] == other["pool"][0]).all()


def kind_faults(cell):
    return spec.kind(spec.load_cell(cell).mix["kind"]).FAULTS


FAULTS = [(c, f) for c in CELLS for f in kind_faults(c)]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(cell, fault):
    """The timed path broken underneath: correct comes out false."""
    hook = dry_run(cell, patch=kind_faults(cell)[fault])
    assert hook.result["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """The reference at TF32 (emulated off the card) in the program's place
    fails a limit, on three seeds."""
    rows = control.readings(cell, [1, 2, SEED], "control", device="cpu",
                            scale=0.005)
    assert [ok for _, _, ok in rows] == [False, False, False]


def test_no_card_no_line(tmp_path):
    """Without a card, and in a directory that holds only BENCHMARK.json
    and the benchmark, run.py exits non-zero and prints no result."""
    import shutil

    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    for where in (spec.ROOT, tmp_path):
        p = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELLS[0],
                            "--seed", "1", "--seconds", "1", "--trace", "0"],
                           cwd=where, capture_output=True, text=True, timeout=300)
        assert p.returncode != 0 and '"correct"' not in p.stdout
