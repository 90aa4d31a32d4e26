"""BENCHMARK.json against the benchmark's contract, every cell resolved to
its files, a new configuration, mix and metric added as files only, and a
cell whose model or kind has no file refused."""

import json
import re
import shutil

import pytest

from portbench import harness, spec

DOC = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in DOC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert DOC["command"] == ["python3", "portbench/run.py"]
    assert DOC["paths"] == ["portbench"]
    assert 1 <= DOC["run_seconds"] <= 51
    assert len(json.dumps(DOC)) <= 64 * 1024
    names = [m["name"] for m in DOC["end_to_end"] + DOC["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in names


def test_names_units_and_keys():
    for c in DOC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
    for w in DOC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] == 1 and len(w["why"]) <= 200
    for m in DOC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in DOC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["moves"] in {e["name"] for e in DOC["end_to_end"]}
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = spec.load_cell(cell)
    kind = spec.kind(c.mix["kind"])
    assert all(callable(getattr(kind, f)) for f in ("data", "run", "check", "control"))
    model = spec.model(c.config["model"])
    assert all(callable(getattr(model, f)) for f in
               ("init_params", "leaves", "adjacency", "forward", "flops", "spmm_bound_s"))
    assert callable(spec.system(c.config["model"]).System)
    assert c.config["dims"][0] > 0 and c.config["graph"]["n"] > 0
    assert set(c.mix["limits"])
    for m in c.per_layer:
        assert callable(spec.reader(m["name"]))
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    # each per-layer metric here moves an end-to-end metric this cell reports
    assert {m["moves"] for m in c.per_layer} <= reported


def test_new_config_mix_and_metric_are_files_only(tmp_path):
    """A throwaway configuration, mix and per-layer metric, each a new file
    with a new entry, run without a change to any file already there."""
    shutil.copytree(spec.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    doc = json.loads(json.dumps(DOC))
    cfg = json.loads((spec.ROOT / "portbench/configs/gcn-ddi.json").read_text())
    cfg.update(name="gcn-tiny", dims=[16, 8, 4], ordering="rcm")
    cfg["graph"] = {"dataset": "tiny", "n": 300, "nnz": 3000, "seed": 7}
    (tmp_path / "portbench/configs/gcn-tiny.json").write_text(json.dumps(cfg))
    # two callers on another route
    mix = {"kind": "serve", "clients": 2, "pool": 3,
           "precision": "f32", "plan": {"impl": "csr_ell"},
           "limits": {"request_err": 1e-4}}
    (tmp_path / "portbench/mixes/serve-ell.json").write_text(json.dumps(mix))
    (tmp_path / "portbench/metrics/pool_size.py").write_text(
        "def read(r):\n    return float(r['units_per_s'] is not None)\n")
    doc["configs"].append({"name": "gcn-tiny", "source": "https://example.org",
                           "file": "portbench/configs/gcn-tiny.json",
                           "reduced": [], "why": "throwaway"})
    doc["workloads"].append({"name": "gcn-tiny.serve-ell", "config": "gcn-tiny",
                             "traffic": "serve-ell", "chips": 1, "why": "throwaway"})
    doc["per_layer"].append({"name": "pool_size.serve", "unit": "1", "better": "higher",
                             "source": "host_clock", "layer": "host dispatch",
                             "moves": "requests_per_s",
                             "workloads": ["gcn-tiny.serve-ell"]})
    for m in doc["end_to_end"]:
        if m["name"] in ("requests_per_s", "request_ms_p95"):
            m["workloads"].append("gcn-tiny.serve-ell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    hook = harness.Hook(root=tmp_path, scale=1.0)
    argv = ["--workload", "gcn-tiny.serve-ell", "--seed", "3", "--seconds", "0.2"]
    assert harness.main(argv + ["--trace", "1"], hook=hook) == 0
    assert hook.result["correct"] is True
    assert hook.metrics["pool_size.serve"]["value"] == 1.0
    assert harness.main(argv + ["--trace", "0"], hook=hook) == 0
    assert set(hook.metrics) == {"requests_per_s", "request_ms_p95", "setup_s"}


@pytest.mark.parametrize("part", ["model", "kind"])
def test_a_model_or_kind_without_a_file_is_refused(tmp_path, part, capsys):
    """A configuration naming a model, or a mix naming a kind, that has no
    file under portbench/ is refused before anything runs, never run as
    another."""
    shutil.copytree(spec.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    doc = json.loads(json.dumps(DOC))
    cfg = json.loads((spec.ROOT / "portbench/configs/gcn-ddi.json").read_text())
    mix = json.loads((spec.ROOT / "portbench/mixes/serve.json").read_text())
    if part == "model":
        cfg["model"] = "gat"
    else:
        mix["kind"] = "stream"
    (tmp_path / "portbench/configs/gcn-ddi.json").write_text(json.dumps(cfg))
    (tmp_path / "portbench/mixes/serve.json").write_text(json.dumps(mix))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(doc))
    with pytest.raises(LookupError):
        spec.load_cell("gcn-ddi.serve", tmp_path)
    hook = harness.Hook(root=tmp_path)
    argv = ["--workload", "gcn-ddi.serve", "--seed", "1", "--seconds", "0.1",
            "--trace", "0"]
    assert harness.main(argv, hook=hook) != 0
    assert '"correct"' not in capsys.readouterr().out and not hook.result
