"""The port's readiness harness (spmm_denseblock_tpu_torch/bench/readiness.py)
against the JAX package's scripts/readiness_matrix.py: build_graph's
banded, powerlaw and random matrices bit-equal to the JAX script's; main
on CPU ranks (worlds of 1 and 2) writing records with JAX's keys (plus
"device") under build/, every combination within its gate; and the
port's departure from JAX: a combination that raises or misses its plan
budget is printed as JAX prints it, and main then raises."""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from spmm_denseblock_tpu_torch.bench import readiness

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
# the keys of the JAX script's records (scripts/readiness_matrix.py)
JAX_KEYS = {"kind", "backend", "graph", "strategy", "dtype", "devices", "local_impl",
            "n", "b", "nnzb", "dim", "ms", "nnz_per_s", "retention", "efficiency",
            "max_rel_err", "tol", "gate_ok", "plan_s", "plan_budget_s", "plan_ok",
            "ici_model_efficiency", "ici_model_t_comp_us", "ici_model_t_comm_us",
            "wall_s", "ts"}


@pytest.fixture(scope="module")
def jax_script():
    """The JAX script, loaded by path; what its import changes (JAX's
    compilation cache and platform, and the absolute path it puts first on
    sys.path) is put back after, so later imports load from this checkout."""
    saved = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
        "jax_platforms")}
    path = sys.path[:]
    spec = importlib.util.spec_from_file_location(
        "readiness_matrix_jax", ROOT / "scripts" / "readiness_matrix.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
        for k, v in saved.items():
            jax.config.update(k, v)
    return mod


@pytest.fixture(autouse=True)
def _own_dir(tmp_path, monkeypatch):
    """main writes under ./build and load_dataset caches under ./tmp."""
    monkeypatch.chdir(tmp_path)


@pytest.mark.parametrize("kind,nbr,b", [("banded", 48, 8), ("powerlaw", 16, 8),
                                        ("random", 40, 16)])
def test_build_graph_bit_equal(jax_script, kind, nbr, b):
    got = readiness.build_graph(kind, nbr, b)
    want = jax_script.build_graph(kind, nbr, b)
    assert got.shape == tuple(want.shape) and got.nnzb == want.nnzb
    for name in ("block_rows", "block_cols", "blocks"):
        np.testing.assert_array_equal(np.asarray(getattr(got, name))[: got.nnzb],
                                      np.asarray(getattr(want, name))[: want.nnzb])


def test_main_on_cpu_ranks(capsys):
    recs = readiness.main(["--devices", "1,2", "--strategies", "halo,ring,allgather",
                           "--dtypes", "f32,bf16,int8", "--n-block-rows", "32",
                           "--block-size", "8", "--dim", "16", "--device", "cpu"])
    assert len(recs) == 3 * 3 * 2
    lines = Path(readiness.DEFAULT_OUT).read_text().splitlines()
    assert [json.loads(line) for line in lines] == recs
    assert not Path("benchmarks").exists()
    for rec in recs:
        assert set(rec) == JAX_KEYS | {"device"}
        assert rec["gate_ok"] and rec["plan_ok"] and rec["backend"] == "cpu-world"
        assert rec["device"] == "cpu" and rec["ms"] > 0
    firsts = [r for r in recs if r["devices"] == 1]
    assert all(r["retention"] == 1.0 and r["efficiency"] == 1.0 for r in firsts)
    out = capsys.readouterr().out
    assert "[readiness] halo      f32  n=2:" in out and out.rstrip().endswith("done")


@pytest.mark.parametrize("argv,printed", [
    (["--strategies", "diagonal"], "FAILED: ValueError"),
    (["--strategies", "halo", "--plan-budget-s", "0"], "OVER-BUDGET"),
])
def test_failed_combination_raises(capsys, argv, printed):
    with pytest.raises(RuntimeError, match="readiness: 1 combination"):
        readiness.main(["--devices", "1", "--dtypes", "f32", "--n-block-rows", "16",
                        "--block-size", "8", "--dim", "8", "--device", "cpu", *argv])
    assert printed in capsys.readouterr().out
