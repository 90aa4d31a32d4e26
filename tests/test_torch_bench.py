"""The port's bench harness and sweep CLI against the JAX package's, on the
CPU: the record helpers (_bsr_record at a fixed time, conformance_fields,
dtype_tolerance) give JAX's values; each runner (bench_synthetic_bsr at
transb 0 and 1, bench_synthetic_csr, bench_graph, bench_train_step) gives
a record whose fields other than its times equal JAX's for the same
arguments, plus the device it ran on, and which json.dumps; with the
runners replaced by recorders in both packages the sweep CLI lists JAX's
cases, quick and full; a case that raises is captured into its record;
and the distributed runners (bench_scaling, bench_train_scaling,
sweep_scaling and the CLI's scaling) give JAX's records on worlds of CPU
ranks at the JAX tests' shapes. Times are not compared: JAX's come from
another machine; nor the ici_model_* values (JAX's model is a TPU's, the
port's the H100's)."""

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import spmm_denseblock_tpu.bench as j_bench
import spmm_denseblock_tpu.formats.bsr as j_bsr
import spmm_denseblock_tpu_torch.bench as t_bench
import spmm_denseblock_tpu_torch.formats.bsr as t_bsr

JH = importlib.import_module("spmm_denseblock_tpu.bench.harness")
TH = importlib.import_module("spmm_denseblock_tpu_torch.bench.harness")
JS = importlib.import_module("spmm_denseblock_tpu.bench.sweeps")
TS = importlib.import_module("spmm_denseblock_tpu_torch.bench.sweeps")

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
# fields that hold or derive from a measured time
TIMING = {"ms", "ms_min", "ms_max", "gflops", "nnz_per_s", "achieved_gb_s",
          "plan_s", "spread_frac", "spread_warn", "ms_per_step", "edges_per_s"}


@pytest.fixture(autouse=True)
def _own_cache(tmp_path, monkeypatch):
    """Both packages' load_dataset cache their graphs under ./tmp: give
    each test its own, apart from other workers' files."""
    monkeypatch.chdir(tmp_path)


def same_record(t_rec: dict, j_rec: dict) -> None:
    json.dumps(t_rec)
    assert set(t_rec) - TIMING == (set(j_rec) - TIMING) | {"device"}
    assert t_rec["device"] == "cpu"
    for k in set(j_rec) - TIMING:
        assert t_rec[k] == j_rec[k], k
    assert all(t_rec[k] > 0 for k in ("ms", "ms_min", "ms_max") if k in t_rec)


def test_public_names_are_jax_names():
    assert t_bench.__all__ == j_bench.__all__
    import spmm_denseblock_tpu.utils as j_utils
    import spmm_denseblock_tpu_torch.utils as t_utils

    assert t_utils.__all__ == j_utils.__all__
    assert TS.BSR_GRID == JS.BSR_GRID
    assert TS.CSR_GRID == JS.CSR_GRID
    assert TS.GRAPH_GRID == JS.GRAPH_GRID


@pytest.mark.parametrize("p,nb,b", [(0.05, 16, 16), (0.3, 8, 32), (0.0, 4, 8)])
@pytest.mark.parametrize("secs", [1e-3, 0.25])
def test_bsr_record_equals_jax(p, nb, b, secs):
    jm = j_bsr.random_bsr(p, nb, block_size=b, seed=3)
    tm = t_bsr.random_bsr(p, nb, block_size=b, seed=3)
    assert TH._bsr_record(tm, 24, secs) == JH._bsr_record(jm, 24, secs)


@pytest.mark.parametrize("name", [None, "float32", "f32", "bf16x3", "bfloat16",
                                  "bf16", "int8", "float16"])
def test_dtype_tolerance_equals_jax(name):
    assert TH.dtype_tolerance(name) == JH.dtype_tolerance(name)
    assert TH.DTYPE_TOL == JH.DTYPE_TOL


@pytest.mark.parametrize("scale", [0.0, 1e-5, 3e-3])
@pytest.mark.parametrize("dtype_name", [None, "float32", "bfloat16", "int8"])
def test_conformance_fields_equal_jax(scale, dtype_name):
    rng = np.random.default_rng(5)
    ref = rng.standard_normal((40, 12)).astype(np.float32)
    out = ref + scale * rng.standard_normal(ref.shape).astype(np.float32)
    want = JH.conformance_fields(out, ref, dtype_name)
    assert TH.conformance_fields(out, ref, dtype_name) == want
    # a torch tensor is read the same way as the array
    assert TH.conformance_fields(torch.as_tensor(out), torch.as_tensor(ref),
                                 dtype_name) == want


@pytest.mark.parametrize("transb", [0, 1])
def test_bench_synthetic_bsr_equals_jax(transb):
    kw = dict(impl="bsr_xla", n_block_rows=16, transb=transb)
    same_record(t_bench.bench_synthetic_bsr(0.05, 16, 24, device="cpu", **kw),
                j_bench.bench_synthetic_bsr(0.05, 16, 24, **kw))


def test_bench_synthetic_bsr_dtype_name():
    """dtype= takes a torch dtype or its name; the record names it as
    JAX's does."""
    kw = dict(impl="bsr_xla", n_block_rows=8)
    j_rec = j_bench.bench_synthetic_bsr(0.1, 16, 16, dtype="bfloat16", **kw)
    for dt in ("bfloat16", torch.bfloat16):
        rec = t_bench.bench_synthetic_bsr(0.1, 16, 16, dtype=dt, device="cpu", **kw)
        same_record(rec, j_rec)
        assert rec["dtype"] == "bfloat16"


def test_bench_synthetic_csr_equals_jax():
    same_record(t_bench.bench_synthetic_csr(0.01, 16, impl="csr_xla", n_rows=512,
                                            device="cpu"),
                j_bench.bench_synthetic_csr(0.01, 16, impl="csr_xla", n_rows=512))


@pytest.mark.parametrize("impl", ["hybrid", "csr_xla"])
def test_bench_graph_equals_jax(impl):
    kw = dict(strategy="rcmk", block_size=32, dim=16, impl=impl, scale=0.002)
    t_rec = t_bench.bench_graph("ogbn-arxiv", device="cpu", **kw)
    same_record(t_rec, j_bench.bench_graph("ogbn-arxiv", **kw))
    if impl == "hybrid":
        assert t_rec["dense_nnzb"] > 0


def test_bench_train_step_equals_jax():
    kw = dict(scale=0.002, dims=(8, 16, 4), impl="csr_xla", iters=2)
    same_record(t_bench.bench_train_step(device="cpu", **kw),
                j_bench.bench_train_step(**kw))


def _recording_runners(monkeypatch):
    """Every runner of both harnesses replaced by a recorder of its
    keyword arguments (the port's device= set apart)."""
    calls = {"jax": [], "torch": [], "devices": set()}
    for key, mod in (("jax", JH), ("torch", TH)):
        for name in ("bench_synthetic_bsr", "bench_synthetic_csr", "bench_graph"):
            def rec(_n=name, _c=calls[key], **kw):
                if "device" in kw:
                    calls["devices"].add(str(kw.pop("device")))
                _c.append((_n, kw))
                return {"ok": 1, **kw}
            monkeypatch.setattr(mod, name, rec)
    return calls


@pytest.mark.parametrize("sweep", ["bsrmm", "csrmm", "graph"])
@pytest.mark.parametrize("quick", [True, False])
def test_sweep_cases_equal_jax(sweep, quick, monkeypatch, tmp_path):
    calls = _recording_runners(monkeypatch)
    flags = ["--quick"] if quick else []
    out = tmp_path / "r.jsonl"
    assert JS.main([sweep, *flags]) == 0
    assert TS.main([sweep, *flags, "--device", "cpu", "--out", str(out)]) == 0
    assert calls["torch"] == calls["jax"] and calls["torch"]
    assert calls["devices"] == {"cpu"}
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert recs == [{"ok": 1, **kw} for _, kw in calls["torch"]]


def test_sweep_errors_are_captured(monkeypatch, tmp_path):
    def boom(**kw):
        raise RuntimeError("nope")

    monkeypatch.setattr(TH, "bench_synthetic_csr", boom)
    out = tmp_path / "r.jsonl"
    assert TS.main(["csrmm", "--quick", "--device", "cpu", "--out", str(out)]) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(recs) == len(TS.CSR_GRID["impl"])
    for rec in recs:
        assert "nope" in rec["error"] and rec["n_rows"] == 1 << 12


def test_sweep_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _recording_runners(monkeypatch)
    for argv in (["bsrmm", "--quick"], ["csrmm", "--device", "cuda"]):
        with pytest.raises(RuntimeError, match="GPU"):
            TS.main(argv)


# the points' fields that hold or derive from a measured time, or from
# the chip model
SCALING_TIMING = {"ms", "nnz_per_s", "efficiency", "retention", "ms_per_step",
                  "steps_per_s", "ici_model_efficiency", "ici_model_t_comp_us",
                  "ici_model_t_comm_us"}
SCALING_SHAPE = dict(p=0.05, block_size=16, n_block_rows=32)  # JAX's tests'


def same_scaling_record(t_rec: dict, j_rec: dict) -> None:
    json.dumps(t_rec)
    assert set(t_rec) == set(j_rec) | {"device"} and t_rec["device"] == "cpu"
    for k in set(j_rec) - {"points", "note"}:
        assert t_rec[k] == j_rec[k], k
    assert [p["devices"] for p in t_rec["points"]] == [p["devices"] for p in j_rec["points"]]
    for tp, jp in zip(t_rec["points"], j_rec["points"]):
        assert set(tp) == set(jp)
        assert set(tp) - SCALING_TIMING == {"devices"}
    assert "retention" in t_rec["note"] and "not scaling" in t_rec["note"]


def test_bench_scaling_record():
    t_rec = t_bench.bench_scaling([1, 2, 4], dim=32, device="cpu", **SCALING_SHAPE)
    same_scaling_record(t_rec, j_bench.bench_scaling([1, 2, 4], dim=32, **SCALING_SHAPE))
    for p in t_rec["points"]:
        assert p["nnz_per_s"] > 0 and p["ms"] > 0 and p["ici_model_t_comp_us"] > 0
    assert t_rec["points"][0]["retention"] == 1.0


def test_bench_train_scaling_record():
    kw = dict(dims=(16, 16, 4), iters=1, **SCALING_SHAPE)
    t_rec = t_bench.bench_train_scaling([1, 2], device="cpu", **kw)
    same_scaling_record(t_rec, j_bench.bench_train_scaling([1, 2], **kw))
    for p in t_rec["points"]:
        assert p["ms_per_step"] > 0 and p["retention"] > 0


@pytest.mark.parametrize("argv,devices,real", [([], [1, 2, 4], False),
                                                (["--devices", "1", "2"], [1, 2], True)])
def test_sweep_scaling_cli(argv, devices, real, monkeypatch, tmp_path):
    """python -m ... bench scaling: one bench_scaling record over worlds of
    --devices ranks (default 1, 2, 4), streamed to --out: the worlds run
    at the JAX tests' shape (with --devices), or a recorder stands in."""
    calls = []
    bench = TH.bench_scaling

    def small(devs, **kw):
        calls.append((list(devs), kw))
        if real:
            return bench(devs, dim=32, **SCALING_SHAPE, **kw)
        return {"kind": "scaling", "points": [{"devices": d} for d in devs]}

    monkeypatch.setattr(TH, "bench_scaling", small)
    out = tmp_path / "r.jsonl"
    assert TS.main(["scaling", *argv, "--device", "cpu", "--out", str(out)]) == 0
    assert [c[0] for c in calls] == [devices]
    assert str(calls[0][1]["device"]) == "cpu"
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert rec["kind"] == "scaling" and [p["devices"] for p in rec["points"]] == devices
    if real:
        assert all(p["ms"] > 0 for p in rec["points"])


def test_scaling_runners_without_a_gpu_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (t_bench.bench_scaling, t_bench.bench_train_scaling):
        with pytest.raises(RuntimeError, match="GPU"):
            fn([1])
    with pytest.raises(RuntimeError, match="GPU"):
        TS.main(["scaling"])


def test_cli_module_runs_on_the_cpu(tmp_path):
    """python -m spmm_denseblock_tpu_torch.bench csrmm --quick --device cpu:
    one record a case of the quick grid, streamed to --out."""
    out = tmp_path / "r.jsonl"
    proc = subprocess.run(
        [sys.executable, "-m", "spmm_denseblock_tpu_torch.bench", "csrmm",
         "--quick", "--device", "cpu", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stderr[-2000:]
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["impl"] for r in recs] == TS.CSR_GRID["impl"]
    assert all("error" not in r and r["device"] == "cpu" and r["ms"] > 0
               for r in recs)
    assert proc.stdout.splitlines() == out.read_text().splitlines()
