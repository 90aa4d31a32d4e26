"""The metric arithmetic on made-up traces and readings: idle share as a
union of device intervals with the launcher ranges left out, the SpMM
route's attribution by correlation ids and sequence numbers, roofline
and mfu, and the work formulas by hand."""

import math

import pytest

from portbench import spec, trace, work


def op(name, ts, dur, cat="cpu_op", tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
            "pid": 1, "args": args}


def made_up_trace():
    """Two requests. Request 1 (0-30) launches an
    SpMM kernel (inside pb.spmm, 10-20 on the device) and a dense kernel;
    request 2 (40-70) an SpMM whose backward (on another thread, matched
    by its sequence number) launches a kernel; the launcher range
    sdb_entry shows on the device timeline over the first kernel and is
    not device work; a kernel launched before the profiler started
    (no launch event) counts as busy only."""
    return [
        op("pb.request", 0, 30, "user_annotation"),
        op("pb.spmm", 1, 10, "user_annotation"),
        op("_PlanVJP", 2, 8, **{"Sequence number": 5}),
        op("cudaLaunchKernel", 3, 1, "cuda_runtime", correlation=1),
        op("cudaLaunchKernel", 15, 1, "cuda_runtime", correlation=2),
        op("pb.request", 40, 30, "user_annotation"),
        op("pb.spmm", 41, 5, "user_annotation"),
        op("aten::mm", 42, 2, **{"Sequence number": 9}),
        op("autograd::engine::evaluate_function: MmBackward0", 50, 10, tid=2,
           **{"Sequence number": 9}),
        op("cudaLaunchKernel", 52, 1, "cuda_runtime", tid=2, correlation=3),
        op("sdb_entry", 10, 10, "gpu_user_annotation"),
        op("spmm_kernel", 10, 10, "kernel", correlation=1),
        op("dense_kernel", 20, 5, "kernel", correlation=2),
        op("bwd_kernel", 60, 10, "kernel", correlation=3),
        op("old_kernel", 90, 20, "kernel", correlation=77),
    ]


def test_route_summary_made_up_trace():
    s = trace.route_summary(made_up_trace(), "pb.request")
    assert s["units"] == 2
    assert s["spmm_s"] == pytest.approx(20e-6)   # spmm_kernel + bwd_kernel
    assert s["dense_s"] == pytest.approx(5e-6)   # old_kernel belongs to none


def test_device_summary_made_up_trace():
    """The window runs from the first runtime call (3) to the end of the
    last device operation (110); busy 10-25, 60-70, 90-110; the
    launcher range and the spans are no device work."""
    s = trace.device_summary(made_up_trace())
    assert s["window_s"] == pytest.approx(107e-6)
    assert s["busy_s"] == pytest.approx(45e-6)
    names = dict(s["breakdown"]["device_ops"])
    assert "sdb_entry" not in names and "pb.spmm" not in names
    assert names["spmm_kernel"] == pytest.approx(10e-6)
    gaps = s["breakdown"]["idle_gaps"]
    assert gaps[0][1] == pytest.approx(35e-6)    # 25-60, the longest
    assert gaps[0][0] == "cudaLaunchKernel -> cudaLaunchKernel"
    assert gaps[1] == ["cudaLaunchKernel -> end", pytest.approx(20e-6)]  # 70-90
    assert gaps[2][1] == pytest.approx(7e-6)    # 3-10


def reading(**over):
    r = {"kind": "serve", "on_device": True, "prep_s": 1.5, "plan_s": 0.5,
         "enqueue_ms": 2.0, "units_per_s": 100.0, "model_flops": 4e10,
         "spmm_bound_s": 2e-4, "peak_ops_s": 67e12,
         "trace": {"units": 10, "spmm_s": 0.08, "dense_s": 0.01, "busy_s": 0.9,
                   "window_s": 1.0, "on_device": True}}
    r.update(over)
    return r


def test_readers():
    r = reading()
    assert spec.reader("spmm_ms.serve")(r) == pytest.approx(8.0)
    assert spec.reader("dense_ms.serve")(r) == pytest.approx(1.0)
    assert spec.reader("spmm_roofline.serve")(r) == pytest.approx(100 * 2e-4 / 8e-3)
    assert spec.reader("mfu.serve")(r) == pytest.approx(100 * 4e10 * 100 / 67e12)
    assert spec.reader("idle_share.serve")(r) == pytest.approx(10.0)
    assert spec.reader("prep_s")(r) == 1.5 and spec.reader("plan_s")(r) == 0.5


@pytest.mark.parametrize("name", ["spmm_ms", "dense_ms", "spmm_roofline", "mfu",
                                  "idle_share"])
def test_device_readers_are_silent_off_the_card(name):
    """A reader that finds nothing to read returns nothing, never 0."""
    assert spec.reader(name)(reading(on_device=False)) is None
    empty = {"units": 0, "spmm_s": 0.0, "dense_s": 0.0, "busy_s": 0.0,
             "window_s": 1.0, "on_device": False}
    if name != "mfu":
        assert spec.reader(name)(reading(trace=empty)) is None


def test_work_formulas_by_hand():
    nnz, n, f = 1000, 100, 8
    assert work.csr_spmm_bytes(nnz, n, n, f) == 1000 * 8 + 101 * 4 + 2 * 100 * 8 * 4
    ops_s = 2 * nnz * f / 67e12
    bytes_s = work.csr_spmm_bytes(nnz, n, n, f) / 3.35e12
    assert work.csr_spmm_bound_s(nnz, n, f) == max(ops_s, bytes_s)
    dims = [4, 3, 2]
    fwd = (2 * nnz * 4 + 2 * n * 4 * 3) + (2 * nnz * 3 + 2 * n * 3 * 2)
    assert work.gcn_flops(nnz, n, dims, train=False) == fwd
    # training: + weight gradients of both layers, + layer 2's input
    # gradient (dense and Aᵀ)
    assert work.gcn_flops(nnz, n, dims, train=True) == (
        fwd + 2 * n * 4 * 3 + 2 * n * 3 * 2 + 2 * n * 3 * 2 + 2 * nnz * 3)
    assert work.gcn_spmm_widths([128, 256, 256, 40], True) == [128, 256, 256, 256, 256]
    assert math.isclose(work.gcn_spmm_bound_s(nnz, n, dims, False),
                        work.csr_spmm_bound_s(nnz, n, 4) + work.csr_spmm_bound_s(nnz, n, 3))
