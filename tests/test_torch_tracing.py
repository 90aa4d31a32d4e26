"""The port's program tracing (utils/profiling: enable, span, count,
take, and trace's export of the spans) on the CPU: off, a span is the
shared no-op and nothing is recorded; on, spans nest with their parents
on each native thread, the buffer keeps its cap and counts what it
drops, and a span converted through the Chrome trace's
baseTimeNanoseconds holds the aten:: operations issued inside it. The
SpMM route's spans and counters (ops/plan, ops/dispatch): exact
sdb.nnz / sdb.positions of small csr_ell (Σ m·K), csr_pallas (the
nonzeros), bsr_pallas (b² a walked slot), hybrid (its parts' sums) and
grad plans, sdb.sum around the hybrid's parts, sdb.backward around the
Aᵀ leaf on autograd's thread, and sdb.route with auto's decision."""

import json
import threading

import numpy as np
import pytest
import torch

from spmm_denseblock_tpu_torch.convert.divide import divide
from spmm_denseblock_tpu_torch.formats.bsr import random_bsr
from spmm_denseblock_tpu_torch.formats.csr import CSR, random_csr
from spmm_denseblock_tpu_torch.ops import spmm_plan
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas import bsr_spmm_pallas_plan
from spmm_denseblock_tpu_torch.ops.hybrid_spmm import hybrid_spmm_plan
from spmm_denseblock_tpu_torch.utils import profiling

torch.set_num_threads(2)


@pytest.fixture
def tracing():
    """Program tracing on for the test, off and emptied after it."""
    profiling.take()
    profiling.enable(True)
    yield
    profiling.enable(False)
    profiling.take()


def _x(n, F, seed=0):
    return torch.as_tensor(
        np.random.default_rng(seed).standard_normal((n, F)).astype(np.float32))


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


# -- the facility ----------------------------------------------------------


def test_off_records_nothing():
    assert not profiling.enabled()
    a, b = profiling.span("sdb.x"), profiling.span("sdb.y", k=1)
    assert a is b
    with a as s:
        s.set(k=2)
        profiling.count("sdb.c", 3)
    plan = spmm_plan(random_csr(0.05, 64, seed=1), impl="csr_ell", grad=False,
                     device="cpu")
    plan(_x(64, 8))
    assert profiling.take() == {"spans": [], "counts": {}, "dropped": 0}


def test_nesting_parents_and_attrs(tracing):
    with profiling.span("a", k=1) as a:
        with profiling.span("b"):
            pass
        with profiling.span("c") as c:
            c.set(v=2)
        a.set(k=3)
    spans = profiling.take()["spans"]
    assert [s.name for s in spans] == ["a", "b", "c"]
    sa, sb, sc = spans
    assert sa.parent == -1 and sb.parent == sa.index and sc.parent == sa.index
    assert sa.attrs == {"k": 3} and sb.attrs == {} and sc.attrs == {"v": 2}
    assert {s.thread for s in spans} == {threading.get_native_id()}
    assert sa.start_ns <= sb.start_ns <= sb.end_ns <= sc.start_ns <= sc.end_ns <= sa.end_ns
    assert profiling.take() == {"spans": [], "counts": {}, "dropped": 0}


def test_threads_keep_their_own_parents(tracing):
    ids, go = {}, threading.Barrier(2)

    def work(tag):
        ids[tag] = threading.get_native_id()
        with profiling.span("outer", tag=tag):
            go.wait(timeout=10)  # both outers open at once
            with profiling.span("inner", tag=tag):
                pass
            go.wait(timeout=10)

    threads = [threading.Thread(target=work, args=(t,)) for t in ("p", "q")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    spans = profiling.take()["spans"]
    assert len(spans) == 4 and ids["p"] != ids["q"]
    by_index = {s.index: s for s in spans}
    for s in spans:
        assert s.thread == ids[s.attrs["tag"]]
        if s.name == "inner":
            parent = by_index[s.parent]
            assert parent.name == "outer" and parent.attrs == s.attrs
        else:
            assert s.parent == -1


def test_cap_drops_the_oldest(tracing):
    for i in range(profiling.SPAN_CAP + 3):
        with profiling.span("s", i=i):
            pass
    got = profiling.take()
    assert len(got["spans"]) == profiling.SPAN_CAP and got["dropped"] == 3
    assert [s.attrs["i"] for s in got["spans"][:2]] == [3, 4]
    assert got["spans"][-1].attrs["i"] == profiling.SPAN_CAP + 2
    assert profiling.take()["dropped"] == 0


def test_counts_add(tracing):
    profiling.count("sdb.a", 2)
    profiling.count("sdb.a", 5)
    profiling.count("sdb.b", 1)
    assert profiling.take()["counts"] == {"sdb.a": 7, "sdb.b": 1}


def test_span_on_the_profilers_timeline(tmp_path, tracing):
    """A span converted through baseTimeNanoseconds holds, on its tid,
    the aten:: operations issued inside it."""
    from torch.profiler import ProfilerActivity, profile

    x = _x(128, 128)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("sdb.test"):
            (x @ x).relu().sum()
    path = tmp_path / "t.json"
    prof.export_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    (s,) = profiling.take()["spans"]
    t0 = (s.start_ns - doc["baseTimeNanoseconds"]) / 1e3
    t1 = (s.end_ns - doc["baseTimeNanoseconds"]) / 1e3
    ops = [e for e in doc["traceEvents"] if e.get("cat") == "cpu_op"
           and e["name"] in ("aten::mm", "aten::relu", "aten::sum")]
    assert {e["name"] for e in ops} == {"aten::mm", "aten::relu", "aten::sum"}
    for e in ops:
        assert e["tid"] == s.thread
        assert t0 <= float(e["ts"]) and float(e["ts"]) + float(e["dur"]) <= t1


def test_trace_writes_the_spans(tmp_path):
    A = random_csr(0.05, 64, seed=2)
    plan = spmm_plan(A, impl="csr_ell", grad=False, device="cpu")
    with profiling.trace(str(tmp_path)):
        plan(_x(64, 8))
    assert not profiling.enabled()
    (f,) = tmp_path.glob("trace_*.json")
    events = json.loads(f.read_text())["traceEvents"]
    (span,) = [e for e in events if e.get("cat") == "sdb" and e["ph"] == "X"]
    assert span["name"] == "sdb.csr_ell" and span["args"]["parent"] == -1
    inside = [e for e in events if e.get("cat") == "cpu_op" and e["tid"] == span["tid"]
              and span["ts"] <= e["ts"] <= span["ts"] + span["dur"]]
    assert any(e["name"] == "aten::index_select" for e in inside)
    (counts,) = [e for e in events if e.get("name") == "sdb.counts"]
    assert counts["args"] == {"sdb.nnz/csr_ell": A.nnz,
                              "sdb.positions/csr_ell": plan.positions}


# -- the SpMM route's spans and counters ---------------------------------------


def _ell_slots(csr: CSR) -> int:
    """Σ over rows of the "quarter" ELL width: a multiple of a quarter of
    the next power of two of the row's degree."""
    out = 0
    for d in np.diff(np.asarray(csr.indptr, np.int64)):
        p2 = 1 << max(0, int(d - 1).bit_length()) if d > 1 else 1
        step = max(1, p2 // 4)
        out += max(1, -(-int(d) // step) * step)
    return out


@pytest.mark.parametrize("compact", ["off", "force"])
def test_csr_ell_counts(tracing, compact):
    A = random_csr(0.04, 200, 150, seed=3)
    plan = spmm_plan(A, impl="csr_ell", grad=False, compact=compact, device="cpu")
    assert plan.name == "csr_ell" and plan.nnz == A.nnz
    assert plan.positions == _ell_slots(A)
    plan(_x(150, 8))
    plan(_x(150, 8))
    got = profiling.take()
    assert [s.name for s in got["spans"]] == ["sdb.csr_ell"] * 2
    assert got["counts"] == {"sdb.nnz/csr_ell": 2 * A.nnz,
                             "sdb.positions/csr_ell": 2 * _ell_slots(A)}


def test_csr_pallas_counts_the_nonzeros(tracing):
    A = random_csr(0.05, 120, seed=4)
    plan = spmm_plan(A, impl="csr_pallas", grad=False, device="cpu")
    plan(_x(120, 16))
    got = profiling.take()
    assert [s.name for s in got["spans"]] == ["sdb.csr_pallas"]
    assert got["counts"] == {"sdb.nnz/csr_pallas": A.nnz,
                             "sdb.positions/csr_pallas": A.nnz}


def _walked_slots_loop(plan) -> int:
    """The slots K1, K2 and K4 multiply, lane by lane from the packed
    arrays: every slot of a valid lane's steps."""
    layout, nbr = plan.statics[0], plan.statics[1]
    a = [t.numpy() if t.dtype != torch.bfloat16 else None for t in plan.arrays]
    if layout == "sorted":
        R, gh = plan.statics[7][:2]
        ptr, valid = a[5], a[4]
    elif layout == "rowgroup":
        R, gh = plan.statics[7]
        ptr = a[3]
        valid = np.arange((ptr.size - 1) * R) < nbr
    else:
        R, gh, ptr, valid = 1, plan.statics[7], a[3], np.ones(nbr, bool)
    total = 0
    for g in range(ptr.size - 1):
        for lane in range(R):
            if valid[g * R + lane]:
                total += (ptr[g + 1] - ptr[g]) * gh
    return int(total)


@pytest.mark.parametrize("kw,layout", [
    ({}, "flat"),                                    # f32, few blocks a row
    ({"dtype": torch.bfloat16, "depth_sort": True}, "sorted"),  # K2: absent lanes
    ({"dtype": torch.bfloat16, "depth_sort": False}, "rowgroup"),  # K4
])
def test_bsr_pallas_counts_walked_slots(tracing, kw, layout):
    A = random_bsr(0.3, 9, 7, block_size=16, seed=5)
    plan = bsr_spmm_pallas_plan(A, grad=False, device="cpu", **kw)
    assert plan.statics[0] == layout
    slots = _walked_slots_loop(plan)
    assert slots >= A.nnzb
    if layout == "flat":  # each block-row padded to a multiple of group
        counts = np.bincount(np.asarray(A.block_rows[:A.nnzb]), minlength=9)
        g = plan.statics[7]
        assert slots == sum(-(-max(c, 1) // g) * g for c in counts)
    assert plan.positions == slots * 16 * 16
    assert plan.nnz == int(np.count_nonzero(np.asarray(A.blocks[:A.nnzb])))
    plan(_x(7 * 16, 8))
    got = profiling.take()
    assert [s.name for s in got["spans"]] == ["sdb.bsr_pallas"]
    assert got["counts"] == {"sdb.nnz/bsr_pallas": plan.nnz,
                             "sdb.positions/bsr_pallas": plan.positions}


def community(n=256, seed=3) -> CSR:
    """Two dense 32-node communities and a sparse random tail, symmetric."""
    rng = np.random.default_rng(seed)
    e = np.concatenate([rng.integers(0, 32, (400, 2)), rng.integers(64, 96, (400, 2)),
                        rng.integers(0, n, (300, 2))])
    e = np.unique(np.concatenate([e, e[:, ::-1]]), axis=0)
    return CSR.from_coo(e[:, 0], e[:, 1], np.ones(len(e), np.float32), shape=(n, n))


def test_hybrid_sums_its_parts(tracing):
    hyb = divide(community(), 32, 0.3)
    assert hyb.dense.nnzb and hyb.remainder.nnz
    plan = hybrid_spmm_plan(hyb, grad=False, device="cpu")
    bsr_part, ell_part = plan.subplans
    assert (bsr_part.name, ell_part.name) == ("bsr_pallas", "csr_ell")
    assert ell_part.nnz == hyb.remainder.nnz
    assert ell_part.positions == _ell_slots(hyb.remainder)
    assert bsr_part.nnz + ell_part.nnz == hyb.nnz
    plan(_x(256, 8))
    got = profiling.take()
    s_sum, s_bsr, s_ell = got["spans"]
    assert (s_sum.name, s_bsr.name, s_ell.name) == ("sdb.sum", "sdb.bsr_pallas",
                                                    "sdb.csr_ell")
    assert s_sum.parent == -1 and s_bsr.parent == s_ell.parent == s_sum.index
    assert got["counts"] == {
        "sdb.nnz/bsr_pallas": bsr_part.nnz, "sdb.positions/bsr_pallas": bsr_part.positions,
        "sdb.nnz/csr_ell": ell_part.nnz, "sdb.positions/csr_ell": ell_part.positions}


def test_grad_plan_backward_span(tracing):
    A = random_csr(0.05, 96, 80, seed=6)
    plan = spmm_plan(A, impl="csr_ell", grad=True, device="cpu")
    fwd, bwd = plan.subplans
    assert fwd.nnz == bwd.nnz == A.nnz
    assert bwd.positions == _ell_slots(A.transpose())
    x = _x(80, 8).requires_grad_(True)
    plan(x).square().sum().backward()
    got = profiling.take()
    names = _by_name(got["spans"])
    (back,) = names["sdb.backward"]
    f_leaf, b_leaf = names["sdb.csr_ell"]
    assert f_leaf.parent == -1 and b_leaf.parent == back.index
    assert back.start_ns <= b_leaf.start_ns <= b_leaf.end_ns <= back.end_ns
    assert got["counts"] == {"sdb.nnz/csr_ell": 2 * A.nnz,
                             "sdb.positions/csr_ell": fwd.positions + bwd.positions}


def test_route_span_carries_the_decision(tracing):
    # the scorer's route (the blocks over the budget): a hybrid at its
    # threshold, or pure ELL with none
    plan = spmm_plan(community(), impl="auto", block_size=32, feat_dim=64,
                     grad=False, bsr_bytes_budget=1, device="cpu")
    # (a CPU plan: padded pricing, the costs in padded slots)
    (route,) = profiling.take()["spans"]
    assert route.name == "sdb.route" and set(route.attrs) == {
        "impl", "threshold", "pricing", "cost", "runner_up_cost"}
    assert route.attrs["pricing"] == "padded" and route.attrs["cost"] > 0
    if plan.subplans is not None:
        assert route.attrs["impl"] == "hybrid" and route.attrs["threshold"] > 0
    else:
        assert route.attrs["impl"] == "csr_ell" and route.attrs["threshold"] is None
    # the fill guard's route: mostly empty blocks within the budget
    spmm_plan(random_csr(0.002, 512, seed=7), impl="auto", feat_dim=64, grad=False,
              device="cpu")
    (route,) = profiling.take()["spans"]
    assert route.attrs == {"impl": "csr_ell", "threshold": None}
