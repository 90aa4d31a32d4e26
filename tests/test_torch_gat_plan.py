"""Values per call and the GAT's plan route, on the CPU.

- A ``values="call"`` csr_ell plan (the pattern plan): at one head and
  at three, ``plan(x, values=v)`` equals float64 A_h @ X_h built from
  the same values, with empty rows, split rows, duplicate entries and a
  duplicate-free pattern with self-loops, at 250 and 40 columns a head;
  the kernel's walk of the plan's arrays (heads, strips inside a head,
  each segment's offset to its entries) emulated in numpy gives the
  same answer.
- The router: ``auto`` with ``values="call"`` builds the csr_ell pattern
  plan (``sdb.route`` says so), another impl, int8, grad=True, a call
  that needs a gradient, values given to a fixed plan or missing on a
  pattern plan all raise; the nesting plans pass values on.
- The counters: a valued call adds nnz x heads to
  ``sdb.call_values/csr_ell``, and the GAT opens ``sdb.gat_scores`` once
  a layer.
- ``make_gat_apply``: a call that needs no gradient takes the plan
  route, one that does the segment route; both against a float64 GAT
  written out densely here, with seeded weights, with and without the
  residual projection; ``gat_pattern`` against a hand-counted case.

Tolerances: 1e-5 relative to max |float64| for f32 results (single f32
products and sums in another order than float64's; the GAT's three
layers of f32 stay within a few units of the last place at these sizes),
1e-12 for float64 against float64 (the same sums in another order)."""

import importlib

import numpy as np
import pytest
import torch

from spmm_denseblock_tpu_torch import models as M
from spmm_denseblock_tpu_torch.formats.csr import CSR
from spmm_denseblock_tpu_torch.models.graph import gat_pattern
from spmm_denseblock_tpu_torch.ops.dispatch import spmm_plan
from spmm_denseblock_tpu_torch.ops.plan import run, sum_plan
from spmm_denseblock_tpu_torch.utils import profiling

# the package's ops exports a function of the module's name
E = importlib.import_module("spmm_denseblock_tpu_torch.ops.csr_spmm_ell")

torch.set_num_threads(2)

TOL = 1e-5


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _ragged(seed=3, n_rows=700, n_cols=600) -> CSR:
    """Rows of 0 to 9 entries, rows 0-4 empty, row 11 of 1,100 (split
    into segments) with duplicate columns."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 10, n_rows)
    deg[:5] = 0
    deg[11] = 1100
    rows = np.repeat(np.arange(n_rows), deg)
    return CSR.from_coo(rows, rng.integers(0, n_cols, rows.size), None,
                        (n_rows, n_cols))


def _simple(seed=4, n=500) -> CSR:
    """A duplicate-free pattern with a self-loop on every node."""
    edges = np.random.default_rng(seed).integers(0, n, (3 * n, 2))
    return gat_pattern(CSR.from_edges(edges, n))


def _per_head_f64(csr: CSR, v: np.ndarray, x: np.ndarray) -> np.ndarray:
    D = x.shape[1] // v.shape[0]
    return np.concatenate([
        CSR(csr.indptr, csr.indices, v[h], csr.shape).to_scipy().astype(np.float64)
        @ x[:, h * D:(h + 1) * D].astype(np.float64) for h in range(v.shape[0])], 1)


def _inputs(csr: CSR, heads: int, D: int, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((csr.n_cols, heads * D)).astype(np.float32)
    v = rng.standard_normal((heads, csr.nnz)).astype(np.float32)
    return x, v


def _emulate_kernel(plan, x: np.ndarray, v: np.ndarray, W: int) -> np.ndarray:
    """ell_row_kernel's walk over the pattern plan's arrays, in float64:
    strips of W columns inside each of the H heads of D columns, a
    segment's slot k holding entry k + seg_delta[segment], its column
    cols[k], its value v[head, k + delta]; split rows summed from their
    partial rows."""
    _, cols, _, delta, s0, s1, dest, split_row, part_ptr = (
        a.numpy() for a in plan.arrays)
    H, F = v.shape[0], x.shape[1]
    D = F // H
    out = np.zeros((plan.statics[0][0], F))
    partial = np.zeros((int(part_ptr[-1]), F))
    for h in range(H):
        for f0 in range(h * D, (h + 1) * D, W):
            f1 = min(f0 + W, (h + 1) * D)
            for seg in range(s0.size):
                k = np.arange(s0[seg], s1[seg])
                acc = v[h, k + delta[seg]] @ x[cols[k], f0:f1].astype(np.float64)
                tgt = out if dest[seg] >= 0 else partial
                tgt[dest[seg] if dest[seg] >= 0 else -dest[seg] - 1, f0:f1] = acc
    for i, r in enumerate(split_row):
        out[r] = partial[part_ptr[i]:part_ptr[i + 1]].sum(0)
    return out


@pytest.mark.parametrize("D", [250, 40])
@pytest.mark.parametrize("heads", [1, 3])
@pytest.mark.parametrize("graph", ["ragged", "simple"])
def test_call_values_match_float64(graph, heads, D):
    csr = _ragged() if graph == "ragged" else _simple()
    plan = spmm_plan(csr, values="call", device="cpu")
    assert plan.name == "csr_ell" and plan.call_values
    x, v = _inputs(csr, heads, D)
    got = plan(torch.as_tensor(x), values=torch.as_tensor(v if heads > 1 else v[0]))
    assert got.shape == (csr.n_rows, heads * D) and got.dtype == torch.float32
    want = _per_head_f64(csr, v, x)
    assert _rel(got, want) < TOL
    if graph == "ragged":
        assert not got[:5].any() and plan.statics[4] > 0  # empty and split rows


@pytest.mark.parametrize("heads,D,W", [(1, 40, 40), (3, 250, 64), (3, 40, 12)])
def test_kernel_walk_reads_the_values_through_the_offsets(heads, D, W):
    """The arrays the kernel reads: for every segment, slot k's column is
    entry k + seg_delta's, and the walk by head and strip gives float64
    A_h @ X_h."""
    csr = _ragged(seed=6)
    plan = E.csr_spmm_ell_plan(csr, grad=False, values="call", device="cpu")
    _, cols, slot_of_entry, delta, s0, s1, *_ = (a.numpy() for a in plan.arrays)
    for seg in range(s0.size):
        k = np.arange(s0[seg], s1[seg])
        assert np.array_equal(cols[k], np.asarray(csr.indices)[k + delta[seg]])
    assert np.array_equal(cols[slot_of_entry], np.asarray(csr.indices))
    x, v = _inputs(csr, heads, D, seed=7)
    got = _emulate_kernel(plan, x, v, W)
    assert _rel(got, _per_head_f64(csr, v, x)) < 1e-12


def test_values_refused():
    csr = _simple(n=200)
    plan = spmm_plan(csr, values="call", device="cpu")
    x = torch.ones(200, 12)
    with pytest.raises(ValueError, match="nnz"):
        plan(x, values=torch.ones(3, csr.nnz - 1))
    with pytest.raises(ValueError, match="multiple"):
        plan(x, values=torch.ones(5, csr.nnz))
    with pytest.raises(ValueError, match="each call"):
        plan(x)
    with pytest.raises(ValueError, match="each call"):
        run(plan, x, plain=True)
    fixed = spmm_plan(csr, impl="csr_ell", grad=False, device="cpu")
    with pytest.raises(ValueError, match="fixed at build"):
        fixed(x, values=torch.ones(csr.nnz))


@pytest.mark.parametrize("impl", ["csr_pallas", "csr_xla", "hybrid", "bsr_pallas",
                                  "csr_ell_int8", "dense"])
def test_other_tiers_refuse_call_values(impl):
    with pytest.raises(ValueError, match="csr_ell"):
        spmm_plan(_simple(n=200), impl=impl, values="call", device="cpu")


def test_auto_routes_call_values_to_the_ell_pattern_plan(monkeypatch):
    """auto with values="call" hands csr_ell the pattern and values="call"
    (grad False by default), with the ELL tiers' compact="auto", and
    records its choice on sdb.route."""
    from spmm_denseblock_tpu_torch.ops import dispatch as D

    calls = []
    monkeypatch.setitem(D.PLANNERS, "csr_ell",
                        lambda m, **kw: calls.append(kw) or "ell")
    csr = _simple(n=300)
    profiling.take()
    prev = profiling.enable(True)
    try:
        assert spmm_plan(csr, values="call", device="cpu") == "ell"
        spans = profiling.take()["spans"]
    finally:
        profiling.enable(prev)
    assert calls == [{"values": "call", "grad": False, "compact": "auto",
                      "device": torch.device("cpu")}]
    route = [s for s in spans if s.name == "sdb.route"]
    assert len(route) == 1 and route[0].attrs == {"impl": "csr_ell", "threshold": None}


def test_call_values_have_no_gradient():
    csr = _simple(n=200)
    with pytest.raises(ValueError, match="backward"):
        spmm_plan(csr, values="call", grad=True, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        spmm_plan(csr, values="call", dtype=torch.int8, device="cpu")
    plan = spmm_plan(csr, values="call", device="cpu")
    x = torch.ones(200, 6)
    v = torch.ones(2, csr.nnz)
    with pytest.raises(RuntimeError, match="no gradient"):
        plan(x.clone().requires_grad_(True), values=v)
    with pytest.raises(RuntimeError, match="no gradient"):
        plan(x, values=v.clone().requires_grad_(True))
    with torch.no_grad():
        plan(x.clone().requires_grad_(True), values=v.clone().requires_grad_(True))
    from spmm_denseblock_tpu_torch.ops.plan import grad_plan

    with pytest.raises(ValueError, match="backward"):
        grad_plan(plan, plan)


def test_nesting_plans_pass_the_values_on():
    """operand_layout="col" (the transposed operand) and a sum of two
    pattern plans take the values and give the same answers."""
    csr = _ragged(seed=8)
    x, v = _inputs(csr, 3, 8, seed=9)
    plan = spmm_plan(csr, values="call", device="cpu")
    want = plan(torch.as_tensor(x), values=torch.as_tensor(v))
    col = spmm_plan(csr, values="call", operand_layout="col", device="cpu")
    assert col.call_values
    assert torch.equal(col(torch.as_tensor(x).T, values=torch.as_tensor(v)), want)
    both = sum_plan([plan, plan])
    got = both(torch.as_tensor(x), values=torch.as_tensor(v))
    assert torch.allclose(got, 2 * want)
    assert torch.equal(run(plan, torch.as_tensor(x), plain=True,
                           values=torch.as_tensor(v)), want)


def test_call_values_counter():
    csr = _simple(n=300)
    plan = spmm_plan(csr, values="call", device="cpu")
    x, v = _inputs(csr, 3, 4)
    profiling.take()
    prev = profiling.enable(True)
    try:
        plan(torch.as_tensor(x), values=torch.as_tensor(v))
        plan(torch.as_tensor(x[:, :4]), values=torch.as_tensor(v[0]))
        taken = profiling.take()
    finally:
        profiling.enable(prev)
    c = taken["counts"]
    assert c["sdb.call_values/csr_ell"] == 4 * csr.nnz
    assert c["sdb.nnz/csr_ell"] == 2 * csr.nnz
    assert [s.name for s in taken["spans"]] == ["sdb.csr_ell"] * 2


def test_gat_pattern_hand_counted():
    """Edges 0->1 twice, 1->0, 1->2, 2->2 and 3->1 on 5 nodes: the
    bidirected simple graph is {0-1, 1-2, 1-3}, six directed entries,
    then one self-loop on each of the 5 nodes (2's own removed first):
    11 entries, node 4 a self-loop alone."""
    edges = np.array([[0, 1], [0, 1], [1, 0], [1, 2], [2, 2], [3, 1]])
    p = gat_pattern(CSR.from_edges(edges, 5))
    assert p.data is None and p.nnz == 11
    assert np.array_equal(p.indptr, [0, 2, 6, 8, 10, 11])
    assert np.array_equal(p.indices, [0, 1, 0, 1, 2, 3, 1, 2, 1, 3, 4])


def _gat_f64(csr: CSR, params, x: np.ndarray) -> np.ndarray:
    """The GAT in float64, densely: per head a masked (n, n) score matrix,
    its rows' softmax, then alpha @ hw, plus h @ res where a layer has a
    residual; ELU between layers, the last layer's heads averaged."""
    mask = csr.to_scipy().toarray() > 0
    h = x.astype(np.float64)
    for i, p in enumerate(params):
        w, a_src, a_dst = (p[k].double().numpy() for k in ("w", "a_src", "a_dst"))
        H, d = a_src.shape
        hw = (h @ w).reshape(-1, H, d)
        outs = []
        for k in range(H):
            e = (hw[:, k] @ a_src[k])[:, None] + (hw[:, k] @ a_dst[k])[None, :]
            e = np.where(e > 0, e, 0.2 * e)
            e = np.where(mask, e, -np.inf)
            e = np.exp(e - e.max(1, keepdims=True))
            outs.append((e / e.sum(1, keepdims=True)) @ hw[:, k])
        out = np.stack(outs, 1)
        if "res" in p:
            out = out + (h @ p["res"].double().numpy()).reshape(-1, H, d)
        last = i == len(params) - 1
        h = out.mean(1) if last else out.reshape(out.shape[0], -1)
        if not last:
            h = np.where(h > 0, h, np.expm1(h))
    return h


def _routes(apply, params, x):
    """(the answer of a call that needs no gradient, of one whose weights
    need one, the csr_ell plan calls of each), from apply."""
    answers, calls = [], []
    for grad in (False, True):
        profiling.take()
        prev = profiling.enable(True)
        try:
            with torch.set_grad_enabled(grad):
                ps = [{k: t.detach().requires_grad_(grad) for k, t in p.items()}
                      for p in params]
                answers.append(apply(ps, x).detach())
            taken = profiling.take()
        finally:
            profiling.enable(prev)
        calls.append([s.name for s in taken["spans"]].count("sdb.csr_ell"))
    return answers[0], answers[1], calls


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("heads", [1, 3])
def test_gat_plan_route_matches_float64(heads, residual):
    """make_gat_apply at the source's per-head widths of 250, then 40, on
    a small attention pattern: a call that needs no gradient runs the
    plan (one csr_ell call a layer), one whose weights need a gradient
    the segment route (none), each within 1e-5 of the dense float64 GAT,
    with and without the residual projection."""
    csr = _simple(seed=10, n=60)
    params = M.init_gat([16, 250, 40], heads, torch.Generator().manual_seed(3),
                        residual=residual)
    assert ("res" in params[0]) == residual
    x = np.random.default_rng(11).standard_normal((60, 16)).astype(np.float32)
    apply = M.make_gat_apply(csr, heads, device="cpu")
    assert apply.plan.call_values
    got, seg, calls = _routes(apply, params, x)
    want = _gat_f64(csr, params, x)
    assert got.shape == (60, 40) and calls == [2, 0]
    assert _rel(got, want) < TOL and _rel(seg, want) < TOL


def test_gat_plan_route_spans_and_refusals():
    """Both routes open sdb.gat_scores once a layer; the plan route adds
    nnz x heads a layer to sdb.call_values/csr_ell; a tier that takes no
    call values is refused when the GAT is prepared."""
    csr = _simple(seed=12, n=80)
    params = M.init_gat([8, 16, 4], 2, torch.Generator().manual_seed(4))
    apply = M.make_gat_apply(csr, 2, device="cpu", impl="auto")
    for grad, ell_calls, values in ((False, 2, 2 * 2 * csr.nnz), (True, 0, None)):
        profiling.take()
        prev = profiling.enable(True)
        try:
            with torch.set_grad_enabled(grad):
                apply(params, torch.ones(80, 8, requires_grad=grad))
            taken = profiling.take()
        finally:
            profiling.enable(prev)
        names = [s.name for s in taken["spans"]]
        assert names.count("sdb.gat_scores") == 2
        assert names.count("sdb.csr_ell") == ell_calls
        assert taken["counts"].get("sdb.call_values/csr_ell") == values
    with pytest.raises(ValueError, match="csr_ell"):
        M.make_gat_apply(csr, 2, device="cpu", impl="csr_pallas")


def test_gat_plan_route_reduces_hub_rows_in_pieces():
    """A hub row of 700 entries (three pieces of ROW_PIECE = 256 for the
    row reductions), some of them duplicates, and an empty row: the plan
    route within 1e-5 of the segment route, the empty row 0 on both."""
    from spmm_denseblock_tpu_torch.models.gat import ROW_PIECE

    n = 800
    base = _simple(seed=13, n=n)
    rows, cols = base.row_ids().astype(np.int64), np.asarray(base.indices, np.int64)
    keep = rows != 3
    rows = np.concatenate([rows[keep], np.zeros(700, np.int64)])
    cols = np.concatenate([cols[keep], np.arange(100, 800)])
    csr = CSR.from_coo(rows, cols, None, (n, n))
    assert csr.degrees()[0] > 2 * ROW_PIECE and csr.degrees()[3] == 0
    params = M.init_gat([8, 12, 5], 3, torch.Generator().manual_seed(6))
    x = np.random.default_rng(14).standard_normal((n, 8)).astype(np.float32)
    apply = M.make_gat_apply(csr, 3, device="cpu")
    assert apply.row_pieces[0] == 3 and apply.row_pieces[3] == 1
    got, seg, calls = _routes(apply, params, x)
    assert calls == [2, 0] and _rel(got, seg) < TOL
    assert not got[3].any() and not seg[3].any()
