"""The scored branch of "auto" prices its candidates by the plan it will
build (ops/dispatch.route_pricing): a plan on the card with an f32
operand by the f32 kernels (the ELL kernel's stored entries, K1's walked
slots with its covering zero blocks, the hybrid's pad and sum), every
other plan (the CPU, bf16, int8) by the JAX package's padded slots,
whose route and threshold are then JAX's. No card is needed: the
router's _auto_impl prices a device it is given without using it, and
spmm_plan's planners are recorders."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmm_denseblock_tpu.formats.csr as j_csr
import spmm_denseblock_tpu_torch.formats.csr as t_csr
from spmm_denseblock_tpu_torch.formats.bsr import BSR
from spmm_denseblock_tpu_torch.formats.hybrid import Hybrid
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas import (
    bsr_spmm_pallas_plan,
    f32_walk,
)
from spmm_denseblock_tpu_torch.utils import profiling

JD = importlib.import_module("spmm_denseblock_tpu.ops.dispatch")
TD = importlib.import_module("spmm_denseblock_tpu_torch.ops.dispatch")

torch.set_num_threads(2)


def _graph(n, fill, block_rows, seed):
    """Both packages' CSR of an n-node graph: a random tail of ~8
    nonzeros a row plus diagonal 128-blocks at `block_rows`, each
    holding `fill` of its 16,384 entries."""
    rng = np.random.default_rng(seed)
    tail = rng.integers(0, n, (8 * n, 2))
    k = int(fill * 128 * 128)
    pos = np.stack([rng.choice(128 * 128, k, replace=False) for _ in block_rows])
    br = np.asarray(block_rows, np.int64)[:, None] * 128
    rows = np.concatenate([tail[:, 0], (br + pos // 128).ravel()])
    cols = np.concatenate([tail[:, 1], (br + pos % 128).ravel()])
    vals = rng.random(rows.size).astype(np.float32)
    return (j_csr.CSR.from_coo(rows, cols, vals, (n, n)),
            t_csr.CSR.from_coo(rows, cols, vals, (n, n)))


# arxiv-like: 240 blocks 10% full among 313 block-rows (K1 would walk the
# other 73 rows' covering zero blocks too); full: a full 128-block on every
# block-row of 48, under a budget that sends the router to its scorer
GRAPHS = {
    "arxiv_like": (lambda: _graph(40_000, 0.10, range(240), 5), None),
    "full_blocks": (lambda: _graph(48 * 128, 1.0, range(48), 6), 1 << 26),
}
_cache = {}


def graph(name):
    if name not in _cache:
        _cache[name] = GRAPHS[name][0]()
    return _cache[name]


def _jax_route(monkeypatch, jm, dtype, budget):
    """JAX's "auto" on jm: (impl, matrix) as its planner received them."""
    calls = []
    for name in list(JD.PLANNERS):
        monkeypatch.setitem(JD.PLANNERS, name,
                            lambda m, _n=name, **kw: calls.append((_n, m)))
    kw = {} if budget is None else {"bsr_bytes_budget": budget}
    jdt = {None: None, torch.bfloat16: jnp.bfloat16, torch.int8: jnp.int8}[dtype]
    if jdt is not None:
        kw["dtype"] = jdt
    JD.spmm_plan(jm, impl="auto", block_size=128, feat_dim=128, **kw)
    return calls[0]


@pytest.mark.parametrize("name,device,dtype,pricing,want", [
    ("arxiv_like", "cuda", None, "kernel", "csr_ell"),
    ("arxiv_like", "cuda", torch.float32, "kernel", "csr_ell"),
    ("arxiv_like", "cpu", None, "padded", "hybrid"),
    ("arxiv_like", "cuda", torch.bfloat16, "padded", "hybrid"),
    ("arxiv_like", "cuda", torch.int8, "padded", "hybrid"),
    ("full_blocks", "cuda", None, "kernel", "hybrid"),
    ("full_blocks", "cpu", None, "padded", "hybrid"),
])
def test_route_pricing(name, device, dtype, pricing, want, monkeypatch):
    """Kernel pricing routes a graph of 10%-full blocks to csr_ell where
    padded pricing builds a hybrid, and still builds a hybrid on full
    blocks; a padded route and its threshold are JAX's, bit for bit."""
    jm, tm = graph(name)
    budget = GRAPHS[name][1]
    assert TD.route_pricing(torch.device(device), dtype) == pricing
    kw = {"device": device, "dtype": dtype}
    if budget is not None:
        kw["bsr_bytes_budget"] = budget
    impl, mat, report, thr = TD._auto_impl(tm, 128, 128, kw)
    assert impl == want
    assert report is not None and all(r["score"] is not None for r in report)
    priced = "walked_slots" if pricing == "kernel" else "padded_slots"
    assert all(priced in r for r in report)
    if want == "hybrid":
        assert isinstance(mat, Hybrid) and mat.dense.nnzb > 0 and thr is not None
    else:
        assert mat is tm and thr is None
    if pricing == "padded":
        jn, jmat = _jax_route(monkeypatch, jm, dtype, budget)
        assert jn == (TD._INT8_VARIANT[impl] if dtype is torch.int8 else impl)
        np.testing.assert_array_equal(mat.dense.block_rows,
                                      np.asarray(jmat.dense.block_rows)[:jmat.dense.nnzb])
        np.testing.assert_array_equal(mat.remainder.indices,
                                      np.asarray(jmat.remainder.indices))
    else:  # the pick is the cheapest candidate by the kernels' ns
        costs = TD._route_costs(report, thr)
        assert costs["cost"] == min(r["score"] for r in report)
        assert costs["runner_up_cost"] >= costs["cost"]


@pytest.mark.parametrize("device,pricing", [("cpu", "padded"), ("cuda", "kernel")])
def test_route_span_carries_pricing(device, pricing, monkeypatch):
    """sdb.route holds the pricing and the scorer's predicted costs of its
    pick and of the runner-up (ns or padded slots) beside impl and
    threshold; spmm_plan's device decides (a CUDA device stands in here)."""
    _, tm = graph("arxiv_like")
    monkeypatch.setattr(TD, "resolve_device", torch.device)
    for n in list(TD.PLANNERS):
        monkeypatch.setitem(TD.PLANNERS, n, lambda m, **kw: None)
    prev = profiling.enable(True)
    try:
        profiling.take()
        TD.spmm_plan(tm, impl="auto", feat_dim=128, grad=False, device=device)
        (route,) = [s for s in profiling.take()["spans"] if s.name == "sdb.route"]
    finally:
        profiling.enable(prev)
    assert set(route.attrs) == {"impl", "threshold", "pricing", "cost", "runner_up_cost"}
    assert route.attrs["pricing"] == pricing
    assert route.attrs["impl"] == ("csr_ell" if pricing == "kernel" else "hybrid")
    assert 0 < route.attrs["cost"] and 0 < route.attrs["runner_up_cost"]


@pytest.mark.parametrize("nbr,nblk,b,layout", [
    (50, 10, 8, "flat"), (50, 120, 8, "flat"), (50, 300, 8, "flat"),
    (50, 500, 8, "sorted"), (37, 400, 4, "sorted"), (300, 2600, 4, "sorted"),
])
def test_f32_walk_matches_the_plan(nbr, nblk, b, layout):
    """The scorer's count of the slots an f32 plan walks (covering zero
    blocks and group pads included) and of its deepest lane equal the
    positions / b² and the depth of the plan that bsr_spmm_pallas_plan
    builds, in K1's flat layout and K2's sorted one."""
    rng = np.random.default_rng(nbr + nblk)
    keys = np.sort(rng.choice(nbr * nbr, nblk, replace=False))
    rows, cols = keys // nbr, keys % nbr
    blocks = rng.random((nblk, b, b)).astype(np.float32)
    bsr = BSR.from_parts(rows.astype(np.int32), cols.astype(np.int32), blocks,
                         (nbr * b - 3, nbr * b), b)
    plan = bsr_spmm_pallas_plan(bsr, grad=False, device="cpu")
    assert plan.statics[0] == layout
    walked, depth = f32_walk(rows, bsr.n_block_rows)
    assert (walked * b * b, depth) == (plan.positions, plan.statics[6])
