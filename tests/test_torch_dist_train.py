"""The port's distributed training step (parallel/train.py) held to the
JAX package's: GCN on (4, 1) with allgather, ring and halo (a banded
graph, given as a BSR) and on (2, 2) with the feature axis, SAGE and GIN
on (2, 2), the hybrid adjacency on (4, 1) and (2, 2), and the step
against the port's single-card bsr_xla step (JAX's
test_dist_matches_single_chip). One world of 4 CPU ranks over gloo runs
every case from the JAX init's weights (module fixture); the JAX side
runs make_dist_train_step on a mesh of the same shape over 4 of
conftest's 8 CPU devices, and jax.grad on the single-chip model for the
step-0 gradients. The same world checks the backward pass of every
exchange (parallel/exchange.py) against its closed form.

Tolerances: losses within rtol 1e-4 and atol 1e-5 of JAX's (JAX's own
bound, tests/test_models.py:117) and equal on every rank; step-0
gradients of every leaf within 1e-5 of JAX's (max |err| / max |ref|);
parameters after 3 steps within 1e-4 of JAX's (the same measure); the
exchanges' gradients within 1e-6 of their closed forms."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spmm_denseblock_tpu.convert.csr2bsr import csr_to_bsr
from spmm_denseblock_tpu.convert.divide import divide
from spmm_denseblock_tpu.formats.csr import CSR
from spmm_denseblock_tpu.models import MODELS as JMODELS
from spmm_denseblock_tpu.models import sym_norm_adjacency
from spmm_denseblock_tpu.models.train import masked_cross_entropy
from spmm_denseblock_tpu.ops import spmm_plan as jax_spmm_plan
from spmm_denseblock_tpu.parallel import make_mesh as jax_make_mesh
from spmm_denseblock_tpu.parallel.train import make_dist_train_step as jax_dist_step
from spmm_denseblock_tpu.parallel.train import random_problem as jax_random_problem
from spmm_denseblock_tpu_torch.models import MODELS, make_train_step, params_from_jax
from spmm_denseblock_tpu_torch.models.checkpoint import tree_leaves
from spmm_denseblock_tpu_torch.ops import spmm_plan
from spmm_denseblock_tpu_torch.parallel.train import random_problem
from torch_parallel_cases import port_bsr, port_csr, port_hybrid

torch.set_num_threads(1)

LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
GRAD_TOL = 1e-5
PARAM_TOL = 1e-4
MESH = {"4x1": (4, 1), "2x2": (2, 2)}


def banded_adjacency(n: int = 256, w: int = 2) -> CSR:
    """sym_norm_adjacency of a band of half-width w: at b = 16 over 4
    stripes every block lies within one stripe of its own (halo)."""
    rows = np.repeat(np.arange(n), 2 * w + 1)
    cols = rows + np.tile(np.arange(-w, w + 1), n)
    keep = (cols >= 0) & (cols < n)
    return sym_norm_adjacency(CSR.from_coo(rows[keep], cols[keep], None, (n, n)))


def _case(name, model, mesh, jadj, problem, dims, seed, **kw):
    """jadj: the JAX adjacency the step takes (CSR, BSR or Hybrid); the
    problem's CSR gives the single-chip gradients."""
    csr, x, y, mask = problem
    port = {"CSR": port_csr, "BSR": port_bsr, "Hybrid": port_hybrid}[type(jadj).__name__]
    init = JMODELS[model][0](jax.random.PRNGKey(seed), dims)
    return {"name": name, "model": model, "mesh": mesh, "dims": dims, "seed": seed,
            "jadj": jadj, "csr": csr, "adj": port(jadj), "x": x, "y": y, "mask": mask,
            "params": jax.tree.map(np.asarray, init), **kw}


def _cases():
    p128 = jax_random_problem(128, [8, 16, 4], p=0.05, seed=3)
    p96 = jax_random_problem(96, [8, 12, 3], p=0.06, seed=4)
    p96b = jax_random_problem(96, [8, 12, 4], p=0.06, seed=11)
    band = banded_adjacency()
    rng = np.random.default_rng(5)
    pband = (band, rng.standard_normal((256, 8)).astype(np.float32),
             rng.integers(0, 4, 256).astype(np.int32),
             (rng.random(256) < 0.7).astype(np.float32))
    hyb = divide(p128[0], 16, 0.05)
    assert hyb.dense.nnzb > 0 and hyb.remainder.nnz > 0
    return [
        _case("gcn_allgather_4x1", "gcn", "4x1", p128[0], p128, [8, 16, 4], 0),
        _case("gcn_ring_4x1", "gcn", "4x1", p128[0], p128, [8, 16, 4], 0,
              strategy="ring"),
        _case("gcn_halo_bsr_4x1", "gcn", "4x1", csr_to_bsr(band, 16), pband,
              [8, 16, 4], 1, strategy="halo"),
        # JAX's test_dist_matches_single_chip problem (its (4, 2) mesh at 4
        # ranks); 3 classes do not divide the col size: the last layer's
        # weight is replicated
        _case("gcn_2x2", "gcn", "2x2", p96[0], p96, [8, 12, 3], 7),
        _case("gcn_ring_bsr_2x2", "gcn", "2x2", csr_to_bsr(p96[0], 16), p96,
              [8, 12, 3], 7, strategy="ring"),
        _case("sage_2x2", "sage", "2x2", p96b[0], p96b, [8, 12, 4], 2),
        _case("gin_2x2", "gin", "2x2", p96b[0], p96b, [8, 12, 4], 2),
        _case("hybrid_4x1", "gcn", "4x1", hyb, p128, [8, 16, 4], 0),
        _case("hybrid_2x2", "gcn", "2x2", hyb, p128, [8, 16, 4], 0),
        # LPT balancing (the 96-node graphs' stripes over 4 row ranks): the
        # output rows are permuted, the step redistributes them
        _case("gcn_lpt_4x1", "gcn", "4x1", p96[0], p96, [8, 12, 3], 7),
        _case("hybrid_lpt_ring_4x1", "gcn", "4x1", divide(p96[0], 16, 0.05), p96,
              [8, 12, 3], 7, strategy="ring"),
    ]


CASES = {c["name"]: c for c in _cases()}


@pytest.fixture(scope="module")
def results():
    from spmm_denseblock_tpu_torch.parallel.world import run_world
    from torch_parallel_cases import run_train_cases

    keep = ("name", "model", "mesh", "dims", "adj", "x", "y", "mask", "params",
            "strategy")
    cases = [{k: v for k, v in c.items() if k in keep} for c in CASES.values()]
    per_rank = run_world(run_train_cases, 4, args=(cases,), timeout_s=240.0)
    return per_rank[0], per_rank[1:]


def _jax_run(case):
    """JAX's distributed step from the same weights (its init at the same
    seed): 3 losses and the whole parameters after them; and the step-0
    gradients of the single-chip model (csr_xla on the problem's CSR)."""
    kw = {k: case[k] for k in ("strategy",) if k in case}
    mesh = jax_make_mesh(MESH[case["mesh"]], devices=jax.devices()[:4])
    params, opt, step = jax_dist_step(case["jadj"], mesh, case["dims"],
                                      model=case["model"], block_size=16,
                                      seed=case["seed"], **kw)
    losses = []
    for _ in range(3):
        params, opt, m = step(params, opt, case["x"], case["y"], case["mask"])
        losses.append(float(m["loss"]))
    params3 = [np.asarray(t) for t in jax.tree.leaves(params)]
    spmm = jax_spmm_plan(case["csr"], impl="csr_xla")
    apply = JMODELS[case["model"]][1]
    init = jax.tree.map(jnp.asarray, case["params"])
    grads = jax.grad(lambda p: masked_cross_entropy(
        apply(p, spmm, case["x"]), case["y"], case["mask"]))(init)
    return losses, params3, [np.asarray(g) for g in jax.tree.leaves(grads)]


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("name", list(CASES))
def test_dist_train_matches_jax(results, name):
    r0, others = results
    res = r0[name]
    assert "error" not in res, res.get("error")
    for o in others:
        assert "error" not in o.get(name, {}), o[name]["error"]
        assert o[name]["losses"] == res["losses"]  # the same loss on every rank
    losses, params3, grads0 = _jax_run(CASES[name])
    np.testing.assert_allclose(res["losses"], losses, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert len(res["grads0"]) == len(grads0) == len(params3) == len(res["params3"])
    for i, (got, want) in enumerate(zip(res["grads0"], grads0)):
        assert got.shape == want.shape
        assert _rel(got, want) < GRAD_TOL, (i, _rel(got, want))
    for i, (got, want) in enumerate(zip(res["params3"], params3)):
        assert _rel(got, want) < PARAM_TOL, (i, _rel(got, want))


def test_layouts_exercised(results):
    """The cases cover both layouts of the activations' rows: LPT
    balancing's redistribution and the chained stripes."""
    r0, _ = results
    chained = {name: r0[name]["chained"] for name in CASES}
    assert chained["gcn_allgather_4x1"] and chained["gcn_2x2"], chained
    assert not chained["gcn_lpt_4x1"] and not chained["hybrid_lpt_ring_4x1"], chained


def test_dist_matches_single_card(results):
    """The 2D-mesh step tracks the port's single-card bsr_xla step from
    the same weights (JAX's test_dist_matches_single_chip)."""
    case = CASES["gcn_2x2"]
    adj, x, y, mask = random_problem(96, case["dims"], p=0.06, seed=4)
    spmm = spmm_plan(adj, impl="bsr_xla", block_size=16, device="cpu")
    step, init_state = make_train_step(MODELS["gcn"][1], spmm,
                                       functools.partial(torch.optim.Adam, lr=1e-2))
    params = params_from_jax(case["params"])
    state = init_state(params)
    losses = []
    for i in range(3):
        params, state, m = step(params, state, x, y, mask)
        losses.append(float(m["loss"]))
        if i == 0:
            grads0 = [t.grad.numpy().copy() for t in tree_leaves(params)]
    res = results[0]["gcn_2x2"]
    np.testing.assert_allclose(res["losses"], losses, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    for got, want in zip(res["grads0"], grads0):
        assert _rel(got, want) < GRAD_TOL


def test_random_problem_equals_jax():
    for args in ((96, [8, 12, 3], 0.06, 4), (64, [8, 16, 4], 0.1, 0)):
        mine, theirs = random_problem(*args[:2], p=args[2], seed=args[3]), \
            jax_random_problem(*args[:2], p=args[2], seed=args[3])
        for a, b in zip(mine[1:], theirs[1:]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(mine[0].indptr, theirs[0].indptr)
        np.testing.assert_array_equal(mine[0].indices, theirs[0].indices)
        np.testing.assert_array_equal(mine[0].data, theirs[0].data)


@pytest.mark.parametrize("name", ["all_gather_rows", "shift 1", "shift -2", "ring",
                                  "all_reduce_sum", "gather_columns"])
def test_exchange_backward(results, name):
    r0, others = results
    for o in others:
        assert "exchanges" not in o, o["exchanges"]["error"]
    ex = r0["exchanges"]
    assert "error" not in ex, ex.get("error")
    got, want = ex[name]
    assert got.shape == want.shape
    assert _rel(got.numpy(), want.numpy()) < 1e-6
