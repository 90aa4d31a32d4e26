"""Training through the BSR plan, JAX package against the port, on the
CPU: grad_plan gradients against jax.grad through
bsr_spmm_pallas_plan(grad=True) (the JAX side runs its Pallas kernels in
interpret mode, as its own tests do; the port runs the kernels' plain
versions), the loss and metrics, make_train_step with SGD and Adam,
transb_plan, and the entry point.

The gradient cases use a rectangular, non-symmetric BSR (6 x 16 block
grid) with empty block-rows and block-columns, so Aᵀ is another matrix
with other empty rows, and its occupancy picks another layout than A's:
the forward plan sorts (>= 8 real blocks per block-row) and the backward
plan packs flat or row groups.

Tolerances: 1e-5 relative to max |want| for every plan output and
gradient against JAX (the same packed arrays, the same bf16 roundings
and splits, so only the order of the f32 sums differs), and for the
training steps' losses and weights. Adam's first update is about
lr * sign(g), and a gradient that is zero up to rounding may flip sign
between the two packages, so after an Adam step the test holds the loss
and the gradients, not the updated weights; multi-step weight parity is
held with SGD."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import spmm_denseblock_tpu.formats.bsr as j_bsr
import spmm_denseblock_tpu.formats.csr as j_csr
import spmm_denseblock_tpu.models as j_models
import spmm_denseblock_tpu.ops as j_ops
import spmm_denseblock_tpu.ops.plan as j_plan
import spmm_denseblock_tpu_torch.formats.bsr as t_bsr
import spmm_denseblock_tpu_torch.formats.csr as t_csr
import spmm_denseblock_tpu_torch.models as t_models
import spmm_denseblock_tpu_torch.ops as t_ops
from spmm_denseblock_tpu.models.train import (
    make_train_step as j_make_train_step,
)
from spmm_denseblock_tpu_torch.ops import _kernels, assert_allclose

J = importlib.import_module("spmm_denseblock_tpu.ops.bsr_spmm_pallas")
T = importlib.import_module("spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas")

torch.set_num_threads(2)

TOL = 1e-5
B = 8


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _rect_parts(depth, seed):
    """(rows, cols, blocks, shape, b) of a 6 x 16 block grid, logical
    shape ragged (45 x 125): block-rows 1 and 4 and block-columns 4 and
    11 empty, the other four rows `depth` blocks deep."""
    rng = np.random.default_rng(seed)
    live_cols = np.setdiff1d(np.arange(16), [4, 11])
    rows, cols = [], []
    for r in (0, 2, 3, 5):
        c = np.sort(rng.choice(live_cols, depth, replace=False))
        rows += [r] * depth
        cols += list(c)
    blocks = rng.standard_normal((len(rows), B, B)).astype(np.float32)
    return (np.array(rows, np.int32), np.array(cols, np.int32), blocks,
            (6 * B - 3, 16 * B - 3), B)


# name: (plan kwargs, A's depth, (forward layout, backward layout), math)
GRAD_CASES = {
    "f32": ({}, 13, ("sorted", "flat"), "exact"),
    "f32_depth_sort_off": ({"depth_sort": False}, 13, ("flat", "flat"), "exact"),
    "high": ({"precision": "high"}, 13, ("sorted", "flat"), "bf16x3"),
    "resident": ({"resident": True}, 13, ("sorted", "resident"), "exact"),
    "resident_high": ({"resident": True, "precision": "high", "depth_sort": False},
                      13, ("resident", "resident"), "bf16x3"),
    "bf16": ({"dtype": "bfloat16"}, 6, ("sorted", "rowgroup"), "exact"),
    "bf16_high": ({"dtype": "bfloat16", "precision": "high"}, 6,
                  ("flat", "flat"), "exact"),
    "bf16_resident_high": ({"dtype": "bfloat16", "resident": True,
                            "precision": "high"}, 6,
                           ("resident", "resident"), "exact"),
}


def _plans(kw, parts):
    jkw, tkw = dict(kw), dict(kw)
    if "dtype" in kw:
        jkw["dtype"] = jnp.bfloat16
        tkw["dtype"] = torch.bfloat16
    jp = J.bsr_spmm_pallas_plan(j_bsr.BSR.from_parts(*parts), grad=True, **jkw)
    tp = T.bsr_spmm_pallas_plan(t_bsr.BSR.from_parts(*parts), **tkw, device="cpu")
    return jp, tp


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_grad_plan_matches_jax(case):
    """The default plan is a grad plan of A's and Aᵀ's plans; its output
    and the gradient of <C, G> match jax.grad through the JAX plan."""
    kw, depth, layouts, math = GRAD_CASES[case]
    parts = _rect_parts(depth, seed=depth)
    jp, tp = _plans(kw, parts)
    fwd, bwd = tp.arrays
    assert (fwd.statics[0], bwd.statics[0]) == layouts
    assert fwd.statics[5] == bwd.statics[5] == math
    assert fwd.statics[2:4] == bwd.statics[2:4][::-1] == (45, 125)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((125, 24)).astype(np.float32)
    g = rng.standard_normal((45, 24)).astype(np.float32)

    jout, jvjp = jax.vjp(jp, jnp.asarray(x))
    (jgrad,) = jvjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    out = tp(xt)
    out.backward(torch.as_tensor(g))
    assert out.shape == (45, 24) and xt.grad.shape == (125, 24)
    assert xt.grad.dtype == torch.float32
    assert _rel(out.detach().numpy(), jout) < TOL
    assert _rel(xt.grad.numpy(), jgrad) < TOL
    # an oracle grade on the dense matrix: exact for f32, bf16 and
    # bf16x3 grades otherwise
    a = t_bsr.BSR.from_parts(*parts).to_dense().astype(np.float64)
    grade = 1e-4 if math == "exact" and "dtype" not in kw else 3e-2
    assert _rel(xt.grad.numpy(), a.T @ g) < grade


def test_grad_plan_backward_matches_plain_autograd():
    """The grad plan's backward (Aᵀ's plan) against autograd through a
    plain forward (a dense A in torch); plain_apply runs both directions
    plain and gives the same gradient; plan buffers get no gradient."""
    parts = _rect_parts(13, seed=2)
    plan = T.bsr_spmm_pallas_plan(t_bsr.BSR.from_parts(*parts), device="cpu")
    a = torch.as_tensor(t_bsr.BSR.from_parts(*parts).to_dense())
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((125, 10)).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((45, 10)).astype(np.float32))

    def grad_of(fn):
        xr = x.clone().requires_grad_(True)
        (torch.tanh(fn(xr)) * w).sum().backward()
        return xr.grad

    want = grad_of(lambda v: a @ v)
    got = grad_of(plan)
    assert_allclose(got, want.numpy())
    assert torch.equal(grad_of(lambda v: T.plain_apply(plan, v)), got)
    assert all(not t.requires_grad for t in plan.buffers())
    # a numpy operand is accepted and needs no gradient
    assert_allclose(plan(x.numpy()), (a @ x).numpy())
    # the CPU path launched no kernel
    assert all(k.launches == 0 for k in _kernels.KERNELS)


def test_grad_plan_non_contiguous_cotangent():
    """Autograd may hand the backward a strided cotangent (here the
    gradient of a column slice); the apply makes it contiguous."""
    parts = _rect_parts(13, seed=4)
    plan = T.bsr_spmm_pallas_plan(t_bsr.BSR.from_parts(*parts), device="cpu")
    a = t_bsr.BSR.from_parts(*parts).to_dense()
    x = torch.randn(125, 12, generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    plan(x)[:, ::3].sum().backward()
    g = np.zeros((45, 12), np.float32)
    g[:, ::3] = 1.0
    assert_allclose(x.grad, a.T @ g)


def test_transb_plan():
    """transb_plan takes Bᵀ (F, K): the same C as the inner plan, in both
    packages, and gradients flow back as the transposed gradient."""
    parts = _rect_parts(13, seed=5)
    inner_t = T.bsr_spmm_pallas_plan(t_bsr.BSR.from_parts(*parts), device="cpu")
    inner_j = J.bsr_spmm_pallas_plan(j_bsr.BSR.from_parts(*parts), grad=True)
    x = np.random.default_rng(6).standard_normal((125, 9)).astype(np.float32)
    tp = t_ops.transb_plan(inner_t)
    jp = j_plan.transb_plan(inner_j)
    want = np.asarray(jp(x.T))
    got = tp(x.T)
    assert got.shape == (45, 9)
    assert torch.equal(got, inner_t(x))
    assert _rel(got.numpy(), want) < TOL
    xt = torch.tensor(x.T.copy(), requires_grad=True)
    tp(xt).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(jp(v)))(jnp.asarray(x.T))
    assert xt.grad.shape == (9, 125)
    assert _rel(xt.grad.numpy(), jg) < TOL
    assert torch.equal(T.plain_apply(tp, x.T), got)


def _logits_case(seed, n=50, c=7):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((n, c))).astype(np.float32)
    labels = rng.integers(0, c, size=n).astype(np.int32)
    mask = (rng.random(n) < 0.6).astype(np.float32)
    return logits, labels, mask


@pytest.mark.parametrize("mask_kind", ["split", "zero", "weighted"])
def test_loss_and_accuracy_match_jax(mask_kind):
    """Mean over mask weights with max(sum(w), 1): an all-zero mask gives
    0, not NaN; fractional weights count as weights."""
    logits, labels, mask = _logits_case(7)
    if mask_kind == "zero":
        mask = np.zeros_like(mask)
    elif mask_kind == "weighted":
        mask = mask * np.linspace(0.1, 0.9, mask.size, dtype=np.float32)
    from spmm_denseblock_tpu.models.train import accuracy, masked_cross_entropy

    args = [torch.as_tensor(a) for a in (logits, labels, mask)]
    for jfn, tfn in ((masked_cross_entropy, t_models.masked_cross_entropy),
                     (accuracy, t_models.accuracy)):
        want = float(jfn(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask)))
        got = tfn(*args)
        assert got.shape == () and torch.isfinite(got)
        assert abs(float(got) - want) <= TOL * max(abs(want), 1.0)


def _graph_pair():
    """A random graph of 256 nodes with self-loops, normalised, both
    packages; b=32: 8 x 8 blocks, most of them occupied."""
    j_adj = j_models.sym_norm_adjacency(j_csr.random_csr(0.05, 256, seed=3))
    t_adj = t_models.sym_norm_adjacency(t_csr.random_csr(0.05, 256, seed=3))
    np.testing.assert_array_equal(np.asarray(j_adj.data), t_adj.data)
    return j_adj, t_adj


DIMS = [16, 32, 5]


def _problem(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, DIMS[0])).astype(np.float32)
    y = rng.integers(0, DIMS[-1], size=n).astype(np.int32)
    mask = (rng.random(n) < 0.6).astype(np.float32)
    return x, y, mask


def _jax_params():
    params = j_models.init_gcn(jax.random.PRNGKey(0), DIMS)
    return params, [{k: np.asarray(v) for k, v in p.items()} for p in params]


def test_sgd_steps_match_jax():
    """3 SGD steps of make_train_step (optax.sgd <-> torch.optim.SGD)
    from the same weights: losses, accuracies and weights agree."""
    j_adj, t_adj = _graph_pair()
    j_spmm = j_ops.spmm_plan(j_adj, impl="bsr_pallas", block_size=32)
    t_spmm = t_ops.spmm_plan(t_adj, impl="bsr_pallas", block_size=32, device="cpu")
    x, y, mask = _problem(256)
    j_params, j_np = _jax_params()
    j_step, j_init = j_make_train_step(j_models.gcn_apply, j_spmm, optax.sgd(0.5))
    t_step, t_init = t_models.make_train_step(
        t_models.gcn_apply, t_spmm, functools.partial(torch.optim.SGD, lr=0.5))
    t_params = t_models.gcn_params_from_jax(j_np)
    j_state, t_state = j_init(j_params), t_init(t_params)
    for _ in range(3):
        j_params, j_state, jm = j_step(j_params, j_state, x, y, mask)
        t_params, t_state, tm = t_step(t_params, t_state, x, y, mask)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL * float(jm["loss"])
        assert float(tm["acc"]) == pytest.approx(float(jm["acc"]), abs=1e-6)
    for jp_, tp_ in zip(j_params, t_params):
        for k in ("w", "b"):
            assert _rel(tp_[k].detach().numpy(), jp_[k]) < TOL


def test_adam_step_matches_jax():
    """One Adam step: the loss and every parameter's gradient agree;
    the loss after the step is lower in both."""
    j_adj, t_adj = _graph_pair()
    j_spmm = j_ops.spmm_plan(j_adj, impl="bsr_pallas", block_size=32)
    t_spmm = t_ops.spmm_plan(t_adj, impl="bsr_pallas", block_size=32, device="cpu")
    x, y, mask = _problem(256, seed=1)
    j_params, j_np = _jax_params()
    from spmm_denseblock_tpu.models.train import masked_cross_entropy

    j_loss, j_grads = jax.value_and_grad(
        lambda p: masked_cross_entropy(j_models.gcn_apply(p, j_spmm, x), y, mask)
    )(j_params)
    t_step, t_init = t_models.make_train_step(
        t_models.gcn_apply, t_spmm, functools.partial(torch.optim.Adam, lr=1e-2))
    t_params = t_models.gcn_params_from_jax(j_np)
    t_state = t_init(t_params)
    t_params, t_state, tm = t_step(t_params, t_state, x, y, mask)
    assert abs(float(tm["loss"]) - float(j_loss)) <= TOL * float(j_loss)
    for jg, tp_ in zip(j_grads, t_params):
        for k in ("w", "b"):
            assert _rel(tp_[k].grad.numpy(), jg[k]) < TOL
    evaluate = t_models.make_eval_step(t_models.gcn_apply, t_spmm)
    after = evaluate(t_params, x, y, mask)
    assert float(after["loss"]) < float(tm["loss"])


def test_default_spmm_plan_trains_gcn():
    """spmm_plan(adj, impl="bsr_pallas") with no grad= is a grad plan: a
    GCN trains through it, and the eval step's metrics match a plain
    forward."""
    _, t_adj = _graph_pair()
    spmm = t_ops.spmm_plan(t_adj, impl="bsr_pallas", block_size=32, device="cpu")
    assert spmm.apply_fn.__name__ == "_grad_apply"
    x, y, mask = _problem(256, seed=2)
    params = t_models.init_gcn(DIMS, generator=torch.Generator().manual_seed(0))
    step, init = t_models.make_train_step(
        t_models.gcn_apply, spmm, functools.partial(torch.optim.Adam, lr=1e-2))
    state = init(params)
    losses = []
    for _ in range(5):
        params, state, m = step(params, state, x, y, mask)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    evaluate = t_models.make_eval_step(t_models.gcn_apply, spmm)
    with torch.no_grad():
        logits = t_models.gcn_apply(
            params, lambda h: T.plain_apply(spmm, h), torch.as_tensor(x))
    got = evaluate(params, x, y, mask)
    want = t_models.masked_cross_entropy(logits, torch.as_tensor(y),
                                         torch.as_tensor(mask))
    assert float(got["loss"]) == pytest.approx(float(want), rel=TOL)


def test_entry_matches_graft_entry(monkeypatch):
    """The port's entry() and __graft_entry__.entry(): same graph, same
    plan arguments; with the JAX weights the forwards agree. The JAX
    entry's compilation cache (a directory outside the checkout) is
    kept off."""
    import __graft_entry__ as graft
    from spmm_denseblock_tpu_torch.entry import entry

    monkeypatch.setattr(graft, "_enable_compile_cache", lambda jax_mod: None)
    j_fn, (j_params, j_x) = graft.entry()
    t_fn, (t_params, t_x) = entry(device="cpu")
    np.testing.assert_array_equal(j_x, t_x)
    assert [tuple(p["w"].shape) for p in t_params] == [
        tuple(np.shape(p["w"])) for p in j_params]
    want = np.asarray(j_fn(j_params, j_x))
    j_np = [{k: np.asarray(v) for k, v in p.items()} for p in j_params]
    got = t_fn(t_models.gcn_params_from_jax(j_np), t_x)
    assert got.shape == (512, 16)
    assert_allclose(got.detach(), want)
