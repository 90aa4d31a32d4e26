"""Checkpoints, JAX package against the port, on the CPU: a file written
by either package loads into the other bit for bit (parameters in JAX's
leaf order, optax's adam state as torch.optim.Adam's), training resumes
across packages, extensionless paths, SGD, and the optimizers the layout
cannot hold.

Tolerance for the resumed step: the parameters within 1e-6 of JAX's
(absolute: the biases start at 0 and move by about lr a step, so their
own size is no scale; both packages start the step from the same bits,
only the gradient's f32 sums differ)."""

import functools

import jax
import numpy as np
import optax
import pytest
import torch

import spmm_denseblock_tpu.formats.csr as j_csr
import spmm_denseblock_tpu.models as j_models
import spmm_denseblock_tpu.ops as j_ops
import spmm_denseblock_tpu_torch.formats.csr as t_csr
import spmm_denseblock_tpu_torch.models as t_models
import spmm_denseblock_tpu_torch.ops as t_ops
from spmm_denseblock_tpu.models.train import make_train_step as j_make_train_step

torch.set_num_threads(2)

DIMS = [6, 8, 3]
GEN = lambda: torch.Generator().manual_seed(9)  # noqa: E731
INITS = {  # name: (JAX init, port init)
    "gcn": (lambda k: j_models.init_gcn(k, DIMS),
            lambda: t_models.init_gcn(DIMS, GEN())),
    "sage": (lambda k: j_models.init_sage(k, DIMS),
             lambda: t_models.init_sage(DIMS, GEN())),
    "gin": (lambda k: j_models.init_gin(k, DIMS),
            lambda: t_models.init_gin(DIMS, generator=GEN())),
    "classifier": (lambda k: j_models.init_graph_classifier(k, DIMS, 2),
                   lambda: t_models.init_graph_classifier(DIMS, 2, GEN())),
    "gat": (lambda k: j_models.init_gat(k, DIMS, heads=2),
            lambda: t_models.init_gat(DIMS, 2, GEN())),
}


def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def _adam_templates(init):
    params = init()
    leaves = t_models.tree_leaves(params)
    return params, torch.optim.Adam(leaves, lr=1e-2)


@pytest.mark.parametrize("name", list(INITS))
def test_checkpoint_crosses_packages_bit_for_bit(name, tmp_path):
    """JAX saves params and an adam state after two updates; the port
    restores both into its templates bit for bit and saves again; JAX
    restores the port's file and gets its own arrays back."""
    j_init, t_init = INITS[name]
    params = j_init(jax.random.PRNGKey(0))
    opt = optax.adam(1e-2)
    state = opt.init(params)
    for seed in (1, 2):
        grads = jax.tree.map(
            lambda p, s=seed: np.random.default_rng(s).standard_normal(
                np.shape(p)).astype(np.float32), params)
        updates, state = opt.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    j_models.save_checkpoint(str(tmp_path / "jax.npz"), params, state, step=2)

    t_params, t_opt = _adam_templates(t_init)
    got, got_opt, at = t_models.load_checkpoint(str(tmp_path / "jax.npz"),
                                                t_params, t_opt)
    assert at == 2 and got is t_params and got_opt is t_opt
    leaves = t_models.tree_leaves(got)
    adam = state[0]
    for t, j, mu, nu in zip(leaves, jax.tree.leaves(params),
                            jax.tree.leaves(adam.mu), jax.tree.leaves(adam.nu)):
        assert _bits_equal(t.detach().numpy(), j)
        s = t_opt.state[t]
        assert int(s["step"]) == 2
        assert _bits_equal(s["exp_avg"].numpy(), mu)
        assert _bits_equal(s["exp_avg_sq"].numpy(), nu)

    t_models.save_checkpoint(str(tmp_path / "torch.npz"), got, got_opt, step=2)
    back, back_state, at = j_models.load_checkpoint(
        str(tmp_path / "torch.npz"), j_init(jax.random.PRNGKey(5)),
        opt.init(j_init(jax.random.PRNGKey(5))))
    assert at == 2
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        assert _bits_equal(a, b)
    for a, b in zip(jax.tree.leaves(back_state), jax.tree.leaves(state)):
        assert _bits_equal(a, b)


def _problem():
    rng = np.random.default_rng(3)
    n = 48
    path = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    edges = np.concatenate([path, rng.integers(0, n, size=(12, 2))])
    edges = np.concatenate([edges, edges[:, ::-1]])
    j_adj = j_models.mean_adjacency(j_csr.CSR.from_edges(edges, n))
    t_adj = t_models.mean_adjacency(t_csr.CSR.from_edges(edges, n))
    x = rng.standard_normal((n, DIMS[0])).astype(np.float32)
    y = rng.integers(0, DIMS[-1], size=n).astype(np.int32)
    mask = (rng.random(n) < 0.7).astype(np.float32)
    return j_adj, t_adj, x, y, mask


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_training_resumes_across_packages(writer, tmp_path):
    """SAGE through csr_xla plans: one package takes two Adam steps and
    saves; the other loads into fresh templates and takes the third; the
    writer takes its own third. The parameters agree."""
    j_adj, t_adj, x, y, mask = _problem()
    j_step, j_init_state = j_make_train_step(
        j_models.sage_apply, j_ops.spmm_plan(j_adj, impl="csr_xla"), optax.adam(1e-2))
    t_step, t_init_state = t_models.make_train_step(
        t_models.sage_apply, t_ops.spmm_plan(t_adj, impl="csr_xla", device="cpu"),
        functools.partial(torch.optim.Adam, lr=1e-2))
    path = str(tmp_path / "ck.npz")
    j_params = j_models.init_sage(jax.random.PRNGKey(2), DIMS)
    j_state = j_init_state(j_params)
    t_params = t_models.init_sage(DIMS, GEN())
    t_state = t_init_state(t_params)
    if writer == "jax":
        for _ in range(2):
            j_params, j_state, _ = j_step(j_params, j_state, x, y, mask)
        j_models.save_checkpoint(path, j_params, j_state, step=2)
        t_params, t_state, at = t_models.load_checkpoint(path, t_params, t_state)
    else:
        t_params = t_models.params_from_jax(jax.tree.map(np.asarray, j_params))
        t_state = t_init_state(t_params)
        for _ in range(2):
            t_params, t_state, _ = t_step(t_params, t_state, x, y, mask)
        t_models.save_checkpoint(path, t_params, t_state, step=2)
        j_params, j_state, at = j_models.load_checkpoint(path, j_params, j_state)
    assert at == 2
    for j, t in zip(jax.tree.leaves(j_params), t_models.tree_leaves(t_params)):
        assert _bits_equal(t.detach().numpy(), j)
    j_params, j_state, jm = j_step(j_params, j_state, x, y, mask)
    t_params, t_state, tm = t_step(t_params, t_state, x, y, mask)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-6 * float(jm["loss"])
    for j, t in zip(jax.tree.leaves(j_params), t_models.tree_leaves(t_params)):
        assert np.abs(t.detach().numpy() - np.asarray(j, np.float64)).max() <= 1e-6


def test_extensionless_path_and_sgd(tmp_path):
    """save("ckpt")/load("ckpt") agree in both packages (np.savez adds
    ".npz", np.load does not); SGD (optax.sgd) has no state leaves."""
    params = t_models.init_gcn(DIMS, GEN())
    opt = torch.optim.SGD(t_models.tree_leaves(params), lr=0.1)
    path = str(tmp_path / "ckpt")
    t_models.save_checkpoint(path, params, opt, step=7)
    z = np.load(path + ".npz")
    assert sorted(z.files) == sorted([f"p{i}" for i in range(4)] + ["step"])
    fresh = t_models.init_gcn(DIMS, torch.Generator().manual_seed(1))
    got, _, at = t_models.load_checkpoint(path, fresh, torch.optim.SGD(
        t_models.tree_leaves(fresh), lr=0.1))
    assert at == 7
    for a, b in zip(t_models.tree_leaves(got), t_models.tree_leaves(params)):
        assert torch.equal(a, b)
    like = j_models.init_gcn(jax.random.PRNGKey(0), DIMS)
    j_params, j_state, at = j_models.load_checkpoint(path, like, optax.sgd(0.1).init(like))
    assert at == 7
    for a, b in zip(jax.tree.leaves(j_params), t_models.tree_leaves(params)):
        assert _bits_equal(a, b.numpy())


@pytest.mark.parametrize("make", [
    lambda ps: torch.optim.RMSprop(ps),
    lambda ps: torch.optim.Adam(ps, amsgrad=True),
    lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
], ids=["rmsprop", "adam_amsgrad", "sgd_momentum"])
def test_other_optimizers_raise(make, tmp_path):
    params = t_models.init_gcn(DIMS, GEN())
    opt = make(t_models.tree_leaves(params))
    with pytest.raises(NotImplementedError):
        t_models.save_checkpoint(str(tmp_path / "x"), params, opt)
    t_models.save_checkpoint(str(tmp_path / "x"), params)
    with pytest.raises(NotImplementedError):
        t_models.load_checkpoint(str(tmp_path / "x"), params, opt)
