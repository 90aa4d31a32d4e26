"""The model family beyond GCN, JAX package against the port, on the CPU:
GraphSAGE, GIN and the GIN graph classifier (logits and gradients
through bsr_pallas and csr_ell plans), GAT (logits and gradients, a
graph with an empty row among them), gcn_apply(remat=True), the module
wrappers and params_from_jax. The weights are the JAX init's, carried
over by params_from_jax; the JAX bsr_pallas plan runs its Pallas kernels
in interpret mode, as its own tests do, and the port's plan the kernels'
plain versions.

Tolerance: 1e-5 relative to max |JAX| (the same weights and graph; only
the order of the f32 sums differs): the logits' max, and for gradients
the largest |JAX gradient| over all the tree's leaves, since a leaf such
as GIN's 0-d eps sums many terms that largely cancel, so its own value
is no scale for their rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmm_denseblock_tpu.formats.csr as j_csr
import spmm_denseblock_tpu.io.datasets as j_ds
import spmm_denseblock_tpu.models as j_models
import spmm_denseblock_tpu.ops as j_ops
import spmm_denseblock_tpu_torch.formats.csr as t_csr
import spmm_denseblock_tpu_torch.models as t_models
import spmm_denseblock_tpu_torch.ops as t_ops
from spmm_denseblock_tpu.models.train import masked_cross_entropy as j_masked_ce

torch.set_num_threads(2)

TOL = 1e-5
N = 64


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _pair(edges, n):
    return j_csr.CSR.from_edges(edges, n), t_csr.CSR.from_edges(edges, n)


def _graph(n=N, seed=3):
    """A path with a few long edges, symmetric: 2-4 blocks a block-row at
    b = 8."""
    rng = np.random.default_rng(seed)
    path = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    edges = np.concatenate([path, rng.integers(0, n, size=(n // 4, 2))])
    return _pair(np.concatenate([edges, edges[:, ::-1]]), n)


def _grads_close(j_grads, leaves):
    """Every leaf's gradient within TOL of the tree's largest |JAX
    gradient|, leaves in JAX's order."""
    j_leaves = [np.asarray(g, np.float64) for g in jax.tree.leaves(j_grads)]
    assert len(j_leaves) == len(leaves)
    scale = max(np.abs(g).max() for g in j_leaves)
    for jg, t in zip(j_leaves, leaves):
        assert t.grad.shape == jg.shape
        assert np.abs(t.grad.numpy() - jg).max() <= TOL * scale


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _molecules():
    """A 12-molecule batch (JAX's generator), graph ids sorted."""
    csr, gids = j_ds.synthetic_molecules(n_graphs=12, mean_nodes=10, seed=3)
    t = t_csr.CSR(indptr=np.asarray(csr.indptr), indices=np.asarray(csr.indices),
                  data=None, shape=csr.shape)
    return csr, t, np.asarray(gids)


# model: (adjacency, JAX init, JAX apply, port apply, input width)
DIMS = [6, 12, 5]
MODELS = ("sage", "gin", "classifier")


def _setup(model, impl):
    rng = np.random.default_rng(7)
    if model == "classifier":
        j_adj, t_adj, gids = _molecules()
        n_graphs = int(gids.max()) + 1
        j_params = j_models.init_graph_classifier(jax.random.PRNGKey(0), DIMS, 2)
        j_fn = lambda p, s, x: j_models.graph_classifier_apply(  # noqa: E731
            p, s, x, jnp.asarray(gids), n_graphs)
        t_fn = lambda p, s, x: t_models.graph_classifier_apply(  # noqa: E731
            p, s, x, torch.as_tensor(gids), n_graphs)
        y = rng.integers(0, 2, size=n_graphs)
        mask = None
    else:
        j_g, t_g = _graph()
        if model == "sage":
            j_adj, t_adj = j_models.mean_adjacency(j_g), t_models.mean_adjacency(t_g)
        else:
            j_adj, t_adj = j_g, t_g
        j_init, j_fn = j_models.MODELS[model]
        t_fn = t_models.MODELS[model][1]
        j_params = j_init(jax.random.PRNGKey(0), DIMS)
        y = rng.integers(0, DIMS[-1], size=N)
        mask = (rng.random(N) < 0.6).astype(np.float32)
    kw = {"block_size": 8} if impl == "bsr_pallas" else {}
    j_spmm = j_ops.spmm_plan(j_adj, impl=impl, **kw)
    t_spmm = t_ops.spmm_plan(t_adj, impl=impl, device="cpu", **kw)
    x = rng.standard_normal((t_adj.n_rows, DIMS[0])).astype(np.float32)
    return j_params, j_fn, j_spmm, t_fn, t_spmm, x, y.astype(np.int32), mask


def _j_loss(logits, y, mask):
    if mask is None:  # graph-level: mean CE, as examples/molecule_study.py
        lp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(lp, jnp.asarray(y)[:, None], axis=1))
    return j_masked_ce(logits, y, mask)


def _t_loss(logits, y, mask):
    if mask is None:
        lp = torch.log_softmax(logits, -1)
        return -lp.gather(1, torch.as_tensor(y).long()[:, None]).mean()
    return t_models.masked_cross_entropy(logits, torch.as_tensor(y),
                                         torch.as_tensor(mask))


@pytest.mark.parametrize("impl", ["bsr_pallas", "csr_ell"])
@pytest.mark.parametrize("model", MODELS)
def test_model_logits_match_jax(model, impl):
    j_params, j_fn, j_spmm, t_fn, t_spmm, x, _, _ = _setup(model, impl)
    want = np.asarray(j_fn(j_params, j_spmm, x))
    t_params = t_models.params_from_jax(_np_tree(j_params))
    with torch.no_grad():
        got = t_fn(t_params, t_spmm, torch.as_tensor(x))
    assert got.shape == want.shape and torch.isfinite(got).all()
    assert _rel(got.numpy(), want) < TOL


@pytest.mark.parametrize("impl", ["bsr_pallas", "csr_ell"])
@pytest.mark.parametrize("model", MODELS)
def test_model_gradients_match_jax(model, impl):
    """The masked node loss (SAGE, GIN) or the graph-level loss (the
    classifier) and every parameter's gradient, leaves in JAX's order."""
    j_params, j_fn, j_spmm, t_fn, t_spmm, x, y, mask = _setup(model, impl)
    j_loss, j_grads = jax.value_and_grad(
        lambda p: _j_loss(j_fn(p, j_spmm, x), y, mask))(j_params)
    t_params = t_models.params_from_jax(_np_tree(j_params))
    leaves = t_models.tree_leaves(t_params)
    for t in leaves:
        t.requires_grad_(True)
    loss = _t_loss(t_fn(t_params, t_spmm, torch.as_tensor(x)), y, mask)
    loss.backward()
    assert abs(loss.item() - float(j_loss)) <= TOL * float(j_loss)
    _grads_close(j_grads, leaves)


def _gat_graph(empty_row: bool):
    j_g, t_g = _graph(n=40, seed=8)
    if not empty_row:
        return j_g, t_g
    rows, cols = t_g.row_ids(), np.asarray(t_g.indices)
    keep = rows != 5  # row 5 has no edges; column 5 keeps its in-edges
    return (j_csr.CSR.from_coo(rows[keep], cols[keep], None, t_g.shape),
            t_csr.CSR.from_coo(rows[keep], cols[keep], None, t_g.shape))


@pytest.mark.parametrize("heads", [1, 3])
@pytest.mark.parametrize("empty_row", [False, True])
def test_gat_matches_jax(empty_row, heads):
    """GAT logits and the gradients of a mean CE against JAX; an empty
    row gives 0 before the last layer's bias-free mean (its logits are 0)
    in both."""
    j_g, t_g = _gat_graph(empty_row)
    dims = [6, 8, 3]
    j_params = j_models.init_gat(jax.random.PRNGKey(1), dims, heads=heads)
    j_apply = j_models.make_gat_apply(j_g, heads=heads)
    t_apply = t_models.make_gat_apply(t_g, heads=heads, device="cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((40, 6)).astype(np.float32)
    y = rng.integers(0, 3, size=40).astype(np.int32)
    want = np.asarray(j_apply(j_params, x))
    t_params = t_models.params_from_jax(_np_tree(j_params))
    with torch.no_grad():
        got = t_apply(t_params, x)
    assert got.shape == (40, 3) and torch.isfinite(got).all()
    assert _rel(got.numpy(), want) < TOL
    if empty_row:
        assert t_g.degrees()[5] == 0
        assert not got[5].any() and not want[5].any()

    j_grads = jax.grad(lambda p: _j_loss(j_apply(p, x), y, None))(j_params)
    leaves = t_models.tree_leaves(t_params)
    for t in leaves:
        t.requires_grad_(True)
    _t_loss(t_apply(t_params, x), y, None).backward()
    _grads_close(j_grads, leaves)


@pytest.mark.parametrize("spmm_kind", ["dense", "grad_plan"])
def test_gcn_remat_matches(spmm_kind):
    """remat=True (torch.utils.checkpoint) gives remat=False's forward bit
    for bit and its gradients, also through the Plan autograd Function."""
    rng = np.random.default_rng(4)
    if spmm_kind == "dense":
        a = torch.as_tensor(rng.standard_normal((20, 20)).astype(np.float32))
        spmm, n = (lambda h: a @ h), 20
    else:
        _, t_g = _graph()
        spmm = t_ops.spmm_plan(t_models.sym_norm_adjacency(t_g), impl="bsr_pallas",
                               block_size=8, device="cpu")
        n = N
    x = torch.as_tensor(rng.standard_normal((n, 6)).astype(np.float32))
    grads, outs = [], []
    for remat in (False, True):
        params = t_models.init_gcn([6, 8, 4], torch.Generator().manual_seed(0))
        leaves = t_models.tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        out = t_models.gcn_apply(params, spmm, x, remat=remat)
        (out ** 2).sum().backward()
        outs.append(out.detach())
        grads.append([t.grad for t in leaves])
    assert torch.equal(outs[0], outs[1])
    for g0, g1 in zip(*grads):
        assert _rel(g1.numpy(), g0.numpy()) < 1e-6


MODULES = {
    "sage": lambda: (t_models.SAGE(DIMS, torch.Generator().manual_seed(0)),
                     t_models.sage_apply),
    "gin": lambda: (t_models.GIN(DIMS, generator=torch.Generator().manual_seed(0)),
                    t_models.gin_apply),
    "gat": lambda: (t_models.GAT(DIMS, 2, torch.Generator().manual_seed(0)), None),
}


@pytest.mark.parametrize("name", list(MODULES))
def test_module_wrappers(name):
    """Each module holds its tree as parameters (one per leaf, in JAX's
    order), its forward equals the function on params(), and load_params
    copies a JAX init in."""
    module, fn = MODULES[name]()
    leaves = t_models.tree_leaves(module.params())
    assert [p for p in module.parameters()] == leaves
    j_init = {"sage": lambda k: j_models.init_sage(k, DIMS),
              "gin": lambda k: j_models.init_gin(k, DIMS),
              "gat": lambda k: j_models.init_gat(k, DIMS, heads=2)}[name]
    j_params = _np_tree(j_init(jax.random.PRNGKey(3)))
    module.load_params(j_params)
    for t, j in zip(leaves, jax.tree.leaves(j_params)):
        assert t.shape == j.shape and np.array_equal(t.detach().numpy(), j)
    _, t_g = _graph()
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (N, DIMS[0])).astype(np.float32))
    with torch.no_grad():
        if name == "gat":
            apply = t_models.make_gat_apply(t_g, 2, device="cpu")
            assert torch.equal(module(apply, x), apply(module.params(), x))
        else:
            spmm = t_ops.spmm_plan(t_g, impl="csr_xla", device="cpu")
            assert torch.equal(module(spmm, x), fn(module.params(), spmm, x))


def test_graph_classifier_module():
    _, t_adj, gids = _molecules()
    n_graphs = int(gids.max()) + 1
    module = t_models.GraphClassifier(DIMS, 2, torch.Generator().manual_seed(0))
    spmm = t_ops.spmm_plan(t_adj, impl="csr_ell", device="cpu")
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (t_adj.n_rows, DIMS[0])).astype(np.float32))
    with torch.no_grad():
        got = module(spmm, x, gids, n_graphs)
        assert got.shape == (n_graphs, 2)
        assert torch.equal(got, t_models.graph_classifier_apply(
            module.params(), spmm, x, gids, n_graphs))
        # ids at or past n_graphs are dropped, as JAX's segment_sum drops them
        fewer = t_models.graph_classifier_apply(module.params(), spmm, x, gids, 5)
    assert torch.equal(fewer, got[:5])


@pytest.mark.parametrize("name", ["gcn", "sage", "gin", "classifier", "gat"])
def test_init_trees_match_jax(name):
    """Each init gives JAX's tree: the same leaves in the same order, of
    the same shapes and dtypes; params_from_jax keeps structure and
    values."""
    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    j_tree, t_tree = {
        "gcn": (j_models.init_gcn(key, DIMS), t_models.init_gcn(DIMS, gen)),
        "sage": (j_models.init_sage(key, DIMS), t_models.init_sage(DIMS, gen)),
        "gin": (j_models.init_gin(key, DIMS, mlp_hidden=7),
                t_models.init_gin(DIMS, mlp_hidden=7, generator=gen)),
        "classifier": (j_models.init_graph_classifier(key, DIMS, 2),
                       t_models.init_graph_classifier(DIMS, 2, gen)),
        "gat": (j_models.init_gat(key, DIMS, heads=3),
                t_models.init_gat(DIMS, 3, gen)),
    }[name]
    j_leaves, t_leaves = jax.tree.leaves(j_tree), t_models.tree_leaves(t_tree)
    assert [np.asarray(j).shape for j in j_leaves] == [tuple(t.shape) for t in t_leaves]
    assert all(t.dtype == torch.float32 for t in t_leaves)
    carried = t_models.params_from_jax(_np_tree(j_tree))
    assert jax.tree.structure(_np_tree(j_tree)) == jax.tree.structure(
        t_models.tree_map(lambda t: t.numpy(), carried))
    for j, t in zip(j_leaves, t_models.tree_leaves(carried)):
        assert np.array_equal(np.asarray(j), t.numpy())


def test_models_registry_matches_jax():
    assert set(t_models.MODELS) == set(j_models.MODELS)
    # every JAX name, the sharded checkpoints' three among them
    assert set(j_models.__all__) - set(t_models.__all__) == set()
