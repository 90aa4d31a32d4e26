"""The serving slice end to end on the CPU, JAX package against the port:
dataset stand-in -> rcmk reorder -> sym_norm_adjacency -> spmm_plan
(bsr_pallas, grad=False) -> GCN forward with the same weights. The JAX
side runs its Pallas kernels in interpret mode (its plan turns that on
off-TPU); the port runs the kernels' plain versions. Tolerance: the
reference's 1e-4 gate (assert_allclose)."""

import jax
import numpy as np
import pytest
import torch

import spmm_denseblock_tpu.formats.csr as j_csr
import spmm_denseblock_tpu.io.datasets as j_ds
import spmm_denseblock_tpu.models as j_models
import spmm_denseblock_tpu.ops as j_ops
import spmm_denseblock_tpu.reorder as j_reorder
import spmm_denseblock_tpu_torch.formats.csr as t_csr
import spmm_denseblock_tpu_torch.io.datasets as t_ds
import spmm_denseblock_tpu_torch.models as t_models
import spmm_denseblock_tpu_torch.ops as t_ops
import spmm_denseblock_tpu_torch.reorder as t_reorder
from spmm_denseblock_tpu_torch.ops import assert_allclose

torch.set_num_threads(2)

DIMS = [32, 64, 16]


def _graphs(kind, tmp_path):
    if kind == "ddi":  # dense rows: 14 block-rows of 14 blocks at b=32
        return (j_ds.load_dataset("ogbl-ddi", cache_dir=str(tmp_path / "j"), scale=0.1),
                t_ds.load_dataset("ogbl-ddi", cache_dir=str(tmp_path / "t"), scale=0.1))
    # a path with a few long edges: 2-4 blocks per block-row at b=32
    rng = np.random.default_rng(3)
    path = np.stack([np.arange(511), np.arange(1, 512)], 1)
    far = rng.integers(0, 512, size=(24, 2))
    edges = np.concatenate([path, far])
    edges = np.concatenate([edges, edges[:, ::-1]])
    return j_csr.CSR.from_edges(edges, 512), t_csr.CSR.from_edges(edges, 512)


@pytest.mark.parametrize("kind,layout", [("ddi", "sorted"), ("sparse", "flat")])
def test_gcn_serving_slice_matches_jax(kind, layout, tmp_path):
    j_graph, t_graph = _graphs(kind, tmp_path)
    j_adj = j_models.sym_norm_adjacency(j_reorder.reorder(j_graph, "rcmk")[0])
    t_adj = t_models.sym_norm_adjacency(t_reorder.reorder(t_graph, "rcmk")[0])
    np.testing.assert_array_equal(np.asarray(j_adj.data), t_adj.data)

    j_plan = j_ops.spmm_plan(j_adj, impl="bsr_pallas", block_size=32, grad=False)
    t_plan = t_ops.spmm_plan(t_adj, impl="bsr_pallas", block_size=32, grad=False,
                             device="cpu")
    assert t_plan.statics[0] == layout
    j_sorted = isinstance(j_plan.statics[-1], tuple)
    assert j_sorted == (layout == "sorted")

    j_params = j_models.init_gcn(jax.random.PRNGKey(0), DIMS)
    j_params_np = [{k: np.asarray(v) for k, v in p.items()} for p in j_params]
    gcn = t_models.GCN(DIMS).load_params(t_models.gcn_params_from_jax(j_params_np))
    x = np.random.default_rng(7).standard_normal(
        (t_adj.n_rows, DIMS[0])).astype(np.float32)

    want = np.asarray(j_models.gcn_apply(j_params, j_plan, x))
    with torch.no_grad():
        got = gcn(t_plan, torch.as_tensor(x))
        got_fn = t_models.gcn_apply(
            t_models.gcn_params_from_jax(j_params_np), t_plan, torch.as_tensor(x))
    assert got.shape == (t_adj.n_rows, DIMS[-1])
    assert torch.isfinite(got).all()
    assert_allclose(got, want)
    assert torch.equal(got, got_fn)
    # and against a float64 host oracle on the same weights
    h = x.astype(np.float64)
    a64 = t_adj.to_scipy().astype(np.float64)
    for i, p in enumerate(j_params_np):
        h = a64 @ h @ p["w"].astype(np.float64) + p["b"]
        if i < len(j_params_np) - 1:
            h = np.maximum(h, 0.0)
    assert_allclose(got, h)


def test_auto_router_parity(tmp_path):
    """b=128: both routers pick bsr_pallas. b=32, and narrow operands at
    b=128: both pick bsr_xla, and the answers agree."""
    j_graph, t_graph = _graphs("ddi", tmp_path)
    j_adj = j_models.sym_norm_adjacency(j_graph)
    t_adj = t_models.sym_norm_adjacency(t_graph)

    j_auto = j_ops.spmm_plan(j_adj, impl="auto", block_size=128, grad=False)
    assert j_auto.apply_fn.__module__.endswith("bsr_spmm_pallas")
    t_auto = t_ops.spmm_plan(t_adj, impl="auto", block_size=128, grad=False, device="cpu")
    assert t_auto.apply_fn.__module__.endswith("bsr_spmm_pallas")

    x = np.random.default_rng(8).standard_normal((t_adj.n_rows, 24)).astype(np.float32)
    for kw in ({"block_size": 32}, {"block_size": 128, "feat_dim": 64}):
        j_small = j_ops.spmm_plan(j_adj, impl="auto", grad=False, **kw)
        assert j_small.apply_fn.__module__.endswith("bsr_spmm_xla")
        t_small = t_ops.spmm_plan(t_adj, impl="auto", grad=False, **kw, device="cpu")
        assert t_small.apply_fn.__module__.endswith("bsr_spmm_xla")
        assert_allclose(t_small(x), np.asarray(j_small(x)))


def test_auto_router_fill_guard():
    """A weakly structured graph BSR-ifies into mostly empty blocks; past
    32x fill both routers leave the BSR tier for csr_ell, and the answers
    agree."""
    j_graph = j_csr.random_csr(0.002, 1024, seed=0, values="ones")
    t_graph = t_csr.random_csr(0.002, 1024, seed=0, values="ones")
    j_auto = j_ops.spmm_plan(j_graph, impl="auto", block_size=128, grad=False)
    assert "ell" in j_auto.apply_fn.__module__
    t_auto = t_ops.spmm_plan(t_graph, impl="auto", block_size=128, grad=False,
                             device="cpu")
    assert t_auto.apply_fn.__module__.endswith(".csr_spmm_ell")
    x = np.random.default_rng(1).standard_normal((1024, 8)).astype(np.float32)
    assert_allclose(t_auto(x), np.asarray(j_auto(x)))


def test_dense_impl_matches_scipy():
    t_graph = t_csr.random_csr(0.05, 96, seed=1)
    plan = t_ops.spmm_plan(t_graph, impl="dense", device="cpu")
    x = np.random.default_rng(0).standard_normal((96, 9)).astype(np.float32)
    assert_allclose(plan(x), t_ops.spmm_scipy(t_graph, x))
