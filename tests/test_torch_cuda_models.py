"""The models and the ops beside SpMM on the card, against their CPU runs:
csr_to_bsr_on_device (bit for bit), SDDMM (the bf16 block tier returns
f32), the dense-block GEMM, GAT with an empty row (and the same bits on
a second run), GAT's plan route against its segment route at the
source's widths (and its memory), the GIN graph classifier, SAGE and GIN through the kernel
plans, and gcn_apply(remat=True) through a grad plan. These need a GPU
and skip without one; run them on one with

    python -m pytest --noconftest tests/test_torch_cuda_models.py -q

(tests/conftest.py imports jax, which these tests do not need).

Tolerance: 1e-5 relative to max |CPU| (the same inputs in the same
dtype; the card's f32 sums run in another order); bit-equality where
every value is written once (the conversion) or summed in a fixed order
(two runs on the card)."""

import numpy as np
import pytest
import torch

from spmm_denseblock_tpu_torch import models as M
from spmm_denseblock_tpu_torch import ops as O
from spmm_denseblock_tpu_torch.convert.csr2bsr import csr_to_bsr
from spmm_denseblock_tpu_torch.formats.csr import CSR, random_csr
from spmm_denseblock_tpu_torch.io.datasets import synthetic_molecules
from spmm_denseblock_tpu_torch.ops import _kernels

torch.set_num_threads(2)

# a string condition is evaluated when the test runs, not at import
pytestmark = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs an NVIDIA GPU: these tests compare the card with the CPU",
)

TOL = 1e-5


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _rel(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return ((got - want).abs().max() / want.abs().max().clamp(min=1e-30)).item()


def _graph(n=300, p=0.02, seed=3, empty=(5, 77)):
    src = random_csr(p, n, seed=seed)
    rows, cols = src.row_ids(), np.asarray(src.indices)
    keep = ~np.isin(rows, empty)
    return CSR.from_coo(rows[keep], cols[keep], src.values()[keep], src.shape)


@pytest.mark.parametrize("extra", [None, -5, 9])
@pytest.mark.parametrize("b", [16, 32])
def test_csr_to_bsr_on_device_cuda_equals_cpu(b, extra):
    csr = random_csr(0.02, 500, 450, seed=4)
    cap = None if extra is None else csr_to_bsr(csr, b).nnzb + extra
    got = O.csr_to_bsr_on_device(csr, b, nnzb_max=cap)
    want = O.csr_to_bsr_on_device(csr, b, nnzb_max=cap, device="cpu")
    assert got.nnzb == want.nnzb
    for name in ("block_rows", "block_cols", "blocks"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sddmm_cuda_matches_cpu(dtype):
    """Both tiers; the block tier gives f32 scores for bf16 operands."""
    csr = _graph()
    bsr = csr_to_bsr(csr, 32)
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((300, 40)).astype(np.float32)).to(dtype)
    y = torch.as_tensor(rng.standard_normal((300, 40)).astype(np.float32)).to(dtype)
    e = O.sddmm(csr, x.cuda(), y.cuda())
    e_cpu = O.sddmm(csr, x, y, device="cpu")
    assert e.dtype == dtype and e.is_cuda
    assert _rel(e.float(), e_cpu.float()) < (TOL if dtype == torch.float32 else 1e-2)
    args = (bsr.block_rows[: bsr.nnzb], bsr.block_cols[: bsr.nnzb], 32, 300, 300)
    s = O.sddmm_block_plan(*args)(x.cuda(), y.cuda())
    s_cpu = O.sddmm_block_plan(*args, device="cpu")(x, y)
    assert s.dtype == torch.float32 and s.is_cuda and s.shape == (bsr.nnzb, 32, 32)
    assert _rel(s, s_cpu) < TOL


def test_dense_block_gemm_cuda_matches_cpu():
    bsr = csr_to_bsr(random_csr(0.05, 256, seed=2), 32)
    order = np.random.default_rng(0).permutation(bsr.nnzb)
    dense = np.random.default_rng(1).standard_normal((8, 32, 48)).astype(np.float32)
    args = (bsr.block_rows[order], bsr.block_cols[order], bsr.blocks[order], dense, 8)
    got = O.dense_block_gemm(*args)
    assert got.is_cuda and got.dtype == torch.float32
    assert _rel(got, O.dense_block_gemm(*args, device="cpu")) < TOL


def test_gat_cuda_matches_cpu_with_empty_rows():
    csr = _graph()
    assert (csr.degrees()[[5, 77]] == 0).all()
    params = M.init_gat([40, 16, 7], 3, torch.Generator().manual_seed(0))
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (300, 40)).astype(np.float32))
    apply = M.make_gat_apply(csr, 3)
    p_cuda = M.tree_map(lambda t: t.cuda(), params)
    with torch.no_grad():
        got = apply(p_cuda, x.cuda())
        again = apply(p_cuda, x.cuda())
        want = M.make_gat_apply(csr, 3, device="cpu")(params, x)
    assert got.is_cuda and got.shape == (300, 7)
    assert torch.equal(got, again)
    assert _rel(got, want) < TOL
    assert not got[[5, 77]].any()


def _gat_pattern_graph(n: int, seed: int) -> CSR:
    from spmm_denseblock_tpu_torch.models.graph import gat_pattern

    edges = np.random.default_rng(seed).integers(0, n, (8 * n, 2))
    return gat_pattern(CSR.from_edges(edges, n))


def _segment_route(apply, params, x):
    """The segment route's answer: a call whose weights need a gradient."""
    with torch.enable_grad():
        return apply([{k: t.detach().requires_grad_(True) for k, t in p.items()}
                      for p in params], x).detach()


def test_gat_plan_route_matches_segment_route():
    """The GAT at the source's widths (3 heads of 250, then of 40) with
    the residual projection on a 4,000-node attention pattern: a call that
    needs no gradient runs the plan route (one sdb_ell_spmm launch a
    layer, its values made by the request) within 1e-5 of the segment
    route on the card, the same bits on a second run; with program tracing
    on, sdb.kernel/csr_ell counts each layer's call, sdb.call_values/csr_ell
    adds nnz x 3 a layer and sdb.gat_scores opens once a layer."""
    from spmm_denseblock_tpu_torch.utils import profiling

    csr = _gat_pattern_graph(4000, 11)
    params = M.tree_map(lambda t: t.cuda(), M.init_gat(
        [64, 250, 40], 3, torch.Generator().manual_seed(1), residual=True))
    x = torch.as_tensor(np.random.default_rng(12).standard_normal(
        (4000, 64)).astype(np.float32), device="cuda")
    apply = M.make_gat_apply(csr, 3)
    want = _segment_route(apply, params, x)
    with torch.no_grad():
        before = _kernels.ell_spmm.launches
        prev = profiling.enable(True)
        try:
            profiling.take()
            got = apply(params, x)
            torch.cuda.synchronize()
            taken = profiling.take()
        finally:
            profiling.enable(prev)
    assert _kernels.ell_spmm.launches == before + 2
    with torch.no_grad():
        again = apply(params, x)
    assert taken["counts"]["sdb.kernel/csr_ell"] == 2
    assert taken["counts"]["sdb.call_values/csr_ell"] == 2 * 3 * csr.nnz
    assert [sp.name for sp in taken["spans"]].count("sdb.gat_scores") == 2
    assert got.shape == (4000, 40) and torch.equal(got, again)
    assert _rel(got, want) < TOL


def test_gat_plan_route_makes_no_edge_by_column_tensor():
    """On a 20,000-node pattern at 3 heads of 250 (an (nnz, 3, 250) f32
    tensor would take about 1 GB), a plan-route request's peak memory
    above what was held stays under a fifth of that, where the segment
    route's (a call whose weights need a gradient) exceeds it."""
    csr = _gat_pattern_graph(20000, 13)
    params = M.tree_map(lambda t: t.cuda(), M.init_gat(
        [128, 250, 40], 3, torch.Generator().manual_seed(2)))
    x = torch.randn(20000, 128, device="cuda")
    edge_by_column = csr.nnz * 3 * 250 * 4
    apply = M.make_gat_apply(csr, 3)
    peaks = {}
    for route in ("plan", "segment"):
        def call():
            if route == "plan":
                with torch.no_grad():
                    return apply(params, x)
            return _segment_route(apply, params, x)
        call()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        call()
        torch.cuda.synchronize()
        peaks[route] = torch.cuda.max_memory_allocated() - held
    assert peaks["plan"] < edge_by_column / 5 < edge_by_column < peaks["segment"], (
        peaks, edge_by_column)


def test_graph_classifier_cuda_matches_cpu():
    csr, gids = synthetic_molecules(n_graphs=40, mean_nodes=12, seed=1)
    n_graphs = int(gids.max()) + 1
    params = M.init_graph_classifier([8, 16, 16], 2, torch.Generator().manual_seed(0))
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (csr.n_rows, 8)).astype(np.float32))
    spmm = O.spmm_plan(csr, impl="csr_ell", grad=False)
    p_cuda = M.tree_map(lambda t: t.cuda(), params)
    with torch.no_grad():
        got = M.graph_classifier_apply(p_cuda, spmm, x.cuda(), gids, n_graphs)
        again = M.graph_classifier_apply(p_cuda, spmm, x.cuda(), gids, n_graphs)
        want = M.graph_classifier_apply(
            params, O.spmm_plan(csr, impl="csr_ell", grad=False, device="cpu"),
            x, gids, n_graphs)
    assert torch.equal(got, again)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("model,b,kernel", [
    ("sage", 32, "bsr_spmm_sorted"), ("gin", 32, "bsr_spmm_flat")])
def test_models_through_kernel_plans(model, b, kernel):
    """SAGE on a mean adjacency whose block-rows hold >= 8 real blocks
    (the plan sorts: K2) and GIN on a molecule batch's raw adjacency,
    2-3 blocks a block-row (flat: K1), each layer's SpMM a launch, within
    1e-5 of the CPU run."""
    if model == "sage":
        adj = M.mean_adjacency(random_csr(0.3, 512, seed=5))
        dims = [32, 24, 6]
    else:
        adj = synthetic_molecules(n_graphs=40, mean_nodes=12, seed=5)[0]
        dims = [32, 24, 24, 6]
    init, apply = M.MODELS[model]
    params = init(dims, generator=torch.Generator().manual_seed(0))
    x = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (adj.n_rows, dims[0])).astype(np.float32))
    plan = O.spmm_plan(adj, impl="bsr_pallas", block_size=b, grad=False)
    counter = next(k for k in _kernels.KERNELS if k.symbol == f"sdb_{kernel}")
    before = counter.launches
    with torch.no_grad():
        got = apply(M.tree_map(lambda t: t.cuda(), params), plan, x.cuda())
        want = apply(params, O.spmm_plan(adj, impl="bsr_pallas", block_size=b,
                                         grad=False, device="cpu"), x)
    assert counter.launches - before == len(dims) - 1
    assert _rel(got, want) < TOL


def test_gcn_remat_through_grad_plan_on_cuda():
    """remat=True through the card's grad plan (K2 on A and on Aᵀ): the
    same forward and gradients as remat=False."""
    adj = M.sym_norm_adjacency(random_csr(0.3, 256, seed=6))
    plan = O.spmm_plan(adj, impl="bsr_pallas", block_size=32)
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (256, 16)).astype(np.float32)).cuda()
    outs, grads = [], []
    for remat in (False, True):
        params = M.init_gcn([16, 24, 5], torch.Generator().manual_seed(0), "cuda")
        leaves = M.tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        out = M.gcn_apply(params, plan, x, remat=remat)
        (out ** 2).sum().backward()
        outs.append(out.detach())
        grads.append([t.grad for t in leaves])
    assert torch.equal(outs[0], outs[1])
    for g0, g1 in zip(*grads):
        assert _rel(g1, g0) < 1e-6
