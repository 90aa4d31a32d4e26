"""The port's composite tiers against the JAX package's: the hybrid
splitter (divide, auto_threshold, ell_padded_slots, score_thresholds and
its report) and the windowed splitter are bit-equal; Hybrid and Windowed
densify to the matrix; the hybrid, hybrid_int8, windowed, windowed_int8
and tiered plans match JAX's on the same seeded inputs (1e-5 of max
|JAX|: only the order of the f32 sums differs; int8 sums are exact in
int32 in both); and the GCN slice of this port, [16, 32, 8] through
impl="auto" (the hybrid and the ELL route), "hybrid" and hybrid int8,
matches JAX's gcn_apply through JAX's spmm_plan on the same graph and
weights within 1e-5."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmm_denseblock_tpu.formats.csr as j_csr
import spmm_denseblock_tpu.formats.windowed as j_win
import spmm_denseblock_tpu.models as j_models
import spmm_denseblock_tpu.ops as j_ops
import spmm_denseblock_tpu_torch.formats.csr as t_csr
import spmm_denseblock_tpu_torch.formats.windowed as t_win
import spmm_denseblock_tpu_torch.models as t_models
import spmm_denseblock_tpu_torch.ops as t_ops
from spmm_denseblock_tpu_torch.formats.hybrid import Hybrid
from spmm_denseblock_tpu_torch.ops import assert_allclose, spmm_scipy

JD = importlib.import_module("spmm_denseblock_tpu.convert.divide")
TD = importlib.import_module("spmm_denseblock_tpu_torch.convert.divide")
JH = importlib.import_module("spmm_denseblock_tpu.ops.hybrid_spmm")
TH = importlib.import_module("spmm_denseblock_tpu_torch.ops.hybrid_spmm")
JW = importlib.import_module("spmm_denseblock_tpu.ops.windowed_spmm")
TW = importlib.import_module("spmm_denseblock_tpu_torch.ops.windowed_spmm")

torch.set_num_threads(2)

TOL = 1e-5


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _x(n, F, seed):
    return np.random.default_rng(seed).standard_normal((n, F)).astype(np.float32)


def community_graph(n=256, seed=3):
    """Two dense 32-node communities (nodes 0-31 and 64-95) and a sparse
    random tail, symmetric, as both packages' CSR: some 32 x 32 blocks
    pass every threshold, most hold a few nonzeros."""
    rng = np.random.default_rng(seed)
    e = np.concatenate([rng.integers(0, 32, (400, 2)), rng.integers(64, 96, (400, 2)),
                        rng.integers(0, n, (300, 2))])
    e = np.concatenate([e, e[:, ::-1]])
    return j_csr.CSR.from_edges(e, n), t_csr.CSR.from_edges(e, n)


def community_adj(valued=True):
    jg, tg = community_graph()
    if not valued:
        return jg, tg
    return j_models.sym_norm_adjacency(jg), t_models.sym_norm_adjacency(tg)


def assert_csr_equal(t, j):
    np.testing.assert_array_equal(t.indptr, np.asarray(j.indptr))
    np.testing.assert_array_equal(t.indices, np.asarray(j.indices))
    if j.data is None:
        assert t.data is None
    else:
        np.testing.assert_array_equal(t.data, np.asarray(j.data))
    assert tuple(t.shape) == tuple(j.shape)


def assert_bsr_equal(t, j):
    assert t.nnzb == j.nnzb and t.block_size == j.block_size
    np.testing.assert_array_equal(t.block_rows, np.asarray(j.block_rows)[: j.nnzb])
    np.testing.assert_array_equal(t.block_cols, np.asarray(j.block_cols)[: j.nnzb])
    np.testing.assert_array_equal(t.blocks, np.asarray(j.blocks)[: j.nnzb])


# -- the splitters ------------------------------------------------------------


@pytest.mark.parametrize("valued", [True, False])
@pytest.mark.parametrize("b,density", [(32, 0.1), (32, 0.02), (16, 0.3), (32, 2.0)])
def test_divide_bit_equal(b, density, valued):
    """The dense part's blocks and the remainder, bit for bit; Hybrid's
    nnz and to_dense give the matrix back (density 2.0: no dense part)."""
    jc, tc = community_adj(valued)
    jh, th = JD.divide(jc, b, density), TD.divide(tc, b, density)
    assert_bsr_equal(th.dense, jh.dense)
    assert_csr_equal(th.remainder, jh.remainder)
    assert isinstance(th, Hybrid) and th.shape == tuple(jh.shape)
    assert th.nnz == jh.nnz
    np.testing.assert_array_equal(th.to_dense(), np.asarray(jh.to_dense()))
    np.testing.assert_allclose(th.to_dense(), tc.to_dense(), rtol=0, atol=1e-7)
    assert th.dense.nnz_inside() == jh.dense.nnz_inside()
    parts = th.to("cpu", torch.bfloat16)
    assert parts["dense"]["blocks"].dtype == torch.bfloat16
    assert parts["remainder"]["indices"].shape == (th.remainder.nnz,)


@pytest.mark.parametrize("b", [16, 32, 64])
def test_thresholds_and_scores_bit_equal(b):
    """auto_threshold, ell_padded_slots (both schemes) and
    score_thresholds' pick and report, at every margin and budget the
    router uses."""
    jc, tc = community_adj()
    assert TD.auto_threshold(tc, b) == JD.auto_threshold(jc, b)
    assert TD.auto_threshold(tc, b, dense_speedup=50.0) == JD.auto_threshold(
        jc, b, dense_speedup=50.0)
    for bucket in ("quarter", "pow2"):
        deg = tc.degrees()
        assert TD.ell_padded_slots(deg, bucket) == JD.ell_padded_slots(deg, bucket)
    cands = {0.015, 0.02, 0.03, 0.05, TD.auto_threshold(tc, b)}
    for kw in ({"margin": 0.0}, {}, {"slots_per_block": 4000.0},
               {"dense_bytes_budget": 5000, "dtype_bytes": 1},
               {"dense_bytes_budget": 1 << 12, "margin": 0.0}):
        assert TD.score_thresholds(tc, b, candidates=cands, **kw) == \
            JD.score_thresholds(jc, b, candidates=cands, **kw)


@pytest.mark.parametrize("R,W,K,min_fill", [(32, 64, 1, 0.0), (16, 32, 3, 0.0),
                                            (64, 128, 2, 0.01), (50, 48, 1, 0.0)])
def test_divide_windowed_bit_equal(R, W, K, min_fill):
    """Tiles, window ids and remainder bit for bit (ragged last tile and
    window at R = 50, W = 48); to_dense gives the matrix back."""
    jc, tc = community_adj()
    jw = j_win.divide_windowed(jc, tile_rows=R, window=W, min_fill=min_fill, n_windows=K)
    tw = t_win.divide_windowed(tc, tile_rows=R, window=W, min_fill=min_fill, n_windows=K)
    np.testing.assert_array_equal(tw.tiles, np.asarray(jw.tiles))
    np.testing.assert_array_equal(tw.win_idx, np.asarray(jw.win_idx))
    assert_csr_equal(tw.remainder, jw.remainder)
    assert (tw.n_tiles, tw.n_windows_per_tile) == (jw.n_tiles, jw.n_windows_per_tile)
    assert tw.captured_nnz() == jw.captured_nnz()
    np.testing.assert_allclose(tw.to_dense(), tc.to_dense(), rtol=0, atol=1e-7)


# -- the plans ----------------------------------------------------------------


@pytest.mark.parametrize("dense_impl", ["pallas", "xla"])
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_hybrid_plan_matches_jax(dtype, dense_impl):
    """Both parts, summed; f32 also within 1e-4 of scipy."""
    jc, tc = community_adj()
    jh, th = JD.divide(jc, 32, 0.1), TD.divide(tc, 32, 0.1)
    assert th.dense.nnzb and th.remainder.nnz
    x = _x(tc.n_cols, 11, seed=1)
    want = JH.hybrid_spmm_plan(jh, dense_impl=dense_impl, dtype=dtype, grad=False)(x)
    tp = TH.hybrid_spmm_plan(th, dense_impl=dense_impl, dtype=dtype, grad=False,
                             device="cpu")
    assert len(tp.subplans) == 2
    assert _rel(tp(x), want) < TOL
    if dtype is None:
        assert_allclose(tp(x), spmm_scipy(tc, x))


def test_hybrid_plan_one_part_and_grad():
    """An empty dense part gives the ELL plan, an empty remainder the BSR
    plan; grad=True gradients within 1e-5 of jax.grad's."""
    jc, tc = community_adj()
    x = _x(tc.n_cols, 5, seed=2)
    for thr in (2.0, 0.1):
        jh, th = JD.divide(jc, 32, thr), TD.divide(tc, 32, thr)
        tp = TH.hybrid_spmm_plan(th, grad=False, device="cpu")
        assert (tp.subplans is None) == (thr == 2.0)
        assert _rel(tp(x), JH.hybrid_spmm_plan(jh, grad=False)(x)) < TOL
    dense_only = Hybrid(th.dense, t_csr.CSR.from_coo([], [], None, th.shape), th.shape)
    assert TH.hybrid_spmm_plan(dense_only, grad=False, device="cpu").apply_fn.__name__ \
        == "_pallas_apply"
    w = _x(tc.n_rows, 5, seed=3)
    want = jax.grad(lambda d: jnp.sum(JH.hybrid_spmm_plan(jh)(d) * w))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    (TH.hybrid_spmm_plan(th, device="cpu")(xt) * torch.as_tensor(w)).sum().backward()
    assert _rel(xt.grad, want) < TOL
    with pytest.raises(ValueError, match="dense_impl"):
        TH.hybrid_spmm_plan(th, dense_impl="mxu", device="cpu")


@pytest.mark.parametrize("dense_impl", ["pallas", "xla"])
@pytest.mark.parametrize("calibrated", [False, True])
def test_hybrid_int8_plan_matches_jax(calibrated, dense_impl):
    """The int8 kernel plan (or bsr_int8) and the int8 ELL, summed."""
    jc, tc = community_adj()
    jh, th = JD.divide(jc, 32, 0.1), TD.divide(tc, 32, 0.1)
    x = _x(tc.n_cols, 10, seed=4)
    cal = x if calibrated else None  # a representative batch: no clipping
    want = JH.hybrid_spmm_int8_plan(jh, calibration=cal, dense_impl=dense_impl)(x)
    got = TH.hybrid_spmm_int8_plan(th, calibration=cal, dense_impl=dense_impl,
                                   device="cpu")(x)
    assert _rel(got, want) < TOL
    assert _rel(got, spmm_scipy(tc, x)) < 6e-2
    with pytest.raises(ValueError, match="inference-only"):
        TH.hybrid_spmm_int8_plan(th, grad=True, device="cpu")


@pytest.mark.parametrize("R,W,K", [(32, 64, 1), (16, 32, 2), (50, 48, 1)])
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_windowed_plan_matches_jax(dtype, R, W, K):
    """Window products and the ELL remainder, summed; f32 within 1e-4 of
    scipy; grad=True's gradient within 1e-5 of jax.grad's."""
    jc, tc = community_adj()
    jw = j_win.divide_windowed(jc, tile_rows=R, window=W, n_windows=K)
    tw = t_win.divide_windowed(tc, tile_rows=R, window=W, n_windows=K)
    x = _x(tc.n_cols, 9, seed=5)
    got = TW.windowed_spmm_plan(tw, dtype=dtype, grad=False, device="cpu")(x)
    assert got.shape == (tc.n_rows, 9)
    assert _rel(got, JW.windowed_spmm_plan(jw, dtype=dtype, grad=False)(x)) < TOL
    if dtype is None:
        assert_allclose(got, spmm_scipy(tc, x))
        w = _x(tc.n_rows, 9, seed=6)
        want = jax.grad(lambda d: jnp.sum(JW.windowed_spmm_plan(jw)(d) * w))(
            jnp.asarray(x))
        xt = torch.tensor(x, requires_grad=True)
        (TW.windowed_spmm_plan(tw, device="cpu")(xt) * torch.as_tensor(w)).sum().backward()
        assert _rel(xt.grad, want) < TOL


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("W", [64, 2048])
def test_windowed_int8_plan_matches_jax(W, calibrated):
    """The exact int32 window products (W = 2,048: two f32 spans of 1,024
    columns added in int32), rescaled, and the f32 ELL remainder."""
    jc, tc = community_adj()
    jw = j_win.divide_windowed(jc, tile_rows=32, window=W)
    tw = t_win.divide_windowed(tc, tile_rows=32, window=W)
    x = _x(tc.n_cols, 8, seed=7)
    cal = x if calibrated else None
    got = TW.windowed_spmm_int8_plan(tw, calibration=cal, device="cpu")(x)
    want = JW.windowed_spmm_int8_plan(jw, calibration=cal)(x)
    assert _rel(got, want) < TOL
    assert _rel(got, spmm_scipy(tc, x)) < 6e-2


def test_int8_window_products_exact():
    """The span split gives int32 products bit for bit equal to int64
    ones, at the extremes (every entry +-127) over 2,500 columns."""
    rng = np.random.default_rng(8)
    q = rng.choice(np.array([-127, 127], np.int8), (2, 1, 4, 2500))
    wins = rng.choice(np.array([-127, 127], np.int8), (2, 1, 2500, 3))
    got = TW.int8_window_products(torch.as_tensor(q), torch.as_tensor(wins))
    want = np.matmul(q.astype(np.int64), wins.astype(np.int64))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("threshold", [None, 0.1])
def test_tiered_plan_matches_jax(threshold):
    """Windows, the dense blocks mined from their remainder and the ELL
    tail, summed."""
    jc, tc = community_adj()
    x = _x(tc.n_cols, 7, seed=9)
    kw = dict(tile_rows=16, window=32, block_size=32, density_threshold=threshold,
              grad=False)
    got = TW.tiered_spmm_plan(tc, device="cpu", **kw)(x)
    assert _rel(got, JW.tiered_spmm_plan(jc, **kw)(x)) < TOL
    assert_allclose(got, spmm_scipy(tc, x))


# -- the slice end to end -----------------------------------------------------

DIMS = [16, 32, 8]


def _gcn_pair():
    j_params = j_models.init_gcn(jax.random.PRNGKey(0), DIMS)
    j_np = [{k: np.asarray(v) for k, v in p.items()} for p in j_params]
    gcn = t_models.GCN(DIMS).load_params(t_models.gcn_params_from_jax(j_np))
    return j_params, gcn


@pytest.mark.parametrize("route", ["auto hybrid", "auto csr_ell", "hybrid",
                                   "hybrid int8"])
def test_gcn_slice_matches_jax(route):
    """The GCN through spmm_plan in both packages on the same graph: auto
    over the byte budget (the scorer picks a hybrid), auto past the fill
    guard on a weakly structured graph (csr_ell), the explicit hybrid and
    its int8 variant (JAX's int8 path: the same quantization, int32 or
    f32 sums of integers)."""
    kw = {"block_size": 32, "grad": False}
    if route == "auto csr_ell":
        jg = j_csr.random_csr(0.004, 512, seed=0, values="ones")
        tg = t_csr.random_csr(0.004, 512, seed=0, values="ones")
        jc, tc = j_models.sym_norm_adjacency(jg), t_models.sym_norm_adjacency(tg)
        kw = {"block_size": 128, "grad": False}
    else:
        jc, tc = community_adj()
    if route.startswith("auto"):
        kw["impl"] = "auto"
        kw["feat_dim"] = DIMS[0]
    if route == "auto hybrid":
        kw["bsr_bytes_budget"] = 100_000
    if route.startswith("hybrid"):
        kw["impl"] = "hybrid"
    jkw, tkw = dict(kw), dict(kw, device="cpu")
    if route == "hybrid int8":
        jkw["dtype"], tkw["dtype"] = jnp.int8, torch.int8
    jp, tp = j_ops.spmm_plan(jc, **jkw), t_ops.spmm_plan(tc, **tkw)
    want_tier = {"auto hybrid": "_pallas_apply", "auto csr_ell": "_ell_apply",
                 "hybrid": "_pallas_apply", "hybrid int8": "_int8_pallas_apply"}[route]
    first = tp if tp.subplans is None else tp.subplans[0]
    assert first.apply_fn.__name__ == want_tier
    j_params, gcn = _gcn_pair()
    x = _x(tc.n_rows, DIMS[0], seed=12)
    want = np.asarray(j_models.gcn_apply(j_params, jp, x))
    with torch.no_grad():
        got = gcn(tp, torch.as_tensor(x))
    assert got.shape == (tc.n_rows, DIMS[-1]) and torch.isfinite(got).all()
    assert _rel(got, want) < TOL
