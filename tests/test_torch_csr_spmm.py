"""The port's CSR tier against the JAX package: the band layout of K10 is
bit-equal and its row_ptr covers exactly the real slots, K10's plain
version matches the Pallas kernel run in interpret mode on the same
arrays, the csr_pallas plan (forward and grad plan), csr_xla (chunked
too) and bcoo match their JAX twins and the scipy oracle, every CSR tier
passes the conformance edge cases, a GCN serves and trains through
csr_pallas like the JAX one, and every entry point defaults to the card.

Tolerances: plain version vs the Pallas kernel on the same arrays, 1e-5
relative to max |want| (exact f32 products, f32 sums in another order);
plans against JAX and against scipy, the reference's 1e-4 gate
(assert_allclose); gradients and training losses, 1e-5 relative (as
tests/test_torch_train.py)."""

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
import spmm_denseblock_tpu_torch.bench as t_bench
import spmm_denseblock_tpu_torch.formats.bsr as t_bsr
import spmm_denseblock_tpu_torch.formats.csr as t_csr
import spmm_denseblock_tpu_torch.models as t_models
import spmm_denseblock_tpu_torch.ops as t_ops
import spmm_denseblock_tpu_torch.parallel as t_parallel
import spmm_denseblock_tpu_torch.utils as t_utils
from spmm_denseblock_tpu.models.train import make_train_step as j_make_train_step
from spmm_denseblock_tpu_torch.ops import _kernels, assert_allclose, spmm_scipy
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas import plain_apply

# the ops packages export functions of the modules' names, so `import
# ... as` would bind the function
JP = importlib.import_module("spmm_denseblock_tpu.ops.csr_spmm_pallas")
TP = importlib.import_module("spmm_denseblock_tpu_torch.ops.csr_spmm_pallas")
JX = importlib.import_module("spmm_denseblock_tpu.ops.csr_spmm")
TX = importlib.import_module("spmm_denseblock_tpu_torch.ops.csr_spmm")

torch.set_num_threads(2)

TOL = 1e-5


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _pair(p, n_rows, n_cols, seed, empty=()):
    """The same seeded CSR in both packages, with the rows `empty`
    dropped."""
    src = t_csr.random_csr(p, n_rows, n_cols, seed=seed)
    rows = src.row_ids()
    keep = ~np.isin(rows, empty)
    parts = (rows[keep], src.indices[keep], src.data[keep], (n_rows, n_cols))
    return j_csr.CSR.from_coo(*parts), t_csr.CSR.from_coo(*parts)


def _x(n, F, seed):
    return np.random.default_rng(seed).standard_normal((n, F)).astype(np.float32)


# -- the band layout ----------------------------------------------------------


@pytest.mark.parametrize("R,C", [(64, 128), (256, 1024)])
def test_band_layout_bit_equal_and_row_ptr_spans(R, C):
    """600 rows: rows 0-9 empty (empty head rows) and rows 256-511 empty
    (empty bands at both R), the last band ragged. The JAX packer's four
    arrays are bit-equal; row_ptr's spans hold each row's nonzeros in
    order, cover exactly the real slots, and miss every dummy."""
    jc, tc = _pair(0.04, 600, 300, seed=1, empty=list(range(10)) + list(range(256, 512)))
    want = JP._band_layout(jc, R, C)
    got = TP._band_layout(tc, R, C)
    assert len(got) == 5
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b)
    cols_pad, lrows, vals, band, row_ptr = got
    indptr = tc.indptr.astype(np.int64)
    deg = np.diff(indptr)
    assert row_ptr.shape == (tc.n_rows + 1,) and row_ptr.dtype == np.int64
    covered = np.zeros(cols_pad.size, np.int64)
    for r in range(tc.n_rows):
        s = slice(row_ptr[r], row_ptr[r] + deg[r])
        np.testing.assert_array_equal(cols_pad[s], tc.indices[indptr[r]:indptr[r + 1]])
        np.testing.assert_array_equal(vals.reshape(-1)[s], tc.data[indptr[r]:indptr[r + 1]])
        np.testing.assert_array_equal(lrows.reshape(-1)[s], r % R)
        covered[s] += 1
    assert covered.max() == 1 and covered.sum() == tc.nnz
    assert row_ptr[-1] == row_ptr[-2] + deg[-1]
    # the dummies: col 0, val 0, outside every span; an empty band's
    # chunk is all dummies
    assert not cols_pad[covered == 0].any() and not vals.reshape(-1)[covered == 0].any()
    assert (covered.reshape(-1, C).sum(axis=1) == 0).any()


def test_band_layout_empty_matrices():
    for shape in ((10, 12), (0, 12)):
        jc = j_csr.CSR.from_coo([], [], None, shape)
        tc = t_csr.CSR.from_coo([], [], None, shape)
        for a, b in zip(JP._band_layout(jc, 4, 8), TP._band_layout(tc, 4, 8)):
            np.testing.assert_array_equal(np.asarray(a), b)
        row_ptr = TP._band_layout(tc, 4, 8)[4]
        assert row_ptr.shape == (shape[0] + 1,)


# -- K10's plain version against the Pallas kernel --------------------------


def test_segment_plain_matches_pallas_kernel():
    """_pallas_segment_matmul (interpret mode) on the JAX packer's arrays
    and the XLA gather, against spmm_csr_segment_plain on the same
    arrays: 200 x 150 at R=64, C=128 (10 chunks, band 1 empty). The CPU
    wrapper runs the plain version and launches nothing."""
    _, tc = _pair(0.03, 200, 150, seed=2, empty=list(range(64, 128)))
    R, C, F = 64, 128, 128
    cols_pad, lrows, vals, band, row_ptr = TP._band_layout(tc, R, C)
    assert band.size <= 16
    x = _x(150, F, seed=3)
    want = np.asarray(JP._pallas_segment_matmul(
        jnp.asarray(band), jnp.asarray(lrows), jnp.asarray(vals),
        jnp.asarray(x)[jnp.asarray(cols_pad)], -(-200 // R), R, F,
        jax.lax.Precision.HIGHEST, True))[:200]
    segments = TP.row_segments(row_ptr, tc.indptr)
    args = [torch.as_tensor(a) for a in (cols_pad, lrows, vals, band, row_ptr,
                                         *segments)]
    args += [torch.as_tensor(x), R, int(segments[4][-1])]
    launches = [k.launches for k in _kernels.KERNELS]
    got = TP.spmm_csr_segment_plain(*args)
    assert got.shape == (200, F) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < TOL
    assert not got[64:128].any()
    assert torch.equal(TP.spmm_csr_segment(*args), got)
    assert [k.launches for k in _kernels.KERNELS] == launches


def _segment_case(seg_nnz, longest_first=False):
    """Rows of 0 to 40 nonzeros (duplicates kept) and an empty band, then
    rows of 300 and 1,000: (csr, band layout, row_segments' arrays)."""
    rng = np.random.default_rng(seg_nnz)
    deg = rng.integers(0, 41, size=150)
    deg[64:128] = 0
    deg[[20, 140]] = (300, 1000)
    rows = np.repeat(np.arange(150), deg)
    cols = rng.integers(0, 90, size=rows.size)
    tc = t_csr.CSR.from_coo(rows, cols, rng.random(rows.size), (150, 90))
    layout = TP._band_layout(tc, 64, 128)
    return tc, layout, TP.row_segments(layout[4], tc.indptr, seg_nnz, longest_first)


def _walk_product(tc, layout, segments, seg_nnz):
    """The kernel's walk, emulated in numpy: sum each segment into C or a
    partial row, then each split row's partials in order; checks the
    segments' shape on the way."""
    cols_pad, _, vals, _, _ = layout
    seg_start, seg_end, seg_dest, split_row, part_ptr = segments
    d = np.diff(tc.indptr.astype(np.int64))
    assert (seg_end - seg_start <= seg_nnz).all() and (seg_end >= seg_start).all()
    n_seg = np.maximum(1, -(-d // seg_nnz))
    assert seg_start.size == n_seg.sum()
    np.testing.assert_array_equal(split_row, np.nonzero(n_seg > 1)[0])
    assert part_ptr[-1] == (seg_dest < 0).sum() == n_seg[n_seg > 1].sum()
    x = _x(90, 6, seed=seg_nnz)
    out = np.full((150, 6), np.nan)
    partial = np.full((part_ptr[-1], 6), np.nan)
    for s0, s1, dest in zip(seg_start, seg_end, seg_dest):
        acc = (vals.reshape(-1)[s0:s1, None] * x[cols_pad[s0:s1]]).sum(axis=0)
        if dest >= 0:
            out[dest] = acc
        else:
            partial[-dest - 1] = acc
    for h, r in enumerate(split_row):
        out[r] = partial[part_ptr[h]:part_ptr[h + 1]].sum(axis=0)
    return out, x


@pytest.mark.parametrize("seg_nnz", [4, 16, 512])
def test_row_segments_walk_computes_the_product(seg_nnz):
    """The kernel's walk, emulated in numpy on row_segments' arrays: the
    segments tile each row's span in order, none longer than seg_nnz,
    empty rows get one empty segment; summing each segment into C or a
    partial row, then each split row's partials in order, gives A @ X.
    Rows of 0 to 40 nonzeros (duplicates kept), an empty band, two long
    rows."""
    tc, layout, segments = _segment_case(seg_nnz)
    assert (np.diff(segments[0]) >= 0).all()  # row order
    out, x = _walk_product(tc, layout, segments, seg_nnz)
    assert_allclose(out, spmm_scipy(tc, x))


@pytest.mark.parametrize("seg_nnz", [4, 16, 512])
def test_row_segments_longest_first(seg_nnz):
    """longest_first (the one-bf16-pass plan's order): the same segments
    as row order, in order of their batches of 32 slots, most first and
    in row order among equals; the walk on them gives the same A @ X."""
    tc, layout, rows = _segment_case(seg_nnz)
    _, _, segments = _segment_case(seg_nnz, longest_first=True)
    seg_start, seg_end, seg_dest, split_row, part_ptr = segments
    batches = -(-(seg_end - seg_start) // TP.SEGMENT_BATCH)
    assert (np.diff(batches) <= 0).all()
    for b in np.unique(batches):  # row order among equals
        assert (np.diff(seg_start[batches == b]) >= 0).all()
    key = lambda s: sorted(zip(s[0].tolist(), s[1].tolist(), s[2].tolist()))  # noqa: E731
    assert key(segments) == key(rows)
    np.testing.assert_array_equal(split_row, rows[3])
    np.testing.assert_array_equal(part_ptr, rows[4])
    out, x = _walk_product(tc, layout, segments, seg_nnz)
    want, _ = _walk_product(tc, layout, rows, seg_nnz)
    np.testing.assert_array_equal(out, want)
    if seg_nnz == 512:
        assert (seg_end - seg_start)[:2].tolist() == [512, 488]  # row 140's


def test_default_plan_orders_segments_longest_first():
    """A precision="default" plan holds its segments longest first, an
    f32 plan in row order; the same answer on the CPU."""
    tc, _, _ = _segment_case(512)
    f32 = TP.csr_spmm_pallas_plan(tc, grad=False, device="cpu")
    bf16 = TP.csr_spmm_pallas_plan(tc, precision="default", grad=False, device="cpu")
    assert (np.diff(f32.arrays[5].numpy()) >= 0).all()
    lengths = (bf16.arrays[6] - bf16.arrays[5]).tolist()
    assert lengths[:3] == [512, 488, 300]
    x = _x(90, 8, seed=1)
    assert torch.equal(bf16(x), TP.spmm_csr_segment_plain(
        *bf16.arrays, torch.as_tensor(x).to(torch.bfloat16), bf16.statics[2],
        bf16.statics[4]))


# -- whole plans --------------------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"chunk": 128, "row_band": 64}])
def test_csr_pallas_plan_matches_jax_and_scipy(kw):
    jc, tc = _pair(0.08, 200, 150, seed=11, empty=(5, 6, 7))
    x = _x(150, 40, seed=4)
    jp = JP.csr_spmm_pallas_plan(jc, grad=False, **kw)
    tp = TP.csr_spmm_pallas_plan(tc, grad=False, device="cpu", **kw)
    got = tp(x)
    assert got.shape == (200, 40) and got.dtype == torch.float32
    assert_allclose(got, np.asarray(jp(x)))
    assert_allclose(got, spmm_scipy(tc, x))
    # f_tile changes nothing; a bf16 operand is cast to f32
    same = TP.csr_spmm_pallas_plan(tc, grad=False, f_tile=128, device="cpu", **kw)
    assert torch.equal(same(x), got)
    xb = torch.as_tensor(x).to(torch.bfloat16)
    assert torch.equal(tp(xb), tp(xb.float()))


def test_csr_pallas_grad_plan_matches_jax():
    """The rectangular 200 x 150 case of test_ops.py (Aᵀ is another
    matrix): the default plan is a grad plan of A's and Aᵀ's plans; its
    output and the gradient of sum(sin(C)) match jax.grad through the
    JAX plan, and the dense oracle."""
    jc, tc = _pair(0.08, 200, 150, seed=11)
    kw = {"chunk": 128, "row_band": 64}
    jp = JP.csr_spmm_pallas_plan(jc, **kw)
    tp = TP.csr_spmm_pallas_plan(tc, device="cpu", **kw)
    fwd, bwd = tp.arrays
    assert fwd.statics[:2] == (200, 150) and bwd.statics[:2] == (150, 200)
    x = _x(150, 40, seed=5)
    jg = jax.grad(lambda v: jnp.sum(jnp.sin(jp(v))))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = tp(xt)
    torch.sin(out).sum().backward()
    assert xt.grad.shape == (150, 40) and xt.grad.dtype == torch.float32
    assert _rel(xt.grad.numpy(), jg) < TOL
    a = tc.to_dense().astype(np.float64)
    want = a.T @ np.cos(a @ x.astype(np.float64))
    assert_allclose(xt.grad, want)
    assert torch.equal(plain_apply(tp, x), out.detach())


@pytest.mark.parametrize("chunk_nnz", [None, 37])
def test_csr_xla_matches_jax(chunk_nnz):
    """csr_xla (gather, scale, index_add in f32) against csr_spmm_plan,
    whole and split into chunks of 37 nonzeros (a sum_plan): outputs and
    the gradient of <C, G> (autograd against jax.vjp)."""
    jc, tc = _pair(0.05, 120, 90, seed=9, empty=(3,))
    x = _x(90, 16, seed=6)
    g = _x(120, 16, seed=7)
    jp = JX.csr_spmm_plan(jc, chunk_nnz=chunk_nnz)
    tp = TX.csr_spmm_plan(tc, chunk_nnz=chunk_nnz, device="cpu")
    assert (tp.subplans is not None) == (chunk_nnz is not None)
    jout, jvjp = jax.vjp(jp, jnp.asarray(x))
    (jgrad,) = jvjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    out = tp(xt)
    out.backward(torch.as_tensor(g))
    assert out.shape == (120, 16) and out.dtype == torch.float32
    assert _rel(out.detach().numpy(), jout) < TOL
    assert _rel(xt.grad.numpy(), jgrad) < TOL
    assert_allclose(out.detach(), spmm_scipy(tc, x))
    assert not out.detach()[3].any()


def test_bcoo_matches_jax_with_duplicates():
    """bcoo keeps duplicate entries (an edge list with repeated edges,
    implicit ones), as the JAX BCOO does with unique_indices=False: both
    products count each copy. Gradient through torch.sparse.mm too."""
    rng = np.random.default_rng(8)
    edges = rng.integers(0, 64, size=(400, 2))
    edges = np.concatenate([edges, edges[:50]])
    jc = j_csr.CSR.from_edges(edges, 64, 48 + 16)
    tc = t_csr.CSR.from_edges(edges, 64, 48 + 16)
    x = _x(64, 12, seed=9)
    want = np.asarray(JX.bcoo_spmm_plan(jc)(x))
    tp = TX.bcoo_spmm_plan(tc, device="cpu")
    xt = torch.tensor(x, requires_grad=True)
    out = tp(xt)
    assert_allclose(out.detach(), want)
    assert_allclose(out.detach(), spmm_scipy(tc, x))
    assert out.detach().abs().max() > 0
    out.sum().backward()
    assert_allclose(xt.grad, tc.to_dense().T @ np.ones((64, 12), np.float32))


# -- conformance edge cases (tests/test_conformance.py) ---------------------


def _cases():
    yield "square", t_csr.random_csr(0.08, 48, 48, seed=1)
    yield "rect_wide", t_csr.random_csr(0.08, 24, 72, seed=2)
    yield "rect_tall", t_csr.random_csr(0.08, 72, 24, seed=3)
    yield "ones_adjacency", t_csr.random_csr(0.1, 40, 40, seed=4, values="ones")
    yield "single_row", t_csr.CSR.from_coo([0, 0], [3, 17], [1.0, 2.0], (1, 32))
    yield "single_col", t_csr.CSR.from_coo([2, 9], [0, 0], [1.5, -2.0], (16, 1))
    yield "empty", t_csr.CSR.from_coo([], [], None, (10, 12))
    rows = np.repeat(np.arange(5, 20), 3)
    cols = (rows * 2 + np.tile(np.arange(3), 15)) % 21
    yield "empty_head_rows", t_csr.CSR.from_coo(rows, cols, None, (25, 21))


@pytest.mark.parametrize("impl", ["csr_xla", "csr_pallas", "bcoo"])
@pytest.mark.parametrize("case", list(_cases()), ids=lambda c: c[0])
def test_csr_tiers_match_oracle(impl, case, rng):
    """The eight edge cases of the conformance matrix, F in (1, 7, 16),
    through spmm_plan as that test calls it, against scipy at 1e-4."""
    name, csr = case
    for f_dim in (1, 7, 16):
        x = rng.standard_normal((csr.n_cols, f_dim)).astype(np.float32)
        want = spmm_scipy(csr, x)
        plan = t_ops.spmm_plan(csr, impl=impl, block_size=8, device="cpu")
        got = plan(x)
        assert got.shape == want.shape, (impl, name)
        assert_allclose(got, want)


# -- routing ------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["csr_xla", "csr_pallas", "bcoo"])
def test_spmm_plan_routes_bsr_input_to_csr_tiers(impl):
    """A BSR input goes through bsr_to_csr (every stored block cell,
    clipped to the logical shape) in both routers."""
    src = t_bsr.random_bsr(0.3, 6, 5, block_size=8, seed=4)
    parts = (src.block_rows, src.block_cols, src.blocks, (45, 37), 8)
    jp = j_ops.spmm_plan(j_bsr.BSR.from_parts(*parts), impl=impl)
    tp = t_ops.spmm_plan(t_bsr.BSR.from_parts(*parts), impl=impl, device="cpu")
    x = _x(37, 9, seed=10)
    assert_allclose(tp(x), np.asarray(jp(x)))
    assert_allclose(tp(x), spmm_scipy(t_bsr.BSR.from_parts(*parts), x))


def test_csr_pallas_rejections():
    """An unknown precision raises ValueError, and precision="default",
    once refused, is ported (one bf16 pass: within the bf16 gate of
    JAX's answer, its values held in bf16); dtype=int8 on csr_pallas
    fails in both routers, whose CSR planner takes no dtype; the ELL,
    hybrid and windowed tiers, which raised before the port had them, now
    answer on the same input (int8 at its 6e-2 gate)."""
    jc, tc = _pair(0.1, 30, 20, seed=12)
    x = _x(20, 5, seed=13)
    one_pass = TP.csr_spmm_pallas_plan(tc, precision="default", device="cpu")
    assert one_pass.arrays[0].arrays[2].dtype == torch.bfloat16
    want = np.asarray(JP.csr_spmm_pallas_plan(jc, precision="default")(x))
    # the bf16 gate of tests/test_conformance.py: max |err| / max |ref|
    assert np.abs(one_pass(x).numpy() - want).max() / np.abs(want).max() < 3e-2
    with pytest.raises(ValueError, match="precision"):
        TP.csr_spmm_pallas_plan(tc, precision="high", device="cpu")
    with pytest.raises(TypeError, match="dtype"):
        j_ops.spmm_plan(jc, impl="csr_pallas", dtype=jnp.int8)
    with pytest.raises(TypeError, match="dtype"):
        t_ops.spmm_plan(tc, impl="csr_pallas", dtype=torch.int8, device="cpu")
    assert {"csr_xla", "csr_pallas", "bcoo"} <= set(t_ops.PLANNERS)
    x = _x(20, 6, seed=13)
    for impl in ("csr_ell", "csr_ell_int8", "hybrid", "windowed"):
        got = t_ops.spmm_plan(tc, impl=impl, block_size=8, device="cpu")(x)
        want = spmm_scipy(tc, x)
        if impl == "csr_ell_int8":
            assert _rel(got, want) < 6e-2
        else:
            assert_allclose(got, want)


# -- the GCN through csr_pallas -----------------------------------------------

DIMS = [16, 32, 5]


def _graph_pair():
    j_adj = j_models.sym_norm_adjacency(j_csr.random_csr(0.05, 256, seed=3))
    t_adj = t_models.sym_norm_adjacency(t_csr.random_csr(0.05, 256, seed=3))
    np.testing.assert_array_equal(np.asarray(j_adj.data), t_adj.data)
    return j_adj, t_adj


def test_gcn_forward_and_adam_steps_match_jax():
    """One forward and 3 Adam steps of make_train_step through csr_pallas
    (the default grad plan: K10 on A and on Aᵀ) from the same weights:
    the logits, every step's loss and accuracy, and the weights after 3
    steps agree with the JAX package (optax.adam(1e-2))."""
    j_adj, t_adj = _graph_pair()
    j_spmm = j_ops.spmm_plan(j_adj, impl="csr_pallas")
    t_spmm = t_ops.spmm_plan(t_adj, impl="csr_pallas", device="cpu")
    assert t_spmm.apply_fn.__name__ == "_grad_apply"
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, DIMS[0])).astype(np.float32)
    y = rng.integers(0, DIMS[-1], size=256).astype(np.int32)
    mask = (rng.random(256) < 0.6).astype(np.float32)
    j_params = j_models.init_gcn(jax.random.PRNGKey(0), DIMS)
    j_np = [{k: np.asarray(v) for k, v in p.items()} for p in j_params]
    t_params = t_models.gcn_params_from_jax(j_np)
    with torch.no_grad():
        logits = t_models.gcn_apply(t_params, t_spmm, torch.as_tensor(x))
    assert_allclose(logits, np.asarray(j_models.gcn_apply(j_params, j_spmm, x)))
    j_step, j_init = j_make_train_step(j_models.gcn_apply, j_spmm, optax.adam(1e-2))
    t_step, t_init = t_models.make_train_step(
        t_models.gcn_apply, t_spmm, functools.partial(torch.optim.Adam, lr=1e-2))
    j_state, t_state = j_init(j_params), t_init(t_params)
    for _ in range(3):
        j_params, j_state, jm = j_step(j_params, j_state, x, y, mask)
        t_params, t_state, tm = t_step(t_params, t_state, x, y, mask)
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= TOL * float(jm["loss"])
        assert float(tm["acc"]) == pytest.approx(float(jm["acc"]), abs=1e-6)
    for jp_, tp_ in zip(j_params, t_params):
        for k in ("w", "b"):
            assert _rel(tp_[k].detach().numpy(), jp_[k]) < 1e-4


# -- the card is the default device ------------------------------------------


def _in_world_of_1(build):
    """build(**kw) inside a gloo world of one rank (a file store in the
    working directory), torn down after."""
    import tempfile

    import torch.distributed as dist

    def run(**kw):
        store = tempfile.mkdtemp(dir=".")
        dist.init_process_group("gloo", init_method=f"file://{store}/store",
                                world_size=1, rank=0)
        try:
            return build(**kw)
        finally:
            dist.destroy_process_group()

    return run


def _entry_points():
    csr = t_csr.random_csr(0.5, 40, 40, seed=0)  # auto: bsr_pallas
    bsr = t_bsr.random_bsr(0.3, 4, 4, block_size=8, seed=0)
    xy = np.ones((40, 3), np.float32)
    from spmm_denseblock_tpu_torch.entry import entry
    from spmm_denseblock_tpu_torch.ops import (
        bsr_spmm_int8_plan,
        bsr_spmm_pallas_int8_plan,
        bsr_spmm_pallas_plan,
        bsr_spmm_xla_plan,
    )

    return {
        "spmm_plan": lambda **kw: t_ops.spmm_plan(csr, **kw),
        "spmm_plan_csr_pallas": lambda **kw: t_ops.spmm_plan(csr, impl="csr_pallas", **kw),
        "spmm_plan_dense": lambda **kw: t_ops.spmm_plan(csr, impl="dense", **kw),
        "csr_spmm_plan": lambda **kw: TX.csr_spmm_plan(csr, **kw),
        "bcoo_spmm_plan": lambda **kw: TX.bcoo_spmm_plan(csr, **kw),
        "csr_spmm_pallas_plan": lambda **kw: TP.csr_spmm_pallas_plan(csr, **kw),
        "bsr_spmm_pallas_plan": lambda **kw: bsr_spmm_pallas_plan(bsr, **kw),
        "bsr_spmm_pallas_int8_plan": lambda **kw: bsr_spmm_pallas_int8_plan(bsr, **kw),
        "bsr_spmm_int8_plan": lambda **kw: bsr_spmm_int8_plan(bsr, **kw),
        "bsr_spmm_xla_plan": lambda **kw: bsr_spmm_xla_plan(bsr, **kw),
        "entry": lambda **kw: entry(**kw),
        "dist_bsr_spmm_plan": _in_world_of_1(
            lambda **kw: t_parallel.dist_bsr_spmm_plan(bsr, **kw)),
        "dist_csr_spmm_plan": _in_world_of_1(
            lambda **kw: t_parallel.dist_csr_spmm_plan(csr, **kw)),
        "dense_block_gemm": lambda **kw: t_ops.dense_block_gemm(
            bsr.block_rows, bsr.block_cols, bsr.blocks,
            np.ones((4, 8, 3), np.float32), 4, **kw),
        "sddmm": lambda **kw: t_ops.sddmm(csr, xy, xy, **kw),
        "sddmm_plan": lambda **kw: t_ops.sddmm_plan(csr, **kw),
        "sddmm_block_plan": lambda **kw: t_ops.sddmm_block_plan(
            bsr.block_rows, bsr.block_cols, 8, 32, 32, **kw),
        "count_nnzb_device": lambda **kw: t_ops.count_nnzb_device(
            csr.row_ids(), csr.indices, 5, 8, **kw),
        "csr_to_bsr_device": lambda **kw: t_ops.csr_to_bsr_device(
            csr.row_ids(), csr.indices, None, 5, 5, 8, 30, **kw),
        "csr_to_bsr_on_device": lambda **kw: t_ops.csr_to_bsr_on_device(csr, 8, **kw),
        "make_gat_apply": lambda **kw: t_models.make_gat_apply(csr, 2, **kw),
        "spmm_tune": lambda **kw: t_ops.spmm_tune(
            csr, xy, candidates=("csr_xla", "bsr_xla"), block_size=8, **kw)[0],
        "bench_synthetic_bsr": lambda **kw: t_bench.bench_synthetic_bsr(
            0.3, 8, 4, impl="bsr_xla", n_block_rows=4, **kw),
        "bench_synthetic_csr": lambda **kw: t_bench.bench_synthetic_csr(
            0.1, 4, n_rows=64, **kw),
        "bench_graph": lambda **kw: t_bench.bench_graph(
            "ogbn-arxiv", block_size=32, dim=4, impl="csr_xla", scale=0.002, **kw),
        "bench_train_step": lambda **kw: t_bench.bench_train_step(
            dims=(4, 8, 2), impl="csr_xla", scale=0.002, iters=1, **kw),
        "device_info": lambda **kw: t_utils.device_info(**kw),
    }


def _host_tensors(built) -> list:
    """The tensors an entry point's result holds (a plan's buffers, the
    entry's weights, an op's outputs); the converter's BSR container
    holds host arrays; a bench record or device_info names its device."""
    if isinstance(built, torch.nn.Module):
        return list(built.buffers())
    if torch.is_tensor(built):
        return [built]
    if isinstance(built, t_bsr.BSR):
        return [torch.as_tensor(built.blocks)]
    if isinstance(built, dict):
        where = built.get("device", built.get("platform"))
        return [torch.empty(0)] if where == "cpu" else []
    if all(torch.is_tensor(t) for t in built):
        return list(built)
    return [p["w"] for p in built[1][0]]


@pytest.mark.parametrize("name", list(_entry_points()))
def test_default_device_is_the_card(name, monkeypatch, tmp_path):
    """With no GPU (torch.cuda.is_available patched to False) an entry
    point given no device raises a RuntimeError naming the missing GPU,
    and returns no CPU plan; device="cpu" builds on the CPU."""
    monkeypatch.chdir(tmp_path)  # the bench runners cache graphs under ./tmp
    build = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="GPU"):
        build()
    with pytest.raises(RuntimeError, match="GPU"):
        build(device="cuda")
    tensors = _host_tensors(build(device="cpu"))
    assert tensors and all(t.device.type == "cpu" for t in tensors)


# -- K10's column strips --------------------------------------------------------

H100_L2 = 52_428_800  # the H100's L2 as the card reports it


@pytest.mark.parametrize("K,F,l2,want", [
    (1 << 17, 512, H100_L2, 64),    # the test_csrmm op shape: 8 strips
    (4267, 256, H100_L2, 256),      # ddi: X fits, one strip
    (1 << 17, 100, H100_L2, 64),    # ragged F: strips of 64 and 36
    (1000, 100, H100_L2, 100),      # ragged F that fits: one strip
    (1 << 16, 300, H100_L2, 128),
    (1 << 17, 512, 1 << 20, 32),    # tiny L2: one unit, however little fits
    (1 << 17, 20, 1 << 20, 20),     # F below one unit: one strip
    (0, 64, H100_L2, 64),
])
def test_csr_strip_width(K, F, l2, want):
    """The widest multiple of the 32-column unit whose (K, W) f32 slice
    of X fills at most 70% of the L2, capped at F."""
    W = TP.csr_strip_width(K, F, l2)
    assert W == want
    assert W == F or (W % TP.CSR_STRIP_UNIT == 0 and W < F)
    if F > W > TP.CSR_STRIP_UNIT:
        assert K * W * 4 <= 0.7 * l2 < K * (W + TP.CSR_STRIP_UNIT) * 4


@pytest.mark.parametrize("K,F,want", [
    (1 << 17, 512, 128),    # the op csr shape: 4 strips of 128
    (1 << 16, 300, 152),    # 2 strips, 152 + 148 (f32: 3 of 128)
    (4267, 256, 256),       # ddi: X fits, one strip
])
def test_csr_strip_width_bf16(K, F, want):
    """A bf16 operand (precision="default", csr_bf16_strip_width): F cut
    into the fewest strips of at most 256 columns whose (K, W) bf16 slice
    fills at most 85% of the L2, made equal and rounded up to a multiple
    of 8 columns."""
    W = TP.csr_bf16_strip_width(K, F, H100_L2)
    assert W == want
    if F > W:
        widest = min(TP.CSR_BF16_MAX_STRIP, int(0.85 * H100_L2) // (2 * K) // 8 * 8)
        assert W % TP.CSR_BF16_UNIT == 0 and W <= widest
        assert -(-F // W) == -(-F // widest)  # the fewest strips that fit


@pytest.mark.parametrize("K,F,n_strips,want", [
    (169_343, 128, 1, 128),  # the arxiv serve graph: its bf16 X is 83% of the L2
    (4267, 256, 1, 256),     # ddi: one strip
    (1 << 17, 512, 4, 128),  # the op csr shape
])
def test_csr_bf16_strips_are_equal(K, F, n_strips, want):
    """On the graphs the one-bf16-pass kernel serves, its strips are
    equal, each a multiple of 8 columns (one 16-byte load of bf16 a lane)
    and at most 256 (a warp's 32 lanes of them)."""
    W = TP.csr_bf16_strip_width(K, F, H100_L2)
    assert W == want and F % W == 0 and -(-F // W) == n_strips
    assert W % TP.CSR_BF16_UNIT == 0 and W <= TP.CSR_BF16_MAX_STRIP


def test_csr_bf16_strip_width_over_a_grid():
    """Over a grid of shapes and L2 sizes the bf16 rule gives F (one
    strip, at most 256 columns, that fits in 85% of the L2 or is one
    unit), or strips of a
    multiple of 8 columns, at most 256, that fit unless they are one
    unit, the last narrower than the others by less than 8 columns a
    strip."""
    for K in (1, 100, 4267, 1 << 14, 1 << 17, 1 << 20):
        for F in (1, 7, 8, 31, 64, 100, 128, 256, 257, 300, 512, 600):
            for l2 in (1 << 16, 1 << 20, 40 << 20, H100_L2):
                W = TP.csr_bf16_strip_width(K, F, l2)
                n = -(-F // W)
                assert 0 < W <= F
                assert W == TP.CSR_BF16_UNIT or K * W * 2 <= 0.85 * l2 or W == F < 8
                if n == 1:
                    assert W == F <= TP.CSR_BF16_MAX_STRIP
                    continue
                assert W % TP.CSR_BF16_UNIT == 0 and W <= TP.CSR_BF16_MAX_STRIP
                last = F - (n - 1) * W
                assert 0 < last <= W and W - last < TP.CSR_BF16_UNIT * n


def test_csr_strip_width_respects_the_unit():
    """Over a grid of shapes and L2 sizes W is F (one strip) or a
    positive multiple of the unit below F, and never wider than fits
    unless it is one unit."""
    for K in (1, 100, 4267, 1 << 14, 1 << 17, 1 << 20):
        for F in (1, 7, 31, 32, 33, 64, 100, 256, 512, 600):
            for l2 in (1 << 16, 1 << 20, 40 << 20, H100_L2):
                W = TP.csr_strip_width(K, F, l2)
                assert 0 < W <= F
                assert W == F or W % TP.CSR_STRIP_UNIT == 0
                assert W == min(F, TP.CSR_STRIP_UNIT) or K * W * 4 <= 0.7 * l2
