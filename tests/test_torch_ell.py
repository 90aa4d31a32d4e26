"""The port's ELL tier against the JAX package's: the native
unique_inverse equals JAX's native pass and np.unique bit for bit; the
ELL layout (classes, indices, values, positions, modes, compaction
spans, the chunk split) equals JAX's with its transposed chunks turned
back, under both bucket schemes and both row orders, valued and
pattern-only, and so does the banded layout; the plans' answers match
JAX's: f32 and bf16 within 1e-5 of max |JAX| (only the order of the f32
sums differs), pattern-only int8 bit for bit (int32 sums), valued and
calibrated int8 within 1e-5; grad plans' gradients within 1e-5 of
jax.grad's."""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmm_denseblock_tpu.formats.csr as j_csr
import spmm_denseblock_tpu.native as j_native
import spmm_denseblock_tpu_torch.formats.csr as t_csr
import spmm_denseblock_tpu_torch.native as t_native

JE = importlib.import_module("spmm_denseblock_tpu.ops.csr_spmm_ell")
TE = importlib.import_module("spmm_denseblock_tpu_torch.ops.csr_spmm_ell")

torch.set_num_threads(2)

TOL = 1e-5


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _x(n, F, seed):
    return np.random.default_rng(seed).standard_normal((n, F)).astype(np.float32)


def _pair(rows, cols, shape, valued=True, seed=0):
    """The same COO in both packages, with seeded values or none."""
    vals = (np.random.default_rng(seed).random(len(rows)).astype(np.float32) + 0.5
            if valued else None)
    return (j_csr.CSR.from_coo(rows, cols, vals, shape),
            t_csr.CSR.from_coo(rows, cols, vals, shape))


def _skewed(n_rows=300, n_cols=200, seed=1, valued=True, empty=(3, 4, 50)):
    """Degrees from 0 to ~60 (a few hub rows, some empty rows), so that
    the quarter and pow2 schemes give many classes."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(1.6, n_rows), 60)
    deg[list(empty)] = 0
    rows = np.repeat(np.arange(n_rows), deg)
    cols = rng.integers(0, n_cols, rows.size)
    key = np.unique(rows * n_cols + cols)
    return _pair(key // n_cols, key % n_cols, (n_rows, n_cols), valued, seed)


def _untransposed(layout_out):
    """JAX's _ell_layout result with every chunk it stores transposed
    ((K, m): "matsumT" and "scan") turned back to (m, K), "matsumT" named
    "matsum", as the port stores it."""
    idx, vals, pos, layout, has_vals = layout_out
    out_idx, out_vals, out_layout = [], [], []
    for i, (m, K, mode, band, compacted) in enumerate(layout):
        flip = mode in ("matsumT", "scan")

        def back(a):
            return np.ascontiguousarray(np.asarray(a).T) if flip else np.asarray(a)

        out_idx.append((np.asarray(idx[i][0]), back(idx[i][1])) if compacted
                       else back(idx[i]))
        if vals:
            out_vals.append(back(vals[i]))
        out_layout.append((m, K, "matsum" if mode == "matsumT" else mode, band,
                           compacted))
    return out_idx, out_vals, np.asarray(pos), tuple(out_layout), has_vals


def assert_layout_equal(t_out, j_out):
    """Bit-equal layouts: the port's against JAX's turned back."""
    t_idx, t_vals, t_pos, t_layout, t_hv = t_out
    j_idx, j_vals, j_pos, j_layout, j_hv = _untransposed(j_out)
    assert t_layout == j_layout
    assert t_hv == j_hv
    np.testing.assert_array_equal(t_pos, j_pos)
    assert len(t_idx) == len(j_idx) and len(t_vals) == len(j_vals)
    for a, b in zip(t_idx, j_idx):
        if isinstance(b, tuple):
            assert isinstance(a, tuple)
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
            assert a[0].dtype == np.int32 and a[1].dtype == np.int32
        else:
            np.testing.assert_array_equal(a, b)
            assert a.dtype == np.int32
    for a, b in zip(t_vals, j_vals):
        np.testing.assert_array_equal(a, b)


# -- unique_inverse -----------------------------------------------------------


@pytest.mark.parametrize("case", ["random", "repeats", "one", "empty", "full"])
def test_unique_inverse_bit_equal(case):
    """The port's native pass equals JAX's native pass and np.unique; its
    "python" body is np.unique; values out of range raise."""
    rng = np.random.default_rng(4)
    n_vals = 500
    seg = {
        "random": rng.integers(0, n_vals, 3000),
        "repeats": np.repeat(rng.integers(0, n_vals, 40), 25),
        "one": np.array([n_vals - 1]),
        "empty": np.zeros(0, np.int64),
        "full": np.arange(n_vals)[::-1],
    }[case].astype(np.int32)
    want_u, want_i = np.unique(seg, return_inverse=True)
    for impl in ("native", "python"):
        u, inv = t_native.unique_inverse(seg, n_vals, impl=impl)
        assert u.dtype == np.int32 and inv.dtype == np.int32
        np.testing.assert_array_equal(u, want_u)
        np.testing.assert_array_equal(inv, want_i.reshape(-1))
    j = j_native.unique_inverse(seg, n_vals)
    if j is not None:  # JAX's engine built here
        np.testing.assert_array_equal(u, j[0])
        np.testing.assert_array_equal(inv, j[1])
    with pytest.raises(ValueError, match="values must lie"):
        t_native.unique_inverse(np.array([n_vals], np.int32), n_vals)


# -- the layout ---------------------------------------------------------------


@pytest.mark.parametrize("valued", [True, False])
@pytest.mark.parametrize("row_sort", ["keep", "meancol"])
@pytest.mark.parametrize("bucket", ["quarter", "pow2"])
def test_ell_layout_bit_equal(bucket, row_sort, valued):
    """Classes, indices (pads at row 0 valued, at the zero row n_cols
    pattern-only), values, positions and modes; every chunk (m, K)."""
    jc, tc = _skewed(valued=valued)
    t_out = TE._ell_layout(tc, bucket, "auto", row_sort)
    assert_layout_equal(t_out, JE._ell_layout(jc, bucket, "auto", row_sort))
    idx, vals, pos, layout, has_vals = t_out
    assert has_vals == valued
    assert {K for _, K, *_ in layout} == set(np.unique(TE._row_widths(tc.degrees(), bucket)))
    pad = 0 if valued else tc.n_cols
    m, K = layout[0][:2]  # the K = 1 class holds the empty rows' pads
    assert K == 1 and (idx[0] == pad).any()
    assert all(c.shape == (m_, K_) for c, (m_, K_, *_) in zip(idx, layout))


@pytest.mark.parametrize("valued", [True, False])
def test_chunk_split_bit_equal(valued, monkeypatch):
    """CHUNK_SLOTS at 64 in both modules: classes split into chunks of at
    most 64 slots, as in JAX."""
    monkeypatch.setattr(JE, "CHUNK_SLOTS", 64)
    monkeypatch.setattr(TE, "CHUNK_SLOTS", 64)
    jc, tc = _skewed(valued=valued)
    t_out = TE._ell_layout(tc)
    assert_layout_equal(t_out, JE._ell_layout(jc))
    layout = t_out[3]
    assert len(layout) > len({K for _, K, *_ in layout})
    assert all(m * K <= 64 or m == 1 for m, K, *_ in layout)
    x = _x(tc.n_cols, 5, seed=2)
    got = TE.csr_spmm_ell_plan(tc, grad=False, device="cpu")(x)
    assert _rel(got, JE.csr_spmm_ell_plan(jc, grad=False)(x)) < TOL


def _wide_class(n_rows=4500, n_cols=300, seed=5, valued=True):
    """4,500 rows of degree 3 or 4 (one quarter class of K = 4, and
    the K = 3 class), so a class exceeds _SCAN_MIN_M = 4,096 rows."""
    rng = np.random.default_rng(seed)
    deg = np.where(np.arange(n_rows) < 4200, 4, 3)
    rows = np.repeat(np.arange(n_rows), deg)
    cols = (rows * 7 + np.concatenate([np.arange(d) for d in deg]) * 37) % n_cols
    return _pair(rows, cols, (n_rows, n_cols), valued, seed)


@pytest.mark.parametrize("valued", [True, False])
def test_scan_reduce_bit_equal_and_matches_jax(valued):
    """reduce="scan" on a class of 4,200 rows: a scan chunk (JAX stores it
    (K, m)), the smaller class matsum; the answers match JAX's."""
    jc, tc = _wide_class(valued=valued)
    t_out = TE._ell_layout(tc, reduce="scan")
    assert_layout_equal(t_out, JE._ell_layout(jc, reduce="scan"))
    modes = {(m, K): mode for m, K, mode, *_ in t_out[3]}
    assert modes == {(300, 3): "matsum", (4200, 4): "scan"}
    x = _x(tc.n_cols, 6, seed=3)
    for kw in ({}, {"dtype": "bfloat16"}):
        got = TE.csr_spmm_ell_plan(tc, grad=False, reduce="scan", device="cpu", **kw)(x)
        want = JE.csr_spmm_ell_plan(jc, grad=False, reduce="scan", **kw)(x)
        assert _rel(got, want) < TOL
    got = TE.csr_spmm_ell_int8_plan(tc, reduce="scan", device="cpu")(x)
    want = np.asarray(JE.csr_spmm_ell_int8_plan(jc, reduce="scan")(x))
    assert _rel(got, want) < TOL


def _local_rows(n_rows=400, n_cols=2000, seed=6, valued=True):
    """Rows whose neighbours lie in a narrow window that moves with the
    row, so a span's unique neighbours are far fewer than its slots."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(2, 9, n_rows)
    rows = np.repeat(np.arange(n_rows), deg)
    cols = (rows * 3 + rng.integers(0, 40, rows.size)) % n_cols
    key = np.unique(rows * n_cols + cols)
    return _pair(key // n_cols, key % n_cols, (n_rows, n_cols), valued, seed)


@pytest.mark.parametrize("valued", [True, False])
@pytest.mark.parametrize("compact,feat_dim", [("force", 128), ("auto", 1 << 16),
                                              ("auto", 128)])
def test_compaction_bit_equal(compact, feat_dim, valued):
    """compact="force" compacts every span; "auto" at feat_dim 2^16 (a 524
    MB f32 table, past the model's fast and mid brackets) compacts where
    the model predicts a win, and at 128 (a 1 MB table) never: the spans
    (uniq, inverse) equal JAX's, and so do the answers."""
    jc, tc = _local_rows(valued=valued)
    kw = dict(compact=compact, compact_slots=256, feat_dim=feat_dim)
    t_out = TE._ell_layout(tc, **kw)
    assert_layout_equal(t_out, JE._ell_layout(jc, **kw))
    n_compacted = sum(c for *_, c in t_out[3])
    if compact == "force":
        assert n_compacted == len(t_out[3])
    elif feat_dim == 128:
        assert n_compacted == 0
    else:
        assert 0 < n_compacted
    x = _x(tc.n_cols, 7, seed=4)
    got = TE.csr_spmm_ell_plan(tc, grad=False, device="cpu", **kw)(x)
    assert _rel(got, JE.csr_spmm_ell_plan(jc, grad=False, **kw)(x)) < TOL
    got = TE.csr_spmm_ell_int8_plan(tc, device="cpu", **kw)(x)
    want = np.asarray(JE.csr_spmm_ell_int8_plan(jc, **kw)(x))
    if valued:
        assert _rel(got, want) < TOL
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("valued", [True, False])
@pytest.mark.parametrize("band_rows", [16, 64])
def test_banded_layout_and_plan(band_rows, valued):
    """The banded split and in-band layout equal JAX's (local indices,
    every chunk valued, a 0/1 mask for pattern-only), and the banded
    plan's answer matches JAX's and scipy's."""
    jc, tc = _skewed(valued=valued)
    t_row_start, t_mask = TE._banded_split(tc, band_rows)
    j_row_start, j_mask = JE._banded_split(jc, band_rows)
    np.testing.assert_array_equal(t_row_start, j_row_start)
    np.testing.assert_array_equal(t_mask, j_mask)
    t_out = TE._ell_layout_banded(tc, band_rows, "quarter")
    j_out = JE._ell_layout_banded(jc, band_rows, "quarter")
    assert_layout_equal(t_out[:4] + (True,), j_out[:4] + (True,))
    for a, b in zip(t_out[4], j_out[4]):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    assert {band for *_, band, _ in t_out[3]} - {-1} != {0}  # several bands
    x = _x(tc.n_cols, 5, seed=5)
    for kw in ({}, {"dtype": "bfloat16"}):
        got = TE.csr_spmm_ell_banded_plan(tc, band_rows, grad=False, device="cpu", **kw)(x)
        want = JE.csr_spmm_ell_banded_plan(jc, band_rows, grad=False, **kw)(x)
        assert _rel(got, want) < TOL
    from spmm_denseblock_tpu_torch.ops import assert_allclose, spmm_scipy

    assert_allclose(TE.csr_spmm_ell_banded_plan(tc, band_rows, grad=False,
                                                device="cpu")(x), spmm_scipy(tc, x))


# -- the plans ----------------------------------------------------------------


@pytest.mark.parametrize("valued", [True, False])
@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("bucket", ["quarter", "pow2"])
def test_plan_matches_jax(bucket, dtype, valued):
    """f32 and bf16 answers within 1e-5 of max |JAX|; f32 within the
    reference's 1e-4 gate of scipy; F not a multiple of anything."""
    jc, tc = _skewed(valued=valued)
    x = _x(tc.n_cols, 13, seed=6)
    got = TE.csr_spmm_ell_plan(tc, grad=False, dtype=dtype, bucket=bucket,
                               device="cpu")(x)
    want = JE.csr_spmm_ell_plan(jc, grad=False, dtype=dtype, bucket=bucket)(x)
    assert got.dtype == torch.float32 and got.shape == (tc.n_rows, 13)
    assert _rel(got, want) < TOL
    if dtype is None:
        from spmm_denseblock_tpu_torch.ops import assert_allclose, spmm_scipy

        assert_allclose(got, spmm_scipy(tc, x))


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("valued", [True, False])
def test_int8_plan_matches_jax(valued, calibrated):
    """Pattern-only int8 bit for bit (int32 sums, the same quantization
    and rescale); valued within 1e-5; dynamic and calibrated scales."""
    jc, tc = _skewed(valued=valued)
    x = _x(tc.n_cols, 9, seed=7)
    cal = _x(64, 9, seed=8) * 1.5 if calibrated else None
    got = TE.csr_spmm_ell_int8_plan(tc, calibration=cal, device="cpu")(x)
    want = np.asarray(JE.csr_spmm_ell_int8_plan(jc, calibration=cal)(x))
    assert got.dtype == torch.float32
    if valued:
        assert _rel(got, want) < TOL
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="inference-only"):
        TE.csr_spmm_ell_int8_plan(tc, grad=True, device="cpu")


@pytest.mark.parametrize("plan", ["ell", "banded"])
def test_grad_plan_matches_jax_grad(plan):
    """grad=True (the default): d sum(A X * G) / dX through the plan of
    Aᵀ, within 1e-5 of jax.grad through JAX's grad plan."""
    jc, tc = _skewed(n_rows=150, n_cols=120)
    x = _x(tc.n_cols, 6, seed=9)
    w = _x(tc.n_rows, 6, seed=10)
    if plan == "ell":
        jp, tp = JE.csr_spmm_ell_plan(jc), TE.csr_spmm_ell_plan(tc, device="cpu")
    else:
        jp = JE.csr_spmm_ell_banded_plan(jc, band_rows=32)
        tp = TE.csr_spmm_ell_banded_plan(tc, band_rows=32, device="cpu")
    want = jax.grad(lambda d: jnp.sum(jp(d) * w))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    (tp(xt) * torch.as_tensor(w)).sum().backward()
    assert _rel(xt.grad, want) < TOL


# the layouts the tests above build, each as the f32 kernel's flat arrays
FLAT_CASES = {
    **{f"{b} {rs} {'valued' if v else 'pattern'}": (_skewed, v, dict(bucket=b, row_sort=rs))
       for b in ("quarter", "pow2") for rs in ("keep", "meancol") for v in (True, False)},
    **{f"compact {c} {fd} {'valued' if v else 'pattern'}": (
        _local_rows, v, dict(compact=c, compact_slots=256, feat_dim=fd))
       for c, fd in (("force", 128), ("auto", 1 << 16), ("auto", 128)) for v in (True, False)},
    **{f"scan {'valued' if v else 'pattern'}": (_wide_class, v, dict(reduce="scan"))
       for v in (True, False)},
    **{f"chunk split {'valued' if v else 'pattern'}": (_skewed, v, dict(chunk_slots=64))
       for v in (True, False)},
}


@pytest.mark.parametrize("case", list(FLAT_CASES))
def test_flat_layout_walk_matches_chunks(case, monkeypatch):
    """The f32 kernel's view of each layout above: the flat columns
    (compacted chunks resolved) and values hold each row's CSR entries in
    order at its slot start, its segments (at most SEGMENT_NNZ slots,
    stored entries only) cover them once and store into the caller's row
    or its partial rows; walked by a plain loop in float64, segment by
    segment and the split rows' partials in order, they give the chunk
    loop's answer (_run_chunks: the plan on the CPU) within 1e-5."""
    make, valued, kw = FLAT_CASES[case]
    kw = dict(kw)
    monkeypatch.setattr(TE, "CHUNK_SLOTS", kw.pop("chunk_slots", TE.CHUNK_SLOTS))
    monkeypatch.setattr(TE, "row_segments", functools.partial(TE.row_segments,
                                                              seg_nnz=5))
    _, tc = make(valued=valued)
    plan = TE.csr_spmm_ell_plan(tc, grad=False, device="cpu", **kw)
    arrs = [a.numpy() for a in plan.arrays]
    cols, vals = arrs[1], arrs[2] if valued else None
    seg_start, seg_end, seg_dest, split_row, part_ptr = arrs[-5:]
    assert cols.dtype == np.int32 and cols.size == TE._slots(plan.statics[1])
    assert plan.statics[4] == part_ptr[-1]
    indptr = np.asarray(tc.indptr, np.int64)
    deg = np.diff(indptr)
    # each row's segments, in its partial rows' order: its stored entries,
    # once, from its slot start
    row_of = seg_dest.copy()
    for h, r in enumerate(split_row):
        row_of[np.isin(-seg_dest - 1, np.arange(part_ptr[h], part_ptr[h + 1]))] = r
    assert (row_of >= 0).all() and sorted(split_row) == list(np.flatnonzero(deg > 5))
    walked = np.zeros(tc.n_rows, np.int64)
    first = np.full(tc.n_rows, -1, np.int64)
    for i in np.lexsort((-seg_dest, row_of)):  # a split row's partials in order
        s0, s1, r = seg_start[i], seg_end[i], row_of[i]
        assert 0 < s1 - s0 <= 5 or deg[r] == 0
        first[r] = s0 if first[r] < 0 else first[r]
        assert s0 == first[r] + walked[r]
        walked[r] += s1 - s0
    np.testing.assert_array_equal(walked, deg)
    for r in range(tc.n_rows):
        span = slice(first[r], first[r] + deg[r])
        np.testing.assert_array_equal(cols[span], tc.indices[indptr[r]:indptr[r + 1]])
        if valued:
            np.testing.assert_array_equal(vals[span], tc.data[indptr[r]:indptr[r + 1]])
    # the walk, in float64
    x = _x(tc.n_cols, 6, seed=12)
    out = np.zeros((tc.n_rows, 6))
    partial = np.zeros((part_ptr[-1], 6))
    for s0, s1, dest in zip(seg_start, seg_end, seg_dest):
        v = vals[s0:s1, None] if valued else 1.0
        acc = (x[cols[s0:s1]].astype(np.float64) * v).sum(0)
        if dest >= 0:
            out[dest] = acc
        else:
            partial[-dest - 1] = acc
    for h, r in enumerate(split_row):
        out[r] = partial[part_ptr[h]:part_ptr[h + 1]].sum(0)
    got = plan(x)
    assert _rel(got, out) < TOL
    assert _rel(TE._ell_apply(plan.statics, plan.arrays, x, plain=True), out) < TOL


@pytest.mark.parametrize("shape", [(7, 5), (0, 5)])
def test_empty_matrix(shape):
    """No nonzeros: every row is one pad slot and the answer is zeros;
    no rows: no layout at all. As in JAX, in every plan."""
    jc = j_csr.CSR.from_coo([], [], None, shape)
    tc = t_csr.CSR.from_coo([], [], None, shape)
    x = _x(shape[1], 4, seed=11)
    for t, j in ((TE.csr_spmm_ell_plan(tc, grad=False, device="cpu"),
                  JE.csr_spmm_ell_plan(jc, grad=False)),
                 (TE.csr_spmm_ell_int8_plan(tc, device="cpu"),
                  JE.csr_spmm_ell_int8_plan(jc))):
        got = t(x)
        want = np.asarray(j(x))
        assert got.shape == want.shape == (shape[0], 4)
        np.testing.assert_array_equal(got.numpy(), want)


def test_rejections():
    """dtype=int8 on the cast-based plans raises ValueError (the quantized
    tier), as do an unknown bucket, row order or compact mode."""
    _, tc = _skewed()
    with pytest.raises(ValueError, match="int8"):
        TE.csr_spmm_ell_plan(tc, dtype=torch.int8, device="cpu")
    with pytest.raises(ValueError, match="int8"):
        TE.csr_spmm_ell_banded_plan(tc, dtype="int8", device="cpu")
    for kw, what in (({"bucket": "cube"}, "bucket"), ({"row_sort": "x"}, "row_sort"),
                     ({"compact": "yes"}, "compact")):
        with pytest.raises(ValueError, match=what):
            TE.csr_spmm_ell_plan(tc, grad=False, device="cpu", **kw)
