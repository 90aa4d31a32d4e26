"""Host-side sharding of the port (parallel/shard.py and the ELL stripes
of parallel/spmm.py) against the JAX package's, bit for bit on the same
input: shard_bsr (uniform, boundaries=, payload=),
balanced_contiguous_boundaries, the index-payload pipeline, the bucketers,
shard_csr, shard_stats, pack_buckets_pallas in its three forms,
balanced_block_row_permutation and _ell_layout_stripes; and the port's
extras of each packed bucket (its walk over the real steps and lane
order). No processes."""

import numpy as np
import pytest

import spmm_denseblock_tpu.parallel.shard as JS
import spmm_denseblock_tpu.parallel.spmm as JP
import spmm_denseblock_tpu_torch.parallel.shard as TS
import spmm_denseblock_tpu_torch.parallel.spmm as TP
from spmm_denseblock_tpu.convert.csr2bsr import csr_to_bsr
from spmm_denseblock_tpu.formats.bsr import BSR, random_bsr
from spmm_denseblock_tpu.formats.csr import CSR, random_csr
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas import lane_order
from torch_parallel_cases import port_bsr, port_csr


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    assert np.array_equal(a, b)


def _eq_sharded(j, t):
    for f in ("local_rows", "block_cols", "blocks", "nnzb_per_shard"):
        _eq(getattr(j, f), getattr(t, f))
    assert (j.shape, j.block_size, j.rows_per_shard, j.col_chunk, j.nnzb) == (
        t.shape, t.block_size, t.rows_per_shard, t.col_chunk, t.nnzb)
    assert (j.boundaries is None) == (t.boundaries is None)
    if j.boundaries is not None:
        _eq(j.boundaries, t.boundaries)


def _band(n_br=48, b=8, seed=0):
    rows = np.repeat(np.arange(n_br), 3)
    cols = np.clip(np.arange(n_br)[:, None] + np.array([-1, 0, 1]), 0, n_br - 1).reshape(-1)
    vals = np.random.default_rng(seed).standard_normal((rows.size, b, b)).astype(np.float32)
    return BSR.from_parts(rows.astype(np.int32), cols.astype(np.int32), vals,
                          (n_br * b, n_br * b), b)


def _graded(n=64 * 8):
    rows_l, cols_l = [], []
    for r in range(n):
        k = 8 if r < n // 3 else (4 if r < 2 * n // 3 else 2)
        for j in range(k):
            rows_l.append(r)
            cols_l.append(min(n - 1, max(0, r - 4 + j)))
    return csr_to_bsr(CSR.from_coo(np.array(rows_l), np.array(cols_l), None, (n, n)), 8)


MATRICES = {
    "random": lambda: random_bsr(2e-2, 48, 48, block_size=8, seed=3),
    "ragged": lambda: random_bsr(0.2, 13, 11, block_size=8, seed=3),
    "deep": lambda: random_bsr(0.6, 16, 16, block_size=8, seed=21),
    "band": _band,
    "graded": _graded,
}


@pytest.mark.parametrize("name", list(MATRICES))
@pytest.mark.parametrize("n", [4, 8])
def test_shard_bsr_bitwise(name, n):
    jb = MATRICES[name]()
    tb = port_bsr(jb)
    _eq_sharded(JS.shard_bsr(jb, n), TS.shard_bsr(tb, n))
    pj, pt = JS.block_index_payload(jb.nnzb), TS.block_index_payload(tb.nnzb)
    _eq(pj, pt)
    _eq_sharded(JS.shard_bsr(jb, n, payload=pj), TS.shard_bsr(tb, n, payload=pt))
    bj = JS.balanced_contiguous_boundaries(jb, n)
    bt = TS.balanced_contiguous_boundaries(tb, n)
    _eq(bj, bt)
    _eq_sharded(JS.shard_bsr(jb, n, boundaries=bj), TS.shard_bsr(tb, n, boundaries=bt))
    assert JS.shard_stats(JS.shard_bsr(jb, n)) == TS.shard_stats(TS.shard_bsr(tb, n))


@pytest.mark.parametrize("name", list(MATRICES))
def test_bucketers_bitwise(name):
    jb = MATRICES[name]()
    tb = port_bsr(jb)
    for payload in (False, True):
        kj = {"payload": JS.block_index_payload(jb.nnzb)} if payload else {}
        kt = {"payload": TS.block_index_payload(tb.nnzb)} if payload else {}
        sj, st = JS.shard_bsr(jb, 4, **kj), TS.shard_bsr(tb, 4, **kt)
        for a, b in zip(JS.bucket_by_col_chunk(sj), TS.bucket_by_col_chunk(st)):
            _eq(a, b)
        for halo in (1, 2):
            hj, ht = JS.bucket_halo(sj, halo), TS.bucket_halo(st, halo)
            assert (hj is None) == (ht is None)
            if hj is not None:
                for a, b in zip(hj, ht):
                    _eq(a, b)
    if name == "graded":
        bj = JS.balanced_contiguous_boundaries(jb, 8)
        hj = JS.bucket_halo(JS.shard_bsr(jb, 8, boundaries=bj), 1)
        ht = TS.bucket_halo(TS.shard_bsr(tb, 8, boundaries=bj), 1)
        assert hj is not None
        for a, b in zip(hj, ht):
            _eq(a, b)


def test_index_payload_pipeline_bitwise():
    """The metadata-only path (shard, bucket, pack an index payload, the
    values gathered once at the end) equals the value-mode pipeline at
    every stage (JAX's test_index_payload_pipeline_bitwise on the
    port)."""
    tb = port_bsr(MATRICES["random"]())
    pay = TS.block_index_payload(tb.nnzb)
    blocks = np.asarray(tb.blocks[: tb.nnzb])
    shv, shp = TS.shard_bsr(tb, 4), TS.shard_bsr(tb, 4, payload=pay)
    _eq(shv.blocks, TS.materialize_packed(shp.blocks, blocks))
    for rg in (0, 4):
        a = TS.pack_buckets_pallas(shv.local_rows, shv.block_cols, shv.blocks,
                                   shv.rows_per_shard, group=4, rowgroup=rg)
        c = TS.pack_buckets_pallas(shp.local_rows, shp.block_cols, shp.blocks,
                                   shp.rows_per_shard, group=4, rowgroup=rg)
        _eq(a[0], c[0])
        _eq(a[1], c[1])
        _eq(a[2], TS.materialize_packed(c[2], blocks))
        assert a[3] == c[3]
        for x, y in zip(a[4], c[4]):
            _eq(x, y)
    lv, lp = TS.bucket_by_col_chunk(shv), TS.bucket_by_col_chunk(shp)
    _eq(lv[2], TS.materialize_packed(lp[2], blocks))
    band = port_bsr(_band())
    pay2 = TS.block_index_payload(band.nnzb)
    hv = TS.bucket_halo(TS.shard_bsr(band, 8), 1)
    hp = TS.bucket_halo(TS.shard_bsr(band, 8, payload=pay2), 1)
    _eq(hv[2], TS.materialize_packed(hp[2], np.asarray(band.blocks[: band.nnzb])))


FORMS = {
    "flat": {},
    "flat_g4": {"group": 4},
    "flat_deep": {"deep": True},
    "rowgroup_16": {"rowgroup": 16},
    "rowgroup_8_g2": {"rowgroup": 8, "group": 2},
    "sorted_f32": {"sorted_geom": (16, 4, 128)},
    "sorted_int8": {"sorted_geom": (8, 8, 32)},
}


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("bucketing", ["allgather", "ring", "halo"])
@pytest.mark.parametrize("name", ["random", "deep", "band"])
def test_pack_buckets_pallas_bitwise(form, bucketing, name):
    """JAX's four outputs bit for bit, then the port's extras per bucket:
    the pointer covers the bucket's real steps (the cross-bucket padding
    steps lie past it), the lane order is lane_order's of that pointer,
    and the padding steps hold only zero blocks."""
    jb = MATRICES[name]()
    tb = port_bsr(jb)
    sj, st = JS.shard_bsr(jb, 4), TS.shard_bsr(tb, 4)
    if bucketing == "allgather":
        bj = (sj.local_rows, sj.block_cols, sj.blocks)
        bt = (st.local_rows, st.block_cols, st.blocks)
    elif bucketing == "ring":
        bj, bt = JS.bucket_by_col_chunk(sj), TS.bucket_by_col_chunk(st)
    else:
        bj, bt = JS.bucket_halo(sj, 1), TS.bucket_halo(st, 1)
        if bj is None:
            assert bt is None
            return
    kw = FORMS[form]
    got = TS.pack_buckets_pallas(*bt, st.rows_per_shard, **kw)
    want = JS.pack_buckets_pallas(*bj, sj.rows_per_shard, **kw)
    for a, b in zip(want[:3], got[:3]):
        _eq(a, b)
    assert want[3] == got[3]
    walk = got[4]
    lead = np.asarray(got[0]).shape[:-1]
    sorted_form = "sorted_geom" in kw
    R = kw["sorted_geom"][0] if sorted_form else kw.get("rowgroup") or 1
    slots = R * got[3]
    T = got[0].shape[-1] // (1 + R) if sorted_form else got[0].shape[-1]
    ptr_i = 1 if sorted_form else 0
    for i in np.ndindex(*lead):
        ptr = walk[ptr_i][i]
        t = int(ptr[-1])
        assert ptr[0] == 0 and (np.diff(ptr) >= 0).all() and t <= T
        order, depth = lane_order(ptr, R, got[3])
        _eq(walk[ptr_i + 1][i], order)
        assert walk[-1][i] == depth
        # the padding steps past the pointer hold zero blocks
        assert not np.asarray(got[2][i][t * slots:]).any()
        if sorted_form:
            assert walk[0][i].dtype == bool and walk[0][i].shape == ((ptr.size - 1) * R,)
        elif R == 1:
            assert ptr.size == st.rows_per_shard + 1


def test_shard_csr_bitwise():
    jc = random_csr(0.03, 300, 200, seed=5)
    tc = port_csr(jc)
    for n in (4, 8):
        a, b = JS.shard_csr(jc, n), TS.shard_csr(tc, n)
        for f in ("local_rows", "col_ids", "vals"):
            _eq(getattr(a, f), getattr(b, f))
        assert (a.shape, a.rows_per_shard, a.nnz) == (b.shape, b.rows_per_shard, b.nnz)


@pytest.mark.parametrize("name", list(MATRICES))
@pytest.mark.parametrize("n", [4, 8])
def test_balanced_block_row_permutation_bitwise(name, n):
    jb = MATRICES[name]()
    _eq(JP.balanced_block_row_permutation(jb, n),
        TP.balanced_block_row_permutation(port_bsr(jb), n))


def _hub_csr():
    csr = random_csr(0.03, 300, 200, seed=5)
    s = csr.to_scipy().tolil()
    s[0, :150] = 1.5
    s[299, ::2] = -0.5
    return CSR.from_scipy(s.tocsr())


@pytest.mark.parametrize("compact", ["off", "force", "auto"])
@pytest.mark.parametrize("valued", [True, False])
@pytest.mark.parametrize("n", [4, 8])
def test_ell_layout_stripes_bitwise(compact, valued, n):
    jc = _hub_csr() if valued else random_csr(0.04, 280, 190, seed=9)
    if not valued:
        jc = CSR(indptr=jc.indptr, indices=jc.indices, data=None, shape=jc.shape)
    want = JP._ell_layout_stripes(jc, n, compact, 128)
    got = TP._ell_layout_stripes(port_csr(jc), n, compact, 128)
    for i in (0, 2, 5):
        _eq(want[i], got[i])
    assert (want[1] is None) == (got[1] is None)
    if want[1] is not None:
        _eq(want[1], got[1])
    assert want[3] == got[3] and want[4] == got[4]


def test_ell_layout_stripes_given_rows():
    """stripe_rows equal to JAX's contiguous stripes give JAX's arrays;
    other stripes give each row's nonzeros at its position."""
    jc = _hub_csr()
    tc = port_csr(jc)
    want = JP._ell_layout_stripes(jc, 4)
    rows_per = -(-jc.shape[0] // 4)
    stripes = [np.arange(s * rows_per, min((s + 1) * rows_per, jc.shape[0]))
               for s in range(4)]
    got = TP._ell_layout_stripes(tc, 4, stripe_rows=stripes)
    for i in (0, 2):
        _eq(want[i], got[i])
    _eq(want[1], got[1])
    assert want[3] == got[3]
    perm = np.random.default_rng(0).permutation(jc.shape[0])
    stripes = np.array_split(perm, 4)
    idx, val, pos, layout, _, _ = TP._ell_layout_stripes(tc, 4, stripe_rows=stripes)
    dense = jc.to_scipy().toarray()
    x = np.random.default_rng(1).standard_normal((jc.shape[1] + 1, 3))
    x[-1] = 0
    for s in range(4):
        outs, off = [], 0
        for m, K, _ in layout:
            g = x[idx[s, off:off + m * K]] * val[s, off:off + m * K, None]
            outs.append(g.reshape(m, K, 3).sum(1))
            off += m * K
        got_s = np.concatenate(outs)[pos[s]][: len(stripes[s])]
        np.testing.assert_allclose(got_s, dense[stripes[s]] @ x[:-1], atol=1e-9)
