"""The port's int8 serving tier against the JAX package: the quantizers
(the kernel tier's operand quantization in both layouts too) and the
int8 plan's packed arrays are bit-equal, the plain versions of K6 (flat
gather), K7 (depth-sorted row groups, group-scale and per-slot scales),
K8 (consecutive row groups) and K9 (resident) match the JAX Pallas
kernels run in interpret mode on the same arrays, the plans match the
JAX plans and the scipy oracle, the layout policy and the int8 routing
of spmm_plan match, an int8 GCN serves like the JAX one, and the ctypes
signatures match the C entries.

Tolerances: plain version or plan vs the JAX kernel or plan on the same
quantized inputs, 1e-5 relative to max |want| (int8 products and their
sums are exact integers in both; only the order of the f32 scaled sums
differs). Against the scipy oracle, the int8 tier's 6e-2
(tests/test_conformance.py:80)."""

import ctypes
import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmm_denseblock_tpu.formats.bsr as j_bsr
import spmm_denseblock_tpu.io.datasets as j_ds
import spmm_denseblock_tpu.models as j_models
import spmm_denseblock_tpu.ops as j_ops
import spmm_denseblock_tpu_torch.formats.bsr as t_bsr
import spmm_denseblock_tpu_torch.io.datasets as t_ds
import spmm_denseblock_tpu_torch.models as t_models
import spmm_denseblock_tpu_torch.ops as t_ops
from spmm_denseblock_tpu_torch.ops import _kernels, spmm_scipy
from spmm_denseblock_tpu_torch.ops.reference import int8_exact_case
from test_torch_cuda_kernels import saturated_lane_case

JQ = importlib.import_module("spmm_denseblock_tpu.ops.bsr_spmm_int8")
JI = importlib.import_module("spmm_denseblock_tpu.ops.bsr_spmm_pallas_int8")
TQ = importlib.import_module("spmm_denseblock_tpu_torch.ops.bsr_spmm_int8")
TI = importlib.import_module("spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas_int8")
T = importlib.import_module("spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas")

torch.set_num_threads(2)

INT8_TOL = 6e-2  # the int8 tier's oracle gate
PARITY_TOL = 1e-5


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _operand(n, F, seed, zero_cols=(2,)):
    """Columns of very different magnitudes, some all zero."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, F)) * rng.uniform(0.01, 50.0, F)
    x[:, list(zero_cols)] = 0.0
    return x.astype(np.float32)


def _pair(p, nbr, nbc, b, seed, shape=None, empty=(), mixed=False):
    """The same seeded BSR in both packages. empty: block-rows to drop;
    mixed: scale some blocks by 1e3 and 1e-3, so the lanes of the
    group-scale layout mix magnitudes."""
    src = t_bsr.random_bsr(p, nbr, nbc, block_size=b, seed=seed)
    keep = ~np.isin(src.block_rows, empty)
    blocks = src.blocks[keep].copy()
    if mixed:
        mag = np.random.default_rng(seed).choice([1e-3, 1.0, 1e3], blocks.shape[0])
        blocks *= mag[:, None, None].astype(np.float32)
    parts = (src.block_rows[keep], src.block_cols[keep], blocks,
             shape or src.shape, b)
    return j_bsr.BSR.from_parts(*parts), t_bsr.BSR.from_parts(*parts)


# -- quantizers -------------------------------------------------------------


def test_quantize_blocks_bit_equal():
    rng = np.random.default_rng(0)
    blocks = (rng.standard_normal((40, 16, 16))
              * rng.uniform(1e-4, 1e4, (40, 1, 1))).astype(np.float32)
    blocks[[3, 17]] = 0.0  # zero blocks: scale 1, q 0
    jq, js = JQ.quantize_blocks(blocks)
    tq, ts = TQ.quantize_blocks(blocks)
    np.testing.assert_array_equal(jq, tq)
    np.testing.assert_array_equal(js, ts)
    assert tq.dtype == np.int8 and ts.dtype == np.float32
    assert (ts[[3, 17]] == 1.0).all() and not tq[[3, 17]].any()


@pytest.mark.parametrize("static", [False, True])
def test_quantize_per_column_bit_equal(static):
    """Dynamic scales (the operand's own) and static scales (from a
    calibration batch with its 5% margin), zero columns included."""
    x = _operand(300, 70, seed=1, zero_cols=(2, 40))
    cal = x[:100]
    if static:
        j_cs = JQ.static_col_scale(cal)
        t_cs = TQ.static_col_scale(torch.as_tensor(cal))
        np.testing.assert_array_equal(j_cs, t_cs)
        assert t_cs[2] == 1.0
        jq, jc = JI._quantize_cols_static(jnp.asarray(x), jnp.asarray(j_cs))
        tq, tc = TQ.quantize_per_column(torch.as_tensor(x), torch.as_tensor(t_cs))
        # calibration from a smaller batch: later rows can clip at 127
        assert (tq.abs() == 127).any()
    else:
        jq, jc = JI._quantize_cols(jnp.asarray(x))
        tq, tc = TQ.quantize_per_column(torch.as_tensor(x))
        assert tc[2] == 1.0 and not tq[:, 2].any()
    assert tq.dtype == torch.int8 and tc.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(jq), tq.numpy())
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())


NONFINITE_X = np.array([[1.0, np.nan, np.inf, 2.0],
                        [-3.0, 1.0, 1.0, -np.inf],
                        [0.5, 2.0, -1.0, 1.0]], np.float32)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("static", [False, True])
def test_quantize_nonfinite_matches_jax(static, transposed):
    """A NaN entry, and a +-Inf entry in a dynamic column (scale Inf, so
    Inf / Inf is NaN), quantize to 0; a static +-Inf entry to +-127:
    quantize_per_column and quantize_int8_plain (pad rows, both layouts)
    against JAX's _quantize_cols / _quantize_cols_static, bit for bit."""
    x = NONFINITE_X
    if static:
        ones = np.ones(4, np.float32)
        jq, jc = JI._quantize_cols_static(jnp.asarray(x), jnp.asarray(ones))
        cs = torch.ones(4)
        want = [[1, 0, 127, 2], [-3, 1, 1, -127], [0, 2, -1, 1]]
    else:
        jq, jc = JI._quantize_cols(jnp.asarray(x))
        cs = None
        want = [[42, 0, 0, 0], [-127, 1, 0, 0], [21, 2, 0, 0]]
    np.testing.assert_array_equal(np.asarray(jq), want)
    tq, tc = TQ.quantize_per_column(torch.as_tensor(x), cs)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    q, qc = TI.quantize_int8_plain(torch.as_tensor(x), 16, cs, transposed)
    rows = q.t() if transposed else q
    np.testing.assert_array_equal(rows[:3].numpy(), np.asarray(jq))
    assert not rows[3:].any()
    np.testing.assert_array_equal(qc.numpy(), np.asarray(jc))


def test_rejections_raise_value_error():
    for dtype in (torch.int8, "int8", np.int8):
        with pytest.raises(ValueError, match="truncate"):
            TQ.reject_int8_cast(dtype, "tier")
    TQ.reject_int8_cast(torch.bfloat16, "tier")
    TQ.reject_int8_cast(None, "tier")
    _, tb = _pair(0.3, 4, 4, 8, seed=0)
    for plan in (TI.bsr_spmm_pallas_int8_plan, TQ.bsr_spmm_int8_plan):
        with pytest.raises(ValueError, match="inference-only"):
            plan(tb, grad=True, device="cpu")
        plan(tb, grad=False, device="cpu")
    with pytest.raises(ValueError, match="inference-only"):
        t_ops.spmm_plan(tb, impl="bsr_pallas", dtype=torch.int8, grad=True, device="cpu")
    # an explicit f_tile is taken (it routes to the flat layout); with
    # resident=True (K9) it must divide the width rounded up to 128,
    # checked at call time, as in JAX
    assert TI.bsr_spmm_pallas_int8_plan(tb, f_tile=128, device="cpu").statics[0] == "flat"
    k9 = TI.bsr_spmm_pallas_int8_plan(tb, f_tile=96, resident=True, device="cpu")
    with pytest.raises(ValueError, match="f_tile"):
        k9(np.ones((tb.shape[1], 70), np.float32))
    # an int8 tier named directly takes dtype=int8 too
    plan = t_ops.spmm_plan(tb, impl="bsr_int8_pallas", dtype=torch.int8, device="cpu")
    assert plan.apply_fn.__module__.endswith(".bsr_spmm_pallas_int8")


# -- the plan's packed arrays ----------------------------------------------

LAYOUT_CASES = {
    # name: (JAX plan kwargs, port plan kwargs, layout)
    "flat": ({"resident": False}, {"resident": False}, "flat"),
    "sorted": ({"depth_sort": True}, {"depth_sort": True}, "sorted"),
    "rowgroup": ({"depth_sort": False}, {"depth_sort": False}, "rowgroup"),
    "sorted_per_slot": ({"depth_sort": True}, {"depth_sort": True,
                                               "group_scale": False}, "sorted"),
    "resident": ({"resident": True, "f_tile": 128},
                 {"resident": True, "f_tile": 128}, "resident"),
}


def _plans(case, jb, tb, monkeypatch, **kw):
    j_kw, t_kw, layout = LAYOUT_CASES[case]
    if case == "sorted_per_slot":
        monkeypatch.setenv("SDB_INT8_GROUP_SCALE", "0")
    jp = JI.bsr_spmm_pallas_int8_plan(jb, **j_kw, **kw)
    monkeypatch.delenv("SDB_INT8_GROUP_SCALE", raising=False)
    tp = TI.bsr_spmm_pallas_int8_plan(tb, **t_kw, **kw, device="cpu")
    assert tp.statics[0] == layout
    return jp, tp


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("case", list(LAYOUT_CASES))
def test_int8_plan_arrays_bit_equal(case, mixed, monkeypatch):
    """step_rows, slot_cols, qblocks, scales (and pos) equal the JAX
    plan's arrays. 21 block-rows (not a multiple of R=8: phantom and
    absent lanes), two empty rows; `mixed` puts blocks 1e6 apart in one
    lane-step, where the group scale zeroes the small ones in both."""
    jb, tb = _pair(0.4, 21, 19, 16, seed=5, empty=(3, 9), mixed=mixed)
    jp, tp = _plans(case, jb, tb, monkeypatch)
    assert len(jp.arrays) in (4, 5)
    for a, b in zip(jp.arrays, tp.arrays):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    qblocks, scales = tp.arrays[2], tp.arrays[3]
    assert qblocks.dtype == torch.int8 and scales.dtype == torch.float32
    n_slots = qblocks.shape[0]
    if case == "sorted":
        R, gh = tp.statics[5][:2]
        assert scales.shape == (n_slots // gh,)  # one per lane-step
    else:
        assert scales.shape == (n_slots,)        # one per slot


# -- plain versions vs the JAX kernels on the same arrays -----------------


def _quantized(tb, F, seed):
    x = _operand(tb.shape[1], F, seed)
    q, cs = TQ.quantize_per_column(torch.as_tensor(x))
    return q, cs


def test_k6_flat_plain_matches_pallas_kernel():
    _, tb = _pair(0.4, 21, 19, 16, seed=6, empty=(4,))
    tp = TI.bsr_spmm_pallas_int8_plan(tb, resident=False, device="cpu")
    step_rows, slot_cols, qblocks, scales, step_ptr = tp.arrays[:5]
    nbr, group = tp.statics[1], tp.statics[5]
    F = 128
    q, cs = _quantized(tb, F, seed=7)
    want = np.asarray(JI._pallas_int8_spmm(
        jnp.asarray(step_rows.numpy()), jnp.asarray(slot_cols.numpy()),
        jnp.asarray(qblocks.numpy()), jnp.asarray(scales.numpy()),
        jnp.asarray(q.numpy()), jnp.asarray(cs.numpy()),
        nbr, nbr * 16, F, group, True,
    ))
    got = TI.spmm_int8_flat_plain(step_rows, slot_cols, qblocks, scales, q, cs,
                                  nbr, group)
    assert got.shape == (nbr * 16, F) and got.dtype == torch.float32
    assert _rel(got, want) < PARITY_TOL
    assert torch.equal(TI.spmm_int8_flat(step_rows, step_ptr, slot_cols, qblocks,
                                         scales, q, cs, group), got)


@pytest.mark.parametrize("group_scale", [True, False])
def test_k7_sorted_plain_matches_pallas_kernel(group_scale):
    """21 block-rows at R=8 in windows of 32: the last group has absent
    lanes at pos 0, the same pos as a real row's."""
    _, tb = _pair(0.4, 21, 19, 16, seed=8, empty=(2,), mixed=True)
    tp = TI.bsr_spmm_pallas_int8_plan(tb, depth_sort=True, group_scale=group_scale,
                                      device="cpu")
    win_ids, slot_cols, qblocks, scales, pos, lane_valid, group_ptr = tp.arrays[:7]
    nbr = tp.statics[1]
    R, gh, W, gs = tp.statics[5]
    assert gs == group_scale and not lane_valid.all()
    F = 128
    q, cs = _quantized(tb, F, seed=9)
    n_win = -(-nbr // W)
    want = np.asarray(JI._pallas_int8_spmm_sorted(
        jnp.asarray(win_ids.numpy()), jnp.asarray(pos.numpy()),
        jnp.asarray(slot_cols.numpy()), jnp.asarray(scales.numpy()),
        jnp.asarray(qblocks.numpy()), jnp.asarray(q.numpy()).reshape(-1, 16, F),
        jnp.asarray(cs.numpy()), n_win, W, nbr * 16, F, gh, R, True,
        group_scale=group_scale,
    ))
    got = TI.spmm_int8_sorted_plain(win_ids, pos, slot_cols, qblocks, scales, q,
                                    cs, lane_valid, group_ptr, nbr, R, gh, W,
                                    group_scale)
    assert got.shape == (nbr * 16, F)
    assert _rel(got, want) < PARITY_TOL
    assert not got.reshape(nbr, 16, F)[2].any()


EXACT_CASES = {
    # name: (port plan kwargs, layout); the names index LAYOUT_CASES
    "sorted": ({"depth_sort": True}, "sorted"),
    "sorted_per_slot": ({"depth_sort": True, "group_scale": False}, "sorted"),
    "rowgroup": ({"depth_sort": False}, "rowgroup"),
    "flat": ({"resident": False}, "flat"),
    "resident": ({"resident": True, "f_tile": 128}, "resident"),
}


@pytest.mark.parametrize("nb", [7, 37])
@pytest.mark.parametrize("b", [64, 128])
@pytest.mark.parametrize("case", list(EXACT_CASES))
def test_int8_exact_case_plain_equals_float64(case, b, nb):
    """On int8_exact_case nothing rounds before the column scale, so the
    plain K6, K7 (both scale modes), K8 and K9 equal float64 bit for bit:
    37 block-rows leave absent lanes (K7) and phantom lanes (K8), 7 one
    phantom and one absent lane; F = 70 is ragged."""
    bsr, x, want = int8_exact_case(b, 70, seed=b + nb, n_block_rows=nb)
    kw, layout = EXACT_CASES[case]
    tp = TI.bsr_spmm_pallas_int8_plan(bsr, device="cpu", **kw)
    assert tp.statics[0] == layout
    got = tp(x)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.double().numpy(), want)
    assert torch.equal(T.plain_apply(tp, x), got)


@pytest.mark.parametrize("b", [64, 128])
@pytest.mark.parametrize("case", list(EXACT_CASES))
def test_int8_exact_case_matches_jax_plan(case, b, monkeypatch):
    """The JAX plan (Pallas in interpret mode) on int8_exact_case agrees
    with float64 and with the port within PARITY_TOL."""
    bsr, x, want = int8_exact_case(b, 70, seed=b, n_block_rows=7)
    n = bsr.nnzb
    jb = j_bsr.BSR.from_parts(bsr.block_rows[:n], bsr.block_cols[:n],
                              bsr.blocks[:n], bsr.shape, b)
    jp, tp = _plans(case, jb, bsr, monkeypatch)
    got = np.asarray(jp(x))
    assert _rel(got, want) < PARITY_TOL
    assert _rel(tp(x), got) < PARITY_TOL


def test_int8_exact_case_is_exact():
    """The case's blocks quantize to their integers in both scale modes,
    with scales that are powers of two, and its operand to itself."""
    bsr, x, want = int8_exact_case(64, 40, seed=3, n_block_rows=9)
    q, scales = TQ.quantize_blocks(bsr.blocks)
    assert (np.abs(q).max(axis=(1, 2)) == 127).all()
    np.testing.assert_array_equal(q * scales[:, None, None], bsr.blocks)
    assert (np.exp2(np.round(np.log2(scales))) == scales).all()
    qx, cs = TQ.quantize_per_column(torch.as_tensor(x))
    assert torch.equal(qx.float(), torch.as_tensor(x))
    assert want.shape == (9 * 64, 40) and (want != 0).mean() > 0.5


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("F", [1, 70, 133])
def test_quantize_operand_transposed_matches_jax(F, static):
    """quantize_operand(transposed=True), the operand K6-K9 read at b = 64
    and 128 (on the CPU, the kernel's plain version): JAX's
    _quantize_cols (or _quantize_cols_static) of the operand, transposed,
    bit for bit, then zero columns up to the block grid (n_cols = 19*16 -
    7 is not a multiple of b); the scales bit-equal; (F, N) contiguous on
    16 bytes; the (N, F) layout its transpose."""
    shape = (23 * 16 - 5, 19 * 16 - 7)
    _, tb = _pair(0.35, 23, 19, 16, seed=17, shape=shape)
    x = _operand(shape[1], F, seed=18, zero_cols=(0,))
    cal = x[:100] if static else None
    plan = TI.bsr_spmm_pallas_int8_plan(tb, calibration=cal, device="cpu")
    k_needed = plan.statics[4]
    assert k_needed == 19 * 16 > shape[1]
    qt, cs = TI.quantize_operand(plan, x, transposed=True)
    if static:
        jq, jc = JI._quantize_cols_static(jnp.asarray(x),
                                          jnp.asarray(JQ.static_col_scale(cal)))
    else:
        jq, jc = JI._quantize_cols(jnp.asarray(x))
    assert qt.shape == (F, k_needed) and qt.dtype == torch.int8
    assert qt.is_contiguous() and qt.data_ptr() % 16 == 0
    np.testing.assert_array_equal(qt[:, :shape[1]].numpy(), np.asarray(jq).T)
    assert not qt[:, shape[1]:].any()
    np.testing.assert_array_equal(cs.numpy(), np.asarray(jc))
    q, cs_rows = TI.quantize_operand(plan, x)
    assert q.shape == (k_needed, F) and torch.equal(q.t(), qt)
    assert torch.equal(cs_rows, cs)


@pytest.mark.parametrize("case", list(LAYOUT_CASES))
def test_run_quantized_takes_the_transposed_operand_alone(case):
    """run_quantized(plan, None, cs, qdense_t=) on every layout: the
    answer of the plan's own call (the operand in the ring's layout, as a
    plan's call on the card hands it to K6-K9)."""
    shape = (23 * 16 - 5, 19 * 16 - 7)
    _, tb = _pair(0.35, 23, 19, 16, seed=19, shape=shape, empty=(6,))
    x = _operand(shape[1], 70, seed=20)
    tp = TI.bsr_spmm_pallas_int8_plan(tb, **LAYOUT_CASES[case][1], device="cpu")
    qt, cs = TI.quantize_operand(tp, x, transposed=True)
    got = TI.run_quantized(tp, None, cs, qdense_t=qt)
    assert torch.equal(got, tp(x))
    assert torch.equal(TI.run_quantized(tp, None, cs, qdense_t=qt, plain=True), got)


def _c_entries(stem: str) -> dict:
    """{symbol: ctypes argument types} of the extern "C" entries of
    csrc/<stem>.cu, read from the source: pointers are c_void_p, int64_t
    c_int64."""
    src = (_kernels.INCLUDE_DIR / f"{stem}.cu").read_text()
    entries = {}
    for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src):
        kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int64
                 for p in params.split(",")]
        assert all("*" in p or "int64_t" in p for p in params.split(",")), name
        entries[name] = kinds
    return entries


@pytest.mark.parametrize("symbol", sorted(_kernels._SIGNATURES))
def test_kernel_signatures_match_the_c_entries(symbol):
    """Each ctypes signature in _kernels._SIGNATURES has the C entry's
    arity and argument kinds (a mismatch would pass garbage to the card
    without an error here); among them the operand quantization
    sdb_quantize_int8 and the K6/K9 entries, which take the transposed
    operand, the slot and operand-row counts and the tile width."""
    stem, argtypes = _kernels._SIGNATURES[symbol]
    assert _c_entries(stem)[symbol] == argtypes
    if symbol == "sdb_quantize_int8":
        assert argtypes == [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 5 + [ctypes.c_void_p]
    if symbol in ("sdb_bsr_spmm_int8_flat", "sdb_bsr_spmm_int8_resident"):
        assert argtypes == [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 7 + [ctypes.c_void_p]


def test_every_c_entry_has_a_counted_kernel():
    """Every extern "C" entry of csrc/ is declared and has its CudaKernel
    counter (the operand quantization's is quantize_int8)."""
    declared = {name for src in _kernels.SOURCES for name in _c_entries(src.stem)}
    assert declared == set(_kernels._SIGNATURES)
    assert {k.symbol for k in _kernels.KERNELS} == declared
    assert _kernels.quantize_int8.symbol == "sdb_quantize_int8"


def test_transpose_operand_is_aligned_and_contiguous():
    """The int8 ring's operand: (F, N), contiguous, on 16 bytes, equal to
    qdense.t(), from an operand 1 byte past a 16-byte boundary, from a
    non-contiguous one, and from the transpose of a contiguous (F, N)
    buffer 1 byte past a boundary (whose .t() needs no copy, but a move)."""
    q = torch.as_tensor(np.random.default_rng(0).integers(
        -127, 128, size=(128, 70)), dtype=torch.int8)

    def odd(shape):
        base = torch.empty(q.numel() + 16, dtype=torch.int8)
        skip = (1 - base.data_ptr()) % 16
        return base[skip:skip + q.numel()].view(shape)

    offset = odd(q.shape)
    offset.copy_(q)
    wide = torch.zeros(q.shape[0], q.shape[1] + 3, dtype=torch.int8)
    wide[:, 1:71] = q
    moved = odd((70, 128))
    moved.copy_(q.t())
    for view in (q, offset, wide[:, 1:71], moved.t()):
        qt = TI.transpose_operand(view)
        assert qt.shape == (70, 128) and qt.is_contiguous()
        assert qt.data_ptr() % 16 == 0 and torch.equal(qt, q.t())
    assert offset.data_ptr() % 16 == 1 and moved.data_ptr() % 16 == 1
    assert not wide[:, 1:71].is_contiguous() and moved.t().t().is_contiguous()


@pytest.mark.parametrize("b,n_rows,F,want", [
    # the small-block loop: 1,024 rows of 16 slots, no hub, the widest tile
    (16, 1024, 512, 128), (32, 1024, 512, 128),
    (128, 1024, 512, 128), (64, 1024, 512, 128),  # the op shape: 4,096 CTAs
    (128, 34, 256, 64),    # ddi: 68 CTAs at 128 columns would not fill the SMs
    (128, 1024, 64, 64),   # one 64-column tile holds F
])
def test_int8_tile_bn(b, n_rows, F, want):
    """The ring's width from the grid (b = 64 and 128), the small-block
    loop's from int8_small_geometry (b = 16 and 32), which needs the
    plan's deepest lane."""
    assert TI.int8_tile_bn(b, n_rows, F, 132, n_rows * 16, 16) == want
    if b < 64:
        assert TI.int8_tile_bn(b, n_rows, F, 132, n_rows * 16, 16) == (
            TI.int8_small_geometry(b, F, 132, n_rows * 16, 16))
        with pytest.raises(ValueError, match="deepest lane"):
            TI.int8_tile_bn(b, n_rows, F, 132)
    else:
        assert TI.int8_tile_bn(b, n_rows, F, 132) == want


@pytest.mark.parametrize("F,n_sms,n_slots,depth,want", [
    # the arxiv stand-in under gorder at b = 32: a hub lane of 5,150 of
    # 826,048 slots would take 1.23x its allowance at 128 columns
    (128, 132, 826_048, 5_150, 64),
    (128, 132, 960_704, 8_624, 64),    # b = 16 under gorder: 8,624 deep
    (128, 132, 826_048, 20_000, 32),   # a deeper hub: the narrowest tile
    (128, 132, 826_048, 100, 128),     # a flat plan: no lane stands out
    (8, 132, 826_048, 100, 32),        # F = 8 needs one 32-column tile
    (70, 132, 826_048, 100, 128),      # F = 70 needs more than 64 columns
    (133, 132, 826_048, 100, 128),
    (133, 132, 826_048, 5_150, 64),
    (128, 1, 826_048, 5_150, 128),     # one SM: the grid is one queue
])
def test_int8_small_geometry(F, n_sms, n_slots, depth, want):
    """int8_small_geometry is _small_bn at INT8_SMALL_HUB_SHARE: the
    widest of 128, 64 and 32 columns that F needs and at which the
    deepest lane's CTA stays within its share of the grid's work."""
    assert TI.INT8_SMALL_HUB_SHARE == 1.5
    for b in (16, 32):
        assert TI.int8_small_geometry(b, F, n_sms, n_slots, depth) == want


def test_group_scale_lane_sum_is_exact():
    """The plain version sums a lane in float64: its answer is the exact
    lane sum, scaled; a float32 running sum of the same products is not."""
    plan, x, exact = saturated_lane_case()
    assert plan.statics[5][:2] == (8, 16)
    assert plan.arrays[2].min() == 127
    got = plan(x)
    assert (got.numpy() == exact).all()
    running = np.float32(0)
    for _ in range(2048):
        running = np.float32(running + np.float32(16129))
    assert running != np.float32(33032192)


@pytest.mark.parametrize("nb", [7, 21])
def test_k8_rowgroup_plain_matches_pallas_kernel(nb):
    """7 block-rows at R=8: one group with a phantom lane, whose rows the
    JAX output holds and the port's does not."""
    _, tb = _pair(0.3, nb, nb, 32, seed=9)
    tp = TI.bsr_spmm_pallas_int8_plan(tb, depth_sort=False, device="cpu")
    step_groups, slot_cols, qblocks, scales, group_ptr = tp.arrays[:5]
    nbr = tp.statics[1]
    R, gh = tp.statics[5]
    F = 128
    q, cs = _quantized(tb, F, seed=10)
    want = np.asarray(JI._pallas_int8_spmm_rowgroup(
        jnp.asarray(step_groups.numpy()), jnp.asarray(slot_cols.numpy()),
        jnp.asarray(scales.numpy()), jnp.asarray(qblocks.numpy()),
        jnp.asarray(q.numpy()).reshape(-1, 32, F), jnp.asarray(cs.numpy()),
        group_ptr.shape[0] - 1, nbr * 32, F, gh, R, True,
    ))
    got = TI.spmm_int8_rowgroup_plain(step_groups, slot_cols, qblocks, scales,
                                      q, cs, nbr, R, gh)
    assert got.shape == (nbr * 32, F)
    assert _rel(got, want) < PARITY_TOL


def test_k9_resident_plain_matches_pallas_kernel():
    """K9's plain version, reading the operand as (nbc, b, F), against
    _pallas_int8_spmm_resident (interpret mode) on the arrays of the
    resident=True, f_tile=128 plan; the CPU wrapper runs it."""
    _, tb = _pair(0.4, 21, 19, 16, seed=13, empty=(4,))
    tp = TI.bsr_spmm_pallas_int8_plan(tb, resident=True, f_tile=128, device="cpu")
    assert tp.statics[0] == "resident"
    step_rows, slot_cols, qblocks, scales, step_ptr = tp.arrays[:5]
    nbr = tp.statics[1]
    group, f_tile = tp.statics[5]
    F = 128
    q, cs = _quantized(tb, F, seed=14)
    q3 = q.reshape(-1, 16, F)
    want = np.asarray(JI._pallas_int8_spmm_resident(
        jnp.asarray(step_rows.numpy()), jnp.asarray(slot_cols.numpy()),
        jnp.asarray(scales.numpy()), jnp.asarray(qblocks.numpy()),
        jnp.asarray(q3.numpy()), jnp.asarray(cs.numpy()),
        nbr, nbr * 16, f_tile, group, True,
    ))
    got = TI.spmm_int8_resident_plain(step_rows, slot_cols, qblocks, scales, q3,
                                      cs, nbr, group)
    assert got.shape == (nbr * 16, F) and got.dtype == torch.float32
    assert _rel(got, want) < PARITY_TOL
    assert not got.reshape(nbr, 16, F)[4].any()
    assert torch.equal(TI.spmm_int8_resident(step_rows, step_ptr, slot_cols,
                                             qblocks, scales, q3, cs, group), got)
    with pytest.raises(ValueError, match="nbc, b, F"):
        TI.spmm_int8_resident_plain(step_rows, slot_cols, qblocks, scales, q,
                                    cs, nbr, group)


@pytest.mark.parametrize("resident,layout", [(True, "resident"), (None, "flat")])
def test_explicit_f_tile_routes_like_jax(resident, layout):
    """An explicit f_tile turns the row-group layouts off in both
    packages: with resident=True the plan runs K9 (the only way to reach
    it), with resident=None K6. The packed arrays are bit-equal and the
    answers agree (ragged shape, F = 70)."""
    shape = (23 * 16 - 5, 19 * 16 - 7)
    jb, tb = _pair(0.35, 23, 19, 16, seed=15, shape=shape, empty=(6,))
    jp = JI.bsr_spmm_pallas_int8_plan(jb, f_tile=128, resident=resident)
    tp = TI.bsr_spmm_pallas_int8_plan(tb, f_tile=128, resident=resident,
                                      device="cpu")
    assert tp.statics[0] == layout
    assert jp.statics[-1] is None and jp.statics[-2] == resident  # no row groups
    assert len(jp.arrays) == 4
    for a, b in zip(jp.arrays, tp.arrays):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    x = _operand(shape[1], 70, seed=16)
    got = tp(x)
    assert got.shape == (shape[0], 70)
    assert _rel(got, np.asarray(jp(x))) < PARITY_TOL
    assert _rel(got, spmm_scipy(tb, x)) < INT8_TOL


# -- whole plans ------------------------------------------------------------


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("case", list(LAYOUT_CASES))
def test_int8_plan_matches_jax_plan(case, calibrated, monkeypatch):
    """Ragged shape (rows and cols not multiples of b, F = 70), each
    forced layout, dynamic and calibrated operand scales. Launch counts
    stay 0: CPU tensors take the plain versions."""
    shape = (23 * 16 - 5, 19 * 16 - 7)
    jb, tb = _pair(0.35, 23, 19, 16, seed=11, shape=shape, empty=(6,))
    x = _operand(shape[1], 70, seed=12)
    kw = {"calibration": x} if calibrated else {}
    launches = [k.launches for k in _kernels.KERNELS]
    jp, tp = _plans(case, jb, tb, monkeypatch, **kw)
    want = np.asarray(jp(x))
    got = tp(x)
    assert got.shape == (shape[0], 70) and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    assert _rel(got, want) < PARITY_TOL
    assert _rel(got, spmm_scipy(tb, x)) < INT8_TOL
    assert torch.equal(T.plain_apply(tp, x), got)
    assert [k.launches for k in _kernels.KERNELS] == launches


LANE_PTR = {
    # layout: (index of the group or step pointer, R and slots a step)
    "sorted": (6, lambda geom: geom[:2]),
    "rowgroup": (4, lambda geom: geom),
    "flat": (4, lambda geom: (1, geom)),
    "resident": (4, lambda geom: (1, geom[0])),
}


@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("case", list(LAYOUT_CASES))
def test_int8_plan_carries_its_lane_order(case, calibrated, monkeypatch):
    """Every int8 layout's plan holds, after its packed arrays, the CTA ->
    lane order of the kernels at b = 16 and 32, and its statics the
    deepest lane's slots, both as lane_order() gives them on the plan's
    group or step pointer; a calibrated plan's static column scales stay
    its last array. The plan still matches the JAX plan (b = 32, 37
    block-rows with empty rows, ragged shape, F = 70)."""
    shape = (37 * 32 - 5, 29 * 32 - 7)
    jb, tb = _pair(0.3, 37, 29, 32, seed=21, shape=shape, empty=(3, 30))
    x = _operand(shape[1], 70, seed=22)
    jp, tp = _plans(case, jb, tb, monkeypatch,
                    **({"calibration": x} if calibrated else {}))
    layout, geom = tp.statics[0], tp.statics[5]
    i, walk = LANE_PTR[layout]
    order, depth = T.lane_order(tp.arrays[i].numpy(), *walk(geom))
    assert tp.arrays[i + 1].dtype == torch.int32
    np.testing.assert_array_equal(tp.arrays[i + 1].numpy(), order)
    assert tp.statics[6] == depth > 0 and tp.statics[7] == calibrated
    assert len(tp.arrays) == i + 2 + calibrated
    if calibrated:
        np.testing.assert_array_equal(tp.arrays[-1].numpy(),
                                      TQ.static_col_scale(torch.as_tensor(x)))
    n_lanes = tp.arrays[i].shape[0] - 1
    if layout in ("sorted", "rowgroup"):
        n_lanes *= geom[0]
    assert sorted(order.tolist()) == list(range(n_lanes))
    got = tp(x)
    assert _rel(got, np.asarray(jp(x))) < PARITY_TOL
    assert torch.equal(T.plain_apply(tp, x), got)


def test_bsr_int8_tier_matches_jax_and_consecutive_layouts():
    """The plain bsr_int8 tier against the JAX XLA tier, and the
    consecutive layouts (flat, row groups) against it: they share
    quantize_blocks, so they agree up to the order of the sums."""
    jb, tb = _pair(0.3, 12, 10, 16, seed=3)
    x = _operand(tb.shape[1], 40, seed=4)
    got = TQ.bsr_spmm_int8_plan(tb, device="cpu")(x)
    assert got.shape == (tb.shape[0], 40)
    assert _rel(got, np.asarray(JQ.bsr_spmm_int8_plan(jb)(x))) < PARITY_TOL
    assert _rel(got, spmm_scipy(tb, x)) < INT8_TOL
    cal = TQ.bsr_spmm_int8_plan(tb, calibration=x, device="cpu")(x)
    assert _rel(cal, np.asarray(JQ.bsr_spmm_int8_plan(jb, calibration=x)(x))) < PARITY_TOL
    for kw in ({"resident": False}, {"depth_sort": False}):
        tp = TI.bsr_spmm_pallas_int8_plan(tb, **kw, device="cpu")
        assert _rel(tp(x), got) < PARITY_TOL


def _rows_with(depth, nb=24, b=8, seed=0):
    """nb block-rows with exactly `depth` blocks each."""
    rng = np.random.default_rng(seed)
    cols = np.stack([rng.choice(nb, depth, replace=False) for _ in range(nb)])
    rows = np.repeat(np.arange(nb), depth)
    blocks = rng.standard_normal((nb * depth, b, b)).astype(np.float32)
    return rows.astype(np.int32), cols.reshape(-1).astype(np.int32), blocks


@pytest.mark.parametrize("depth,kw,layout", [
    (9, {}, "sorted"),
    (7, {}, "rowgroup"),
    (9, {"resident": False}, "flat"),
    (9, {"resident": True}, "sorted"),
    (2, {"depth_sort": True}, "sorted"),
])
def test_int8_layout_matches_jax_plan(depth, kw, layout):
    """int8 sorts at >= 8 real blocks per block-row, packs consecutive
    row groups below, and resident=False gives the flat layout, in both
    packages."""
    rows, cols, blocks = _rows_with(depth)
    jp = JI.bsr_spmm_pallas_int8_plan(
        j_bsr.BSR.from_parts(rows, cols, blocks, (192, 192), 8), **kw)
    tp = TI.bsr_spmm_pallas_int8_plan(
        t_bsr.BSR.from_parts(rows, cols, blocks, (192, 192), 8), **kw, device="cpu")
    rowgroup = jp.statics[-1]
    j_layout = ("flat" if rowgroup is None else
                "sorted" if isinstance(rowgroup[0], str) else "rowgroup")
    assert tp.statics[0] == j_layout == layout
    x = _operand(192, 24, seed=2)
    assert _rel(tp(x), np.asarray(jp(x))) < PARITY_TOL


# -- routing and the serving slice ------------------------------------------


def _ddi(tmp_path):
    return (j_ds.load_dataset("ogbl-ddi", cache_dir=str(tmp_path / "j"), scale=0.1),
            t_ds.load_dataset("ogbl-ddi", cache_dir=str(tmp_path / "t"), scale=0.1))


def test_int8_routing_matches_jax(tmp_path):
    """dtype=int8 maps bsr_pallas -> bsr_int8_pallas and bsr_xla ->
    bsr_int8 in both routers; auto on the ddi stand-in at b=128 picks
    bsr_int8_pallas; tiers the port lacks raise naming their item."""
    j_graph, t_graph = _ddi(tmp_path)
    j_adj = j_models.sym_norm_adjacency(j_graph)
    t_adj = t_models.sym_norm_adjacency(t_graph)
    for impl, b, module in (("bsr_pallas", 32, "bsr_spmm_pallas_int8"),
                            ("auto", 128, "bsr_spmm_pallas_int8"),
                            ("auto", 32, "bsr_spmm_int8")):
        jp = j_ops.spmm_plan(j_adj, impl=impl, block_size=b, dtype=jnp.int8)
        tp = t_ops.spmm_plan(t_adj, impl=impl, block_size=b, dtype=torch.int8, device="cpu")
        assert jp.apply_fn.__module__.endswith("." + module), (impl, b)
        assert tp.apply_fn.__module__.endswith("." + module), (impl, b)
    jb = j_ops.spmm_plan(j_adj, impl="bsr_xla", block_size=32, dtype=jnp.int8)
    tb = t_ops.spmm_plan(t_adj, impl="bsr_xla", block_size=32, dtype="int8", device="cpu")
    assert jb.apply_fn.__module__.endswith(".bsr_spmm_int8")
    assert tb.apply_fn.__module__.endswith(".bsr_spmm_int8")
    x = _operand(t_adj.n_rows, 16, seed=5)
    assert _rel(tb(x), np.asarray(jb(x))) < PARITY_TOL
    # without int8 bsr_xla is the plain-torch tier, in both packages
    plain = t_ops.spmm_plan(t_adj, impl="bsr_xla", block_size=32, device="cpu")
    assert plain.apply_fn.__module__.endswith(".bsr_spmm_xla")
    j_fill, t_fill = t_bsr_csr_fill()
    jp = j_ops.spmm_plan(j_fill, impl="auto", block_size=128, dtype=jnp.int8)
    tp = t_ops.spmm_plan(t_fill, impl="auto", block_size=128, dtype=torch.int8,
                         device="cpu")
    assert jp.apply_fn.__module__.endswith(".csr_spmm_ell")
    assert tp.apply_fn.__name__ == "_ell_int8_apply"
    x = _operand(t_fill.n_cols, 16, seed=6)
    np.testing.assert_array_equal(tp(x).numpy(), np.asarray(jp(x)))


def t_bsr_csr_fill():
    """A weakly structured graph in both packages: past 32x fill, auto
    leaves the BSR tier for csr_ell (csr_ell_int8 with int8, whose
    pattern-only int32 sums are bit-equal)."""
    import spmm_denseblock_tpu.formats.csr as j_csr
    import spmm_denseblock_tpu_torch.formats.csr as t_csr

    return (j_csr.random_csr(0.002, 1024, seed=0, values="ones"),
            t_csr.random_csr(0.002, 1024, seed=0, values="ones"))


DIMS = [32, 64, 16]


def test_int8_gcn_matches_jax(tmp_path):
    """int8 GCN serving on the ddi stand-in (scale 0.1, b=32: 14 block-rows
    of 14 blocks, so both plans take K7's sorted group-scale layout).
    Tolerance against JAX: 1e-3 relative, not 1e-5, because layer 2
    re-quantizes layer 1's output: a 1e-7 difference there can move one
    operand entry by a quantum (1/127 of its column's max). Against a
    float64 host reference: the int8 gate, 6e-2."""
    j_graph, t_graph = _ddi(tmp_path)
    j_adj = j_models.sym_norm_adjacency(j_graph)
    t_adj = t_models.sym_norm_adjacency(t_graph)
    jp = j_ops.spmm_plan(j_adj, impl="bsr_pallas", block_size=32, dtype=jnp.int8,
                         grad=False)
    tp = t_ops.spmm_plan(t_adj, impl="bsr_pallas", block_size=32, dtype=torch.int8,
                         grad=False, device="cpu")
    assert tp.statics[0] == "sorted" and tp.statics[5][3]
    assert jp.statics[-1][0] == "sorted_gs"

    j_params = j_models.init_gcn(jax.random.PRNGKey(0), DIMS)
    j_params_np = [{k: np.asarray(v) for k, v in p.items()} for p in j_params]
    gcn = t_models.GCN(DIMS).load_params(t_models.gcn_params_from_jax(j_params_np))
    x = np.random.default_rng(7).standard_normal(
        (t_adj.n_rows, DIMS[0])).astype(np.float32)
    want = np.asarray(j_models.gcn_apply(j_params, jp, x))
    with torch.no_grad():
        got = gcn(tp, torch.as_tensor(x))
    assert got.shape == (t_adj.n_rows, DIMS[-1]) and torch.isfinite(got).all()
    assert _rel(got, want) < 1e-3
    h = x.astype(np.float64)
    a64 = t_adj.to_scipy().astype(np.float64)
    for i, p in enumerate(j_params_np):
        h = a64 @ h @ p["w"].astype(np.float64) + p["b"]
        if i < len(j_params_np) - 1:
            h = np.maximum(h, 0.0)
    assert _rel(got, h) < INT8_TOL
