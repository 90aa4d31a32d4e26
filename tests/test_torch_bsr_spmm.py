"""The port's BSR SpMM plan against the JAX package: the host packers are
bit-equal, the plain versions of K1 (flat grouped gather), K2
(depth-sorted row groups) and K4 (consecutive row groups) match the JAX
Pallas kernels run in interpret mode on the same packed arrays, the plan
matches the scipy oracle, and the layout policy and the out-of-scope
arguments behave as documented. K3 (the bf16x3 product, precision=
"high") and K5 (single-row resident) plain versions are held against
the Pallas kernels the same way, and the bsr_xla tier against its JAX
twin.

Tolerances: plain version vs Pallas kernel on the same arrays, 1e-5
relative to max |want| for f32 and bf16 operands (bf16 x bf16 products
are exact in f32, so only the order of the f32 sums differs). Plan vs
scipy: the reference's 1e-4 gate for f32, 3e-2 relative for bf16 (the
bf16 tier's tolerance in tests/test_conformance.py). K3 against _dot3:
1e-6 relative (the same bf16 splits, exact products, f32 sums in
another order). The bf16 exact case and the launch geometry of the bf16
tensor-core kernels: bit for bit, and exact values."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmm_denseblock_tpu.formats.bsr as j_bsr
import spmm_denseblock_tpu_torch.formats.bsr as t_bsr
from spmm_denseblock_tpu_torch.ops import _kernels, assert_allclose, spmm_scipy, sum_plan
from spmm_denseblock_tpu_torch.ops.reference import (
    _split_bf16_ints,
    bf16_exact_case,
    bf16x3_exact_case,
)

# the ops packages export a function of the module's name, so `import
# ... as` would bind the function
J = importlib.import_module("spmm_denseblock_tpu.ops.bsr_spmm_pallas")
T = importlib.import_module("spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas")

torch.set_num_threads(2)


def _with_empty_rows(bsr_mod, nb, b, p, seed, empty=(3, 4, 17)):
    """A seeded BSR with some empty block-rows (exercises covering)."""
    src = bsr_mod.random_bsr(p, nb, nb, block_size=b, seed=seed)
    keep = ~np.isin(np.asarray(src.block_rows), empty)
    return bsr_mod.BSR.from_parts(
        np.asarray(src.block_rows)[keep], np.asarray(src.block_cols)[keep],
        np.asarray(src.blocks)[keep], src.shape, b,
    )


def _covered_parts(mod, bsr):
    cov = mod._ensure_covering(bsr)
    return (np.asarray(cov.block_rows[: cov.nnzb]),
            np.asarray(cov.block_cols[: cov.nnzb]),
            np.asarray(cov.blocks[: cov.nnzb]))


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def test_ensure_covering_bit_equal():
    jb = _with_empty_rows(j_bsr, 21, 8, 0.3, seed=1)
    tb = _with_empty_rows(t_bsr, 21, 8, 0.3, seed=1)
    for a, b in zip(_covered_parts(J, jb), _covered_parts(T, tb)):
        np.testing.assert_array_equal(a, b)
    assert T._ensure_covering(tb).nnzb == tb.nnzb + 3


@pytest.mark.parametrize("group", [1, 4])
def test_pack_groups_bit_equal(group):
    rows, cols, blocks = _covered_parts(T, _with_empty_rows(t_bsr, 21, 8, 0.3, seed=2))
    for a, b in zip(J._pack_groups(rows, cols, blocks, group),
                    T._pack_groups(rows, cols, blocks, group)):
        np.testing.assert_array_equal(a, b)
    c2 = np.array([[3, -1], [-1, -1], [5, 2]])
    np.testing.assert_array_equal(
        J.per_buffer_col_fill(c2, c2 >= 0, np.zeros_like(c2)),
        T.per_buffer_col_fill(c2, c2 >= 0, np.zeros_like(c2)),
    )


@pytest.mark.parametrize("geom", [(2, 4, 8), (4, 16, 128)])
def test_pack_rowgroups_sorted_bit_equal(geom):
    """37 block-rows: not a multiple of R, so windows end in absent
    lanes; rows hold ~11 blocks, deeper than gh."""
    gh, R, W = geom
    rows, cols, blocks = _covered_parts(T, _with_empty_rows(t_bsr, 37, 8, 0.3, seed=4))
    want = J._pack_rowgroups_sorted(rows, cols, blocks, gh, R, W)
    got = T._pack_rowgroups_sorted(rows, cols, blocks, gh, R, W)
    for a, b in zip(want, got[:5]):
        np.testing.assert_array_equal(a, b)
    win_ids, pos, slot_cols, blocks_pad, n_win, lane_valid, steps = got
    nbr = 37
    n_groups = steps.size
    assert lane_valid.shape == (n_groups * R,) and lane_valid.dtype == bool
    # every block-row is exactly one valid lane; absent lanes pad windows
    assert lane_valid.sum() == nbr and (~lane_valid).sum() > 0
    group_ptr = np.concatenate([[0], np.cumsum(steps)])
    assert group_ptr[-1] == win_ids.size
    first = group_ptr[:-1]
    dest = (win_ids[first][:, None] * W
            + pos.reshape(-1, R)[first]).reshape(-1)
    assert sorted(dest[lane_valid]) == list(range(nbr))
    # an absent lane carries pos 0 and only zero blocks
    assert (pos.reshape(-1, R)[first].reshape(-1)[~lane_valid] == 0).all()
    lane_blocks = blocks_pad.reshape(win_ids.size, R, gh, 8, 8)
    step_group = np.repeat(np.arange(n_groups), steps)
    absent = ~lane_valid.reshape(n_groups, R)[step_group]
    assert not lane_blocks[absent].any()
    # steps per group cover the deepest lane
    assert steps.max() >= 2


@pytest.mark.parametrize("nb,R,gh", [(7, 16, 4), (21, 4, 2), (24, 8, 16)])
def test_pack_rowgroups_bit_equal(nb, R, gh):
    """7 block-rows at R=16 leave 9 phantom lanes; 21 at R=4 leave 3; 24
    at R=8 leave none. Phantom lanes hold zero blocks only."""
    rows, cols, blocks = _covered_parts(
        T, _with_empty_rows(t_bsr, nb, 8, 0.3, seed=nb, empty=(3,)))
    want = J._pack_rowgroups(rows, cols, blocks, gh, R)
    got = T._pack_rowgroups(rows, cols, blocks, gh, R)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    step_groups, slot_cols, blocks_pad, n_groups = got
    assert n_groups == -(-nb // R)
    ptr = T.group_pointer(step_groups, n_groups)
    assert ptr[0] == 0 and ptr[-1] == step_groups.size and (np.diff(ptr) >= 1).all()
    lanes = blocks_pad.reshape(step_groups.size, R, gh, 8, 8)
    phantom = step_groups[:, None] * R + np.arange(R) >= nb
    assert phantom.any() == (nb % R != 0)
    assert not lanes[phantom].any()
    assert T._rowgroup_policy(2) == J._rowgroup_policy(2)
    assert T._rowgroup_policy(1, 4) == J._rowgroup_policy(1, 4)


def _layouts(bsr, group, gh_R_W):
    rows, cols, blocks = _covered_parts(T, bsr)
    nbr = bsr.n_block_rows
    flat = T._pack_groups(rows, cols, blocks, group)
    srt = T._pack_rowgroups_sorted(rows, cols, blocks, *gh_R_W)
    return nbr, flat, srt


def _dense(bsr, F, seed):
    nbc = bsr.n_block_cols
    return np.random.default_rng(seed).standard_normal(
        (nbc * bsr.b, F)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 4])
def test_flat_plain_matches_pallas_kernel(dtype, group):
    bsr = _with_empty_rows(t_bsr, 21, 16, 0.25, seed=5)
    nbr, (step_rows, slot_cols, blocks), _ = _layouts(bsr, group, (4, 16, 128))
    F = 128
    x = _dense(bsr, F, seed=6)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(J._pallas_spmm(
        jnp.asarray(step_rows), jnp.asarray(slot_cols),
        jnp.asarray(blocks).astype(jd), jnp.asarray(x).astype(jd),
        nbr, nbr * 16, F, group, False, True,
    ))
    td = getattr(torch, dtype)
    got = T.spmm_flat_plain(
        torch.as_tensor(step_rows), torch.as_tensor(slot_cols),
        torch.as_tensor(blocks).to(td), torch.as_tensor(x).to(td), nbr, group,
    )
    assert got.shape == (nbr * 16, F) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 1e-5
    # the covered empty rows come out as exact zeros
    assert not got.reshape(nbr, 16, F)[[3, 4, 17]].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sorted_plain_matches_pallas_kernel(dtype):
    """37 block-rows at R=16: the last group has absent lanes whose pos
    is 0, the same as a real row's."""
    bsr = _with_empty_rows(t_bsr, 37, 16, 0.25, seed=7)
    R, gh, W = 16, 4, 128
    nbr, _, srt = _layouts(bsr, 1, (gh, R, W))
    win_ids, pos, slot_cols, blocks, n_win, lane_valid, steps = srt
    F = 128
    x = _dense(bsr, F, seed=8)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(J._pallas_spmm_rowgroup_sorted(
        jnp.asarray(win_ids), jnp.asarray(pos), jnp.asarray(slot_cols),
        jnp.asarray(blocks).astype(jd),
        jnp.asarray(x).astype(jd).reshape(-1, 16, F),
        n_win, W, nbr * 16, F, gh, R, True,
    ))
    td = getattr(torch, dtype)
    got = T.spmm_sorted_plain(
        torch.as_tensor(win_ids), torch.as_tensor(pos),
        torch.as_tensor(slot_cols), torch.as_tensor(blocks).to(td),
        torch.as_tensor(x).to(td), torch.as_tensor(lane_valid),
        torch.as_tensor(np.concatenate([[0], np.cumsum(steps)])),
        nbr, R, gh, W,
    )
    assert got.shape == (nbr * 16, F)
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nb", [7, 37])
def test_rowgroup_plain_matches_pallas_kernel(dtype, nb):
    """K4's plain version against _pallas_spmm_rowgroup on the same
    arrays: 7 block-rows at R=16 (9 phantom lanes, whose rows the JAX
    output holds and the port's does not), 37 with empty rows."""
    bsr = _with_empty_rows(t_bsr, nb, 16, 0.25, seed=11, empty=(3, 4))
    R, gh = 16, 2
    rows, cols, blocks = _covered_parts(T, bsr)
    step_groups, slot_cols, blocks_pad, n_groups = T._pack_rowgroups(
        rows, cols, blocks, gh, R)
    F = 128
    x = _dense(bsr, F, seed=12)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(J._pallas_spmm_rowgroup(
        jnp.asarray(step_groups), jnp.asarray(slot_cols),
        jnp.asarray(blocks_pad).astype(jd),
        jnp.asarray(x).astype(jd).reshape(-1, 16, F),
        n_groups, nb * 16, F, gh, R, True,
    ))
    td = getattr(torch, dtype)
    got = T.spmm_rowgroup_plain(
        torch.as_tensor(step_groups), torch.as_tensor(slot_cols),
        torch.as_tensor(blocks_pad).to(td), torch.as_tensor(x).to(td), nb, R, gh)
    assert got.shape == (nb * 16, F) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 1e-5
    assert not got.reshape(nb, 16, F)[[3, 4]].any()
    # the CPU wrapper runs the plain version
    ptr = torch.as_tensor(T.group_pointer(step_groups, n_groups))
    assert torch.equal(T.spmm_rowgroup(
        torch.as_tensor(step_groups), ptr, torch.as_tensor(slot_cols),
        torch.as_tensor(blocks_pad).to(td), torch.as_tensor(x).to(td), nb, R, gh), got)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("depth_sort", [None, True, False])
@pytest.mark.parametrize("p", [0.08, 0.4])
def test_plan_matches_scipy(dtype, depth_sort, p):
    """Ragged shapes: logical rows/cols not multiples of b, F not a power
    of two. Launch counters stay 0: CPU tensors take the plain path."""
    base = t_bsr.random_bsr(p, 23, 19, block_size=16, seed=9)
    bsr = t_bsr.BSR.from_parts(base.block_rows, base.block_cols, base.blocks,
                               (23 * 16 - 5, 19 * 16 - 7), 16)
    launches = [k.launches for k in _kernels.KERNELS]
    td = None if dtype is None else getattr(torch, dtype)
    plan = T.bsr_spmm_pallas_plan(bsr, dtype=td, grad=False, depth_sort=depth_sort,
                                  device="cpu")
    x = np.random.default_rng(1).standard_normal((bsr.shape[1], 70)).astype(np.float32)
    got = plan(x)
    assert got.shape == (bsr.shape[0], 70) and got.dtype == torch.float32
    want = spmm_scipy(bsr, x)
    if dtype is None:
        assert_allclose(got, want)
    else:
        assert _rel(got.numpy(), want) < 3e-2
    assert [k.launches for k in _kernels.KERNELS] == launches
    # a tensor operand gives the same answer as a numpy one
    assert torch.equal(plan(torch.as_tensor(x)), got)


def _rows_with(depth, nb=24, b=8, seed=0):
    """nb block-rows with exactly `depth` blocks each."""
    rng = np.random.default_rng(seed)
    cols = np.stack([rng.choice(nb, depth, replace=False) for _ in range(nb)])
    rows = np.repeat(np.arange(nb), depth)
    blocks = rng.standard_normal((nb * depth, b, b)).astype(np.float32)
    return rows.astype(np.int32), cols.reshape(-1).astype(np.int32), blocks


@pytest.mark.parametrize("depth", [7, 9])
def test_f32_layout_matches_jax_plan(depth):
    """f32 takes the sorted layout at >= 8 real blocks per block-row and
    the flat one below, in both packages."""
    rows, cols, blocks = _rows_with(depth)
    jp = J.bsr_spmm_pallas_plan(
        j_bsr.BSR.from_parts(rows, cols, blocks, (192, 192), 8), grad=False)
    tp = T.bsr_spmm_pallas_plan(
        t_bsr.BSR.from_parts(rows, cols, blocks, (192, 192), 8), grad=False, device="cpu")
    j_layout = "sorted" if isinstance(jp.statics[-1], tuple) else "flat"
    assert tp.statics[0] == j_layout == ("sorted" if depth >= 8 else "flat")
    x = np.random.default_rng(2).standard_normal((192, 24)).astype(np.float32)
    assert_allclose(tp(x), np.asarray(jp(x)))


def _jax_layout(plan):
    """The layout a JAX f32/bf16 or int8 Pallas plan packed."""
    rowgroup = plan.statics[-1]
    if rowgroup is None:
        return "flat"
    return "sorted" if isinstance(rowgroup[0], str) else "rowgroup"


def test_bf16_layout_gate():
    """bf16 sorts at >= 2 real blocks per block-row; below, and with
    depth_sort=False, both packages pack consecutive row groups (K4);
    resident=False keeps the flat layout (K1)."""
    parts = {}
    for name, p in (("sparse", 0.05), ("dense", 0.5)):
        src = t_bsr.random_bsr(p, 24, 24, block_size=16, seed=0)
        parts[name] = (src.block_rows, src.block_cols, src.blocks, src.shape, 16)
    bf = torch.bfloat16
    for name, kw, layout in (
        ("sparse", {}, "rowgroup"),
        ("dense", {}, "sorted"),
        ("sparse", {"depth_sort": True}, "sorted"),
        ("dense", {"depth_sort": False}, "rowgroup"),
        ("sparse", {"resident": True}, "rowgroup"),
        ("dense", {"resident": True}, "sorted"),
        ("dense", {"resident": False}, "flat"),
    ):
        tp = T.bsr_spmm_pallas_plan(t_bsr.BSR.from_parts(*parts[name]),
                                    dtype=bf, grad=False, **kw, device="cpu")
        jp = J.bsr_spmm_pallas_plan(j_bsr.BSR.from_parts(*parts[name]),
                                    dtype=jnp.bfloat16, grad=False, **kw)
        assert tp.statics[0] == _jax_layout(jp) == layout, (name, kw)
        for a, b in zip(jp.arrays, tp.arrays):
            np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                          b.float().numpy())
    x = np.random.default_rng(3).standard_normal((384, 40)).astype(np.float32)
    assert _rel(tp(x).numpy(), np.asarray(jp(x))) < 1e-5


@pytest.mark.parametrize("kw", [
    {"precision": "default"},
    {"precision": "default", "dtype": torch.bfloat16},
    {"precision": "highest", "dtype": torch.bfloat16},
    {"precision": "default", "grad": True},
])
def test_out_of_scope_arguments_raise(kw):
    """"highest" on bf16 (refused by the TPU compiler) raises before any
    packing, and an unknown precision raises ValueError. precision=
    "default", once out of scope, is ported (one bf16 pass): with f32 or
    bf16 operands and with grad, its plan takes JAX's flat layout and
    gives JAX's answer on bf16_exact_case bit for bit (the whole parity
    suite is tests/test_torch_precision_default.py)."""
    bsr = t_bsr.random_bsr(0.3, 4, 4, block_size=8, seed=0)
    kw = {"grad": False, **kw}
    with pytest.raises(ValueError, match="precision"):
        T.bsr_spmm_pallas_plan(bsr, precision="bf16x3", device="cpu")
    if kw["precision"] == "highest":
        with pytest.raises(NotImplementedError, match="highest"):
            T.bsr_spmm_pallas_plan(bsr, **kw, device="cpu")
        return
    case, x, want = bf16_exact_case(8, 16)
    tp = T.bsr_spmm_pallas_plan(case, **kw, device="cpu")
    jkw = {**kw, "dtype": jnp.bfloat16} if "dtype" in kw else kw
    jp = J.bsr_spmm_pallas_plan(j_bsr.BSR.from_parts(
        case.block_rows, case.block_cols, case.blocks, case.shape, 8), **jkw)
    fwd, jfwd = (tp.arrays[0], jp.arrays[0]) if kw["grad"] else (tp, jp)
    assert fwd.statics[0] == _jax_layout(jfwd) == "flat"
    np.testing.assert_array_equal(tp(x).numpy(), np.asarray(jp(x)))
    np.testing.assert_array_equal(tp(x).numpy(), want.astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.int8, "int8", np.int8])
def test_int8_dtype_raises_value_error(dtype):
    """dtype=int8 on the cast-based plan raises ValueError in both
    packages: a cast would truncate; int8 goes through the quantized
    tier."""
    bsr = t_bsr.random_bsr(0.3, 4, 4, block_size=8, seed=0)
    with pytest.raises(ValueError, match="int8"):
        T.bsr_spmm_pallas_plan(bsr, dtype=dtype, grad=False, device="cpu")
    jb = j_bsr.random_bsr(0.3, 4, 4, block_size=8, seed=0)
    with pytest.raises(ValueError, match="int8"):
        J.bsr_spmm_pallas_plan(jb, dtype=jnp.int8, grad=False)


def test_plan_module_and_sum_plan():
    """A plan is an nn.Module whose packed arrays are buffers (the flat
    layout's four and its lane order); sum_plan adds sub-plan outputs."""
    a = t_bsr.random_bsr(0.3, 6, 6, block_size=8, seed=1)
    b = t_bsr.random_bsr(0.3, 6, 6, block_size=8, seed=2)
    pa = T.bsr_spmm_pallas_plan(a, grad=False, device="cpu")
    pb = T.bsr_spmm_pallas_plan(b, grad=False, depth_sort=True, device="cpu")
    assert isinstance(pa, torch.nn.Module)
    assert len(list(pa.buffers())) == len(pa.arrays) == 5
    assert pa.to("cpu") is pa
    x = np.random.default_rng(0).standard_normal((48, 5)).astype(np.float32)
    s = sum_plan([pa, pb])
    assert len(list(s.buffers())) == len(pa.arrays) + len(pb.arrays)
    assert_allclose(s(x), spmm_scipy(a, x) + spmm_scipy(b, x))


def test_wrappers_reject_mixed_devices():
    plan = T.bsr_spmm_pallas_plan(t_bsr.random_bsr(0.3, 4, 4, block_size=8, seed=0),
                                  grad=False, device="cpu")
    step_rows, slot_cols, blocks, step_ptr, _ = plan.arrays
    with pytest.raises(ValueError, match="device"):
        T.spmm_flat(step_rows, step_ptr, slot_cols, blocks,
                    torch.zeros(32, 3, device="meta"), plan.statics[-1])


# -- K3 (bf16x3) and K5 (single-row resident) ------------------------------

K3_TOL = 1e-6


def _three_term_f64(bsr, x):
    """The float64 sum of _dot3's three terms at the matrix level:
    A_hi X_hi + A_hi X_lo + A_lo X_hi, with the splits of the f32 values
    (a packed layout's pad blocks split to zeros, so the layouts' sums
    are this one up to the order of the sums)."""
    a = torch.as_tensor(bsr.to_dense())
    x = torch.as_tensor(x)
    ah, al = (t.double() for t in T.split_bf16(a))
    xh, xl = (t.double() for t in T.split_bf16(x))
    return (ah @ xh + ah @ xl + al @ xh).numpy()


def test_split_bf16_rounds_to_nearest_even():
    """hi + lo carries 16 significant bits; a tie rounds to even, as
    jnp.astype(bfloat16) does."""
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    x[:3] = [1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -(1.0 + 2.0 ** -8)]
    hi, lo = T.split_bf16(torch.as_tensor(x))
    jhi = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    jlo = np.asarray((jnp.asarray(x) - jhi).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(hi.numpy(), jhi)
    np.testing.assert_array_equal(lo.numpy(), jlo)
    assert hi[0] == 1.0 and hi[1] == 1.0 + 2.0 ** -6 and hi[2] == -1.0
    assert (np.abs(x - hi.numpy() - lo.numpy()) <= np.abs(x) * 2.0 ** -16).all()


@pytest.mark.parametrize("layout", ["flat", "sorted", "resident"])
def test_k3_plain_matches_dot3_kernel(layout):
    """K3's plain version on each layout (on split_planes' planes of the
    packed blocks) against the Pallas kernel with precision_name="high"
    (_dot3, interpret mode) on the same packed arrays, within 1e-6. Margins: K3 lies within 1e-6 of the float64
    three-term sum; the exact f32 answer on the same input lies more
    than 10x further from it (it keeps the lo*lo term and the split
    residuals bf16x3 drops), so the test tells bf16x3 from exact f32.
    On this input: 7.5e-8 from _dot3, 8.7e-8 from the three-term sum,
    and exact f32 4.1e-6 from it (48x)."""
    bsr = _with_empty_rows(t_bsr, 21, 16, 0.25, seed=13)
    nbr = bsr.n_block_rows
    rows, cols, blocks = _covered_parts(T, bsr)
    F = 128
    x = _dense(bsr, F, seed=14)
    xt, jx = torch.as_tensor(x), jnp.asarray(x)
    if layout == "sorted":
        R, gh, W = 16, 4, 128
        win_ids, pos, slot_cols, bp, n_win, lane_valid, steps = \
            T._pack_rowgroups_sorted(rows, cols, blocks, gh, R, W)
        want = J._pallas_spmm_rowgroup_sorted(
            jnp.asarray(win_ids), jnp.asarray(pos), jnp.asarray(slot_cols),
            jnp.asarray(bp), jx.reshape(-1, 16, F), n_win, W, nbr * 16, F,
            gh, R, True, "high")
        idx = (torch.as_tensor(win_ids), torch.as_tensor(pos),
               torch.as_tensor(slot_cols))
        tail = (xt, torch.as_tensor(lane_valid),
                torch.as_tensor(np.concatenate([[0], np.cumsum(steps)])),
                nbr, R, gh, W)
        bp = torch.as_tensor(bp)
        got = T.spmm_sorted_plain(*idx, T.split_planes(bp), *tail, bf16x3=True)
        exact = T.spmm_sorted_plain(*idx, bp, *tail)
    else:
        group = 4
        step_rows, slot_cols, bp = T._pack_groups(rows, cols, blocks, group)
        jargs = (jnp.asarray(step_rows), jnp.asarray(slot_cols), jnp.asarray(bp))
        targs = (torch.as_tensor(step_rows), torch.as_tensor(slot_cols),
                 torch.as_tensor(bp))
        planes = (*targs[:2], T.split_planes(targs[2]))
        if layout == "flat":
            want = J._pallas_spmm(*jargs, jx, nbr, nbr * 16, F, group, False,
                                  True, "high")
            got = T.spmm_flat_plain(*planes, xt, nbr, group, bf16x3=True)
            exact = T.spmm_flat_plain(*targs, xt, nbr, group)
        else:
            want = J._pallas_spmm_resident(*jargs, jx.reshape(-1, 16, F), nbr,
                                           nbr * 16, F, group, True, "high")
            x3 = xt.reshape(-1, 16, F)
            got = T.spmm_resident_plain(*planes, x3, nbr, group, bf16x3=True)
            exact = T.spmm_resident_plain(*targs, x3, nbr, group)
    assert got.shape == (nbr * 16, F) and got.dtype == torch.float32
    assert _rel(got.numpy(), np.asarray(want)) < K3_TOL
    ref3 = _three_term_f64(bsr, x)
    k3_err = _rel(got.numpy(), ref3)
    exact_err = _rel(exact.numpy(), ref3)
    assert k3_err < K3_TOL
    assert exact_err > 10 * k3_err, (exact_err, k3_err)
    assert not got.reshape(nbr, 16, F)[[3, 4, 17]].any()


def _dot3_planes(blocks):
    """(lh, ll) of _dot3's split of the f32 blocks, each bf16, as JAX
    computes them."""
    lh = jnp.asarray(blocks).astype(jnp.bfloat16)
    ll = (jnp.asarray(blocks) - lh.astype(jnp.float32)).astype(jnp.bfloat16)
    return lh, ll


HIGH_LAYOUT_KW = {"sorted": {}, "flat": {"depth_sort": False},
                  "resident": {"resident": True, "depth_sort": False}}


@pytest.mark.parametrize("b", [16, 64, 128])
@pytest.mark.parametrize("layout", list(HIGH_LAYOUT_KW))
def test_high_plan_holds_dot3_planes(layout, b):
    """A "high" plan holds its packed blocks as one (2*S*b, b) bf16
    tensor, hi above lo, in place of the f32 blocks, and the planes are
    _dot3's lh and ll of the JAX packer's blocks bit for bit (sorted,
    flat and resident layouts); the other arrays are the JAX plan's."""
    bsr = bf16x3_exact_case(F=8, b=b)[0]
    jbsr = j_bsr.BSR.from_parts(bsr.block_rows, bsr.block_cols, bsr.blocks,
                                bsr.shape, b)
    kw = HIGH_LAYOUT_KW[layout]
    tp = T.bsr_spmm_pallas_plan(bsr, grad=False, precision="high", **kw, device="cpu")
    jp = J.bsr_spmm_pallas_plan(jbsr, grad=False, precision="high", **kw)
    assert (tp.statics[0], tp.statics[5]) == (layout, "bf16x3")
    planes = tp.arrays[2]
    n_slots = jp.arrays[2].shape[0]
    assert planes.dtype == torch.bfloat16 and planes.is_contiguous()
    assert planes.shape == (2 * n_slots * b, b)
    lh, ll = _dot3_planes(jp.arrays[2])
    hi, lo = T.block_planes(planes)
    for want, got in ((lh, hi), (ll, lo)):
        np.testing.assert_array_equal(
            np.asarray(want).view(np.uint16), got.view(torch.int16).numpy().view(np.uint16))
    for i, (a, t) in enumerate(zip(jp.arrays, tp.arrays)):
        if i != 2:
            np.testing.assert_array_equal(np.asarray(a), t.numpy())


@pytest.mark.parametrize("F", [1, 70, 96])
def test_split_operand_plain_matches_split_bf16(F):
    """K3's operand split, plain version (the CPU wrapper runs it): the
    (2N, ld) bf16 planes, hi rows over lo rows, equal split_bf16's hi and
    lo (and _dot3's rh, rl) bit for bit, ld = F rounded up to 8 with zero
    pad columns; no kernel launches on CPU tensors."""
    x = np.random.default_rng(F).standard_normal((48, F)).astype(np.float32)
    x[0, 0] = 1.0 + 2.0 ** -8  # a tie, to even
    launches = [k.launches for k in _kernels.KERNELS]
    xp = T.split_operand(torch.as_tensor(x))
    assert [k.launches for k in _kernels.KERNELS] == launches
    assert torch.equal(xp, T.split_operand_plain(torch.as_tensor(x)))
    ld = -(-F // 8) * 8
    assert xp.shape == (96, ld) and xp.dtype == torch.bfloat16
    hi, lo = T.split_bf16(torch.as_tensor(x))
    assert torch.equal(xp[:48, :F].float(), hi) and torch.equal(xp[48:, :F].float(), lo)
    assert not xp[:, F:].float().any()
    rh, rl = _dot3_planes(x)
    np.testing.assert_array_equal(np.asarray(rh.astype(jnp.float32)), hi.numpy())
    np.testing.assert_array_equal(np.asarray(rl.astype(jnp.float32)), lo.numpy())


@pytest.mark.parametrize("b", [64, 128])
@pytest.mark.parametrize("layout", list(HIGH_LAYOUT_KW))
def test_k3_is_bf16x3_not_exact_f32_wide_blocks(layout, b):
    """bf16x3_exact_case at the block sizes the tensor-core loop runs
    (b = 64 and 128, 16 nonzeros in each row of a block): the "high"
    plan, computed from its planes, equals A_hi X_hi + A_hi X_lo + A_lo
    X_hi bit for bit, as the JAX "high" plan does (interpret mode), and
    the exact f32 plan equals A X."""
    bsr, x, want3, want_exact = bf16x3_exact_case(F=40, b=b)
    kw = HIGH_LAYOUT_KW[layout]
    tp = T.bsr_spmm_pallas_plan(bsr, grad=False, precision="high", **kw, device="cpu")
    exact = T.bsr_spmm_pallas_plan(bsr, grad=False, **kw, device="cpu")
    assert (tp.statics[0], exact.statics[0]) == (layout, layout)
    np.testing.assert_array_equal(tp(x).double().numpy(), want3)
    np.testing.assert_array_equal(exact(x).double().numpy(), want_exact)
    jbsr = j_bsr.BSR.from_parts(bsr.block_rows, bsr.block_cols, bsr.blocks,
                                bsr.shape, b)
    jp = J.bsr_spmm_pallas_plan(jbsr, grad=False, precision="high", **kw)
    np.testing.assert_array_equal(np.asarray(jp(x), np.float64), want3)


@pytest.mark.parametrize("layout", list(HIGH_LAYOUT_KW))
def test_k3_plan_matches_jax_high_plan_b64(layout):
    """The CPU "high" plan, computed from its planes, against the JAX
    "high" plan (_dot3 in interpret mode) on random data at b = 64,
    within K3_TOL (1e-6: the same splits and exact products, the f32
    sums in another order)."""
    parts = (*_rows_with(9, nb=12, b=64, seed=23), (768, 768), 64)
    bsr, jbsr = t_bsr.BSR.from_parts(*parts), j_bsr.BSR.from_parts(*parts)
    kw = HIGH_LAYOUT_KW[layout]
    tp = T.bsr_spmm_pallas_plan(bsr, grad=False, precision="high", **kw, device="cpu")
    jp = J.bsr_spmm_pallas_plan(jbsr, grad=False, precision="high", **kw)
    assert (tp.statics[0], tp.statics[5]) == (layout, "bf16x3")
    x = _dense(bsr, 48, seed=24)
    assert _rel(tp(x).numpy(), np.asarray(jp(x))) < K3_TOL


def test_split_bf16_ints_matches_split_bf16():
    """The hand-worked split that bf16x3_exact_case's answers rest on is
    split_bf16's (and so _dot3's) on every magnitude the case uses."""
    v = np.arange(257, 512, dtype=np.float32)
    v = np.concatenate([v, -v])
    hi, lo = T.split_bf16(torch.as_tensor(v))
    h2, l2 = _split_bf16_ints(v.astype(np.float64))
    np.testing.assert_array_equal(hi.numpy(), h2)
    np.testing.assert_array_equal(lo.numpy(), l2)
    assert set(np.unique(l2)) == {-1.0, 0.0, 1.0}


@pytest.mark.parametrize("kw,layout", [
    ({}, "sorted"),
    ({"depth_sort": False}, "flat"),
    ({"resident": True, "depth_sort": False}, "resident"),
])
def test_k3_is_bf16x3_not_exact_f32(kw, layout):
    """On bf16x3_exact_case every partial sum is exact in f32, so no
    order of the sums can blur the answer: the "high" plan (K3's plain
    version here) equals A_hi X_hi + A_hi X_lo + A_lo X_hi bit for bit,
    as the JAX plan does (_dot3, interpret mode); the exact f32 plan on
    the same layout equals A X bit for bit; the two differ in most
    entries (by A_lo X_lo). tests/test_torch_cuda_kernels.py and
    chip_smoke.py hold the CUDA kernels to the same answers."""
    bsr, x, want3, want_exact = bf16x3_exact_case()
    tp = T.bsr_spmm_pallas_plan(bsr, grad=False, precision="high", **kw, device="cpu")
    exact = T.bsr_spmm_pallas_plan(bsr, grad=False, **kw, device="cpu")
    assert (tp.statics[0], tp.statics[5]) == (layout, "bf16x3")
    assert (exact.statics[0], exact.statics[5]) == (layout, "exact")
    np.testing.assert_array_equal(tp(x).double().numpy(), want3)
    np.testing.assert_array_equal(exact(x).double().numpy(), want_exact)
    jbsr = j_bsr.BSR.from_parts(bsr.block_rows, bsr.block_cols, bsr.blocks,
                                bsr.shape, bsr.b)
    jp = J.bsr_spmm_pallas_plan(jbsr, grad=False, precision="high", **kw)
    np.testing.assert_array_equal(np.asarray(jp(x), np.float64), want3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [1, 4])
def test_resident_plain_matches_pallas_kernel(dtype, group):
    """K5's plain version, reading the operand as (nbc, b, F), against
    _pallas_spmm_resident on the same arrays; the CPU wrapper runs it."""
    bsr = _with_empty_rows(t_bsr, 21, 16, 0.25, seed=15)
    nbr = bsr.n_block_rows
    rows, cols, blocks = _covered_parts(T, bsr)
    step_rows, slot_cols, bp = T._pack_groups(rows, cols, blocks, group)
    F = 128
    x = _dense(bsr, F, seed=16)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(J._pallas_spmm_resident(
        jnp.asarray(step_rows), jnp.asarray(slot_cols),
        jnp.asarray(bp).astype(jd), jnp.asarray(x).astype(jd).reshape(-1, 16, F),
        nbr, nbr * 16, F, group, True))
    td = getattr(torch, dtype)
    x3 = torch.as_tensor(x).to(td).reshape(-1, 16, F)
    targs = (torch.as_tensor(step_rows), torch.as_tensor(slot_cols),
             torch.as_tensor(bp).to(td))
    got = T.spmm_resident_plain(*targs, x3, nbr, group)
    assert got.shape == (nbr * 16, F) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 1e-5
    ptr = torch.as_tensor(np.searchsorted(step_rows, np.arange(nbr + 1)))
    assert torch.equal(T.spmm_resident(targs[0], ptr, targs[1], targs[2], x3,
                                       group), got)
    with pytest.raises(ValueError, match="nbc, b, F"):
        T.spmm_resident_plain(*targs, x3.reshape(-1, F), nbr, group)


# (dtype, plan kwargs, blocks per block-row, layout, math)
GATE_CASES = [
    (None, {"precision": "high"}, 9, "sorted", "bf16x3"),
    (None, {"precision": "high"}, 7, "flat", "bf16x3"),
    (None, {"precision": "high", "depth_sort": False}, 9, "flat", "bf16x3"),
    (None, {"precision": "highest"}, 9, "flat", "exact"),
    ("bfloat16", {"precision": "high"}, 9, "flat", "exact"),
    ("bfloat16", {"precision": "high"}, 3, "flat", "exact"),
    (None, {"resident": True}, 9, "sorted", "exact"),
    (None, {"resident": True}, 7, "resident", "exact"),
    (None, {"resident": True, "depth_sort": False}, 9, "resident", "exact"),
    (None, {"resident": True, "precision": "high"}, 9, "sorted", "bf16x3"),
    (None, {"resident": True, "precision": "high"}, 7, "resident", "bf16x3"),
    ("bfloat16", {"resident": True, "precision": "high"}, 9, "resident", "exact"),
    (None, {"resident": False}, 9, "flat", "exact"),
]


@pytest.mark.parametrize("dtype,kw,depth,layout,math", GATE_CASES)
def test_precision_resident_layout_gate(dtype, kw, depth, layout, math):
    """The JAX gate for precision="high" and resident=True: f32 "high"
    and resident=True sort at >= 8 real blocks per block-row (unless
    depth_sort=False), else pack flat, run by K5 with resident=True;
    bf16 "high" is not the bf16 resident regime and packs flat at the
    _auto_group rule (group 4 at depth 9 where the power-of-two rule
    gives 16). The packed arrays and the group are bit-equal to the JAX
    plan's (a "high" plan's blocks as the two bf16 planes of _dot3's
    split of the JAX plan's blocks); the answers agree within 1e-5 (the
    JAX side in interpret mode)."""
    rows, cols, blocks = _rows_with(depth)
    parts = (rows, cols, blocks, (192, 192), 8)
    td = None if dtype is None else getattr(torch, dtype)
    jd = None if dtype is None else jnp.bfloat16
    tp = T.bsr_spmm_pallas_plan(t_bsr.BSR.from_parts(*parts), dtype=td,
                                grad=False, **kw, device="cpu")
    jp = J.bsr_spmm_pallas_plan(j_bsr.BSR.from_parts(*parts), dtype=jd,
                                grad=False, **kw)
    assert tp.statics[0] == layout and tp.statics[5] == math
    j_layout = _jax_layout(jp)
    assert j_layout == ("flat" if layout == "resident" else layout)
    if layout in ("flat", "resident"):
        assert tp.statics[-1] == jp.statics[5]
        assert jp.statics[5] == J._auto_group(depth * 24, 24)
    for i, (a, b) in enumerate(zip(jp.arrays, tp.arrays)):
        if i == 2 and math == "bf16x3":  # the planes of _dot3's split
            a = np.concatenate([p.reshape(-1, 8) for p in _dot3_planes(a)])
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)),
                                      b.float().numpy())
    x = np.random.default_rng(3).standard_normal((192, 40)).astype(np.float32)
    assert _rel(tp(x).numpy(), np.asarray(jp(x))) < 1e-5
    if math == "bf16x3":
        exact = T.bsr_spmm_pallas_plan(t_bsr.BSR.from_parts(*parts),
                                       grad=False, device="cpu")(x)
        assert not torch.equal(tp(x), exact)


# -- bsr_xla, the plain-torch tier ------------------------------------------

XLA = importlib.import_module("spmm_denseblock_tpu_torch.ops.bsr_spmm_xla")
JX = importlib.import_module("spmm_denseblock_tpu.ops.bsr_spmm_xla")


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_bsr_xla_matches_jax(dtype):
    """bsr_xla (gather, f32 bmm, index_add) against bsr_spmm_xla_plan:
    outputs and the gradient of <C, G> (autograd against jax.grad);
    ragged shape, empty block-rows; through spmm_plan too."""
    src = _with_empty_rows(t_bsr, 13, 16, 0.3, seed=17)
    parts = (src.block_rows, src.block_cols, src.blocks, (13 * 16 - 5, 13 * 16 - 9), 16)
    td = None if dtype is None else torch.bfloat16
    jd = None if dtype is None else jnp.bfloat16
    tp = XLA.bsr_spmm_xla_plan(t_bsr.BSR.from_parts(*parts), dtype=td, device="cpu")
    jp = JX.bsr_spmm_xla_plan(j_bsr.BSR.from_parts(*parts), dtype=jd)
    rng = np.random.default_rng(18)
    x = rng.standard_normal((parts[3][1], 33)).astype(np.float32)
    g = rng.standard_normal((parts[3][0], 33)).astype(np.float32)
    jout, jvjp = jax.vjp(jp, jnp.asarray(x))
    (jgrad,) = jvjp(jnp.asarray(g))
    xt = torch.tensor(x, requires_grad=True)
    out = tp(xt)
    out.backward(torch.as_tensor(g))
    assert out.shape == parts[3][:1] + (33,) and out.dtype == torch.float32
    assert _rel(out.detach().numpy(), np.asarray(jout)) < 1e-5
    assert _rel(xt.grad.numpy(), np.asarray(jgrad)) < 1e-5
    assert not out.detach().reshape(-1, 33)[3 * 16:5 * 16].any()
    if dtype is None:
        assert_allclose(out.detach(), spmm_scipy(t_bsr.BSR.from_parts(*parts), x))
    from spmm_denseblock_tpu_torch.ops import spmm_plan

    routed = spmm_plan(t_bsr.BSR.from_parts(*parts), impl="bsr_xla", dtype=td,
                       grad=True, device="cpu")
    assert routed.apply_fn is XLA._bsr_xla_apply
    assert torch.equal(routed(x), out.detach())
    with pytest.raises(ValueError, match="int8"):
        XLA.bsr_spmm_xla_plan(t_bsr.BSR.from_parts(*parts), dtype=torch.int8, device="cpu")


@pytest.mark.parametrize("impl", ["bsr_xla", "bsr_int8", "dense"])
def test_plain_apply_on_plans_without_kernels(impl):
    """plain_apply on a plan with no kernel (bsr_xla, bsr_int8, dense)
    runs the plan's own ops, alone, summed, and as the two directions of
    a grad_plan (bsr_int8 is inference only and has no grad plan)."""
    from spmm_denseblock_tpu_torch.ops import PLANNERS, grad_plan

    bsr = _with_empty_rows(t_bsr, 9, 16, 0.3, seed=19)
    build = lambda m: PLANNERS[impl](m, grad=False, device="cpu")
    plan = build(bsr)
    x = np.random.default_rng(20).standard_normal((bsr.shape[1], 24)).astype(np.float32)
    assert torch.equal(T.plain_apply(plan, x), plan(x))
    both = sum_plan([plan, build(bsr)])
    assert torch.equal(T.plain_apply(both, x), both(x))
    if impl == "bsr_int8":
        return
    gp = grad_plan(plan, build(bsr.transpose()))
    g = torch.as_tensor(np.random.default_rng(21).standard_normal(
        (bsr.shape[0], 24)).astype(np.float32))
    grads = []
    for fn in (gp, lambda v: T.plain_apply(gp, v)):
        xt = torch.tensor(x, requires_grad=True)
        fn(xt).backward(g)
        grads.append(xt.grad)
    assert torch.equal(grads[0], grads[1])
    assert_allclose(grads[0], bsr.to_dense().T @ g.numpy())


# -- bf16 K2 and K4: the exact case and the launch geometry ------------------


@pytest.mark.parametrize("depth_sort,layout", [(None, "sorted"), (False, "rowgroup")])
def test_bf16_exact_case_bit_exact(depth_sort, layout):
    """bf16_exact_case holds every partial sum to an integer under 2^24,
    so the bf16 plan's plain versions of K2 and K4 (the CPU path) equal
    float64 bit for bit at b=64, and so does the JAX plan (its Pallas
    kernels in interpret mode). tests/test_torch_cuda_kernels.py and
    chip_smoke.py hold the tensor-core kernels to the same answer. The
    7 block-rows leave absent (K2) and phantom (K4) lanes; F=70 is
    ragged."""
    bsr, x, want = bf16_exact_case(64, 70)
    assert (x == np.round(x)).all() and np.abs(x).max() <= 16
    tp = T.bsr_spmm_pallas_plan(bsr, dtype=torch.bfloat16, grad=False,
                                depth_sort=depth_sort, device="cpu")
    assert tp.statics[0] == layout
    np.testing.assert_array_equal(tp(x).double().numpy(), want)
    jbsr = j_bsr.BSR.from_parts(bsr.block_rows, bsr.block_cols, bsr.blocks,
                                bsr.shape, bsr.b)
    jp = J.bsr_spmm_pallas_plan(jbsr, dtype=jnp.bfloat16, grad=False,
                                depth_sort=depth_sort)
    assert _jax_layout(jp) == layout
    np.testing.assert_array_equal(np.asarray(jp(x), np.float64), want)


@pytest.mark.parametrize("b,n_rows,F,n_sms,want", [(*case[:3], 132, case[3]) for case in [
    (128, 1024, 512, (128, 512)),  # bench.py's op shape: 4,096 CTAs
    (128, 34, 256, (64, 256)),     # ddi: 34 lanes, BN=64 gives 136 CTAs
    (64, 1024, 256, (128, 256)),
    (128, 33, 512, (128, 512)),    # 132 CTAs at 128
    (128, 32, 512, (64, 512)),     # 128 at 128: 64 gives 256
    (128, 66, 256, (128, 256)),
    (128, 65, 256, (64, 256)),
    (128, 1024, 8, (64, 8)),       # never wider than F needs
    (128, 1024, 64, (64, 64)),
    (128, 1024, 70, (128, 72)),    # ragged F pads to a multiple of 8
    (128, 1024, 133, (128, 136)),
    (64, 1024, 129, (128, 136)),
    (128, 1024, 600, (128, 600)),
    (32, 1024, 133, (64, 136)),    # b < 64: 64-column tiles (no entry
    (16, 5, 70, (64, 72)),         # launches them), rows padded as at every b
]] + [  # one SM: every grid covers it, so F alone sets the width
    (128, 1, F, 1, (bn, -(-F // 8) * 8))
    for F, bn in ((1, 64), (64, 64), (65, 128), (128, 128), (129, 128), (4096, 128))
])
def test_bf16_tile_geometry(b, n_rows, F, n_sms, want):
    """The F tile width of the tensor-core ring is 128 where F needs more
    than 64 columns and the grid still covers the card's SMs (the H100's
    132), else 64; the operand pads to a multiple of 8 columns only when F
    is ragged, at every b; b < 64 gives 64-column tiles (the bf16 entries
    there take bf16_small_geometry's width)."""
    bn, ld = T.bf16_tile_geometry(b, n_rows, F, n_sms)
    assert (bn, ld) == want
    assert ld % 8 == 0
    assert (ld == F) == (F % 8 == 0)


@pytest.mark.parametrize("nb,F,want_bn", [
    (33, 512, 128),   # 132 CTAs at 128 columns
    (32, 512, 64),    # 128 at 128: 64 gives 256
    (40, 64, 64),     # never wider than F needs
])
def test_bf16_flat_launch_takes_the_geometry_at_nbr_rows(nb, F, want_bn, monkeypatch):
    """bf16 K1 and K5 launch one CTA row per block-row: their tile width
    is bf16_tile_geometry's at the flat plan's nbr rows (the resident
    plan packs the same flat layout)."""
    monkeypatch.setattr(T, "_sm_count", lambda index: 132)
    bsr = _with_empty_rows(t_bsr, nb, 128, 0.05, seed=nb, empty=(1,))
    for kw in ({"resident": False}, {"resident": True, "precision": "high"}):
        plan = T.bsr_spmm_pallas_plan(bsr, dtype=torch.bfloat16, grad=False,
                                      device="cpu", **kw)
        assert plan.statics[0] == ("resident" if kw["resident"] else "flat")
        nbr, blocks = plan.statics[1], plan.arrays[2]
        assert nbr == nb
        dense = torch.zeros(bsr.shape[1], F, dtype=torch.bfloat16)
        sizes, bn, _ = T._bf16_launch_args(blocks, dense, nbr)
        assert (bn, sizes[3]) == T.bf16_tile_geometry(128, nbr, F, 132)
        assert bn == want_bn and sizes[:3] == (blocks.shape[0], bsr.shape[1], F)


@pytest.mark.parametrize("F", [256, 70])
def test_bf16_launch_args_align_the_operand(F, monkeypatch):
    """The tensor-core loop's TMA map needs an operand that starts on 16
    bytes: a contiguous bf16 view at an odd element offset is copied to
    a fresh, aligned buffer with the same values (a ragged F is padded,
    which copies it anyway); an aligned operand passes as it is."""
    monkeypatch.setattr(T, "_sm_count", lambda index: 132)
    blocks = torch.zeros(4, 64, 64, dtype=torch.bfloat16)
    x = torch.arange(128 * F, dtype=torch.float32).reshape(128, F) % 33 - 16
    base = torch.empty(x.numel() + 1, dtype=torch.bfloat16)
    view = base[1:].view(128, F)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 == 2
    sizes, bn, dense = T._bf16_launch_args(blocks, view, 2)
    assert dense.data_ptr() % 16 == 0 and dense.is_contiguous()
    assert sizes[3] == dense.shape[1] and torch.equal(dense[:, :F], view)
    aligned = x.to(torch.bfloat16)
    assert aligned.data_ptr() % 16 == 0
    if F % 8 == 0:
        assert T._bf16_launch_args(blocks, aligned, 2)[2] is aligned


@pytest.mark.parametrize("nb,F,want_bn", [
    (33, 512, 128),   # 132 CTAs at 128 columns
    (32, 512, 64),    # 128 at 128: 64 gives 256
    (40, 64, 64),     # never wider than F needs
    (66, 133, 128),   # a ragged F (rows of 136 floats): 132 CTAs at 128
])
def test_f32_flat_and_rowgroup_launch_take_the_geometry_at_nbr_rows(
        nb, F, want_bn, monkeypatch):
    """Exact-f32 K1, K5 and K4 launch one CTA row per block-row (K4's
    phantom lanes return at once): their tile width and operand rows are
    tile_geometry(b, nbr, F, n_sms, 4)'s at the plan's nbr rows, as f32
    K2's are at its valid lanes'."""
    monkeypatch.setattr(T, "_sm_count", lambda index: 132)
    bsr = _with_empty_rows(t_bsr, nb, 128, 0.05, seed=nb, empty=(1,))
    blocks_of = {}
    for kw in ({"depth_sort": False}, {"resident": True, "depth_sort": False}):
        plan = T.bsr_spmm_pallas_plan(bsr, grad=False, device="cpu", **kw)
        assert plan.statics[0] == ("resident" if kw.get("resident") else "flat")
        assert plan.statics[1] == nb
        blocks_of[plan.statics[0]] = plan.arrays[2]
    rows, cols, blocks = _covered_parts(T, bsr)
    blocks_of["rowgroup"] = torch.as_tensor(
        T._pack_rowgroups(rows, cols, blocks, 4, 16)[2])
    dense = torch.zeros(bsr.shape[1], F)
    for layout, blocks in blocks_of.items():
        assert blocks.dtype == torch.float32, layout
        (f, ld), bn, _ = T._f32_launch_args(blocks, dense, nb)
        assert (bn, ld) == T.tile_geometry(128, nb, F, 132, 4)
        assert bn == want_bn and f == F and ld == -(-F // 4) * 4


@pytest.mark.parametrize("F", [256, 70, 133])
def test_f32_launch_args_align_the_operand(F, monkeypatch):
    """The pipelined FFMA loop's 16-byte copies need an operand that
    starts on 16 bytes, with rows of a multiple of 4 floats: a ragged F
    is padded with zero columns, a contiguous view 4 bytes past a 16-byte
    boundary is copied to a fresh, aligned buffer with the same values,
    and an aligned operand of whole rows passes as it is."""
    monkeypatch.setattr(T, "_sm_count", lambda index: 132)
    blocks = torch.zeros(4, 64, 64)
    x = torch.arange(128 * F, dtype=torch.float32).reshape(128, F)
    base = torch.empty(x.numel() + 1)
    view = base[1:].view(128, F)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    (f, ld), bn, dense = T._f32_launch_args(blocks, view, 2)
    assert dense.data_ptr() % 16 == 0 and dense.is_contiguous()
    assert (f, ld, dense.shape) == (F, -(-F // 4) * 4, (128, ld))
    assert torch.equal(dense[:, :F], view) and not dense[:, F:].any()
    assert x.data_ptr() % 16 == 0
    if F % 4 == 0:
        assert T._f32_launch_args(blocks, x, 2)[2] is x


# -- the exact-f32 small instances (b = 16, 32): geometry and lane order ----

# The arxiv stand-in's BSR plans under gorder (F = 128, the reorder
# phase's): at b = 32 814,720 slots with a 5,148-slot hub lane; at b = 16
# 954,112 slots with an 8,620-slot hub. rcmk's deepest row is 1,183 blocks.
@pytest.mark.parametrize("b,F,n_sms,n_slots,depth,want", [
    (32, 128, 132, 814720, 5148, (64, 128)),   # gorder: 128 is too wide
    (16, 128, 132, 954112, 8620, (32, 128)),   # gorder at b = 16
    (32, 128, 132, 814720, 8000, (32, 128)),   # a deeper hub
    (32, 128, 132, 900000, 1184, (128, 128)),  # rcmk-like: no hub
    (32, 256, 132, 18000, 134, (128, 256)),    # dense rows, few lanes
    (32, 128, 1, 200, 100, (128, 128)),        # exactly the hub's share
    (32, 128, 1, 199, 100, (64, 128)),         # just past it
    (32, 133, 1, 1000, 10, (128, 136)),        # ragged F pads to 4
    (16, 8, 1, 1000, 1, (32, 8)),              # never wider than F needs
    (16, 33, 1, 1000, 1, (64, 36)),
    (32, 64, 1, 1000, 1, (64, 64)),
    (32, 65, 1, 1000, 1, (128, 68)),
    (16, 128, 132, 0, 0, (128, 128)),          # no slots: nothing is deep
])
def test_f32_small_geometry(b, F, n_sms, n_slots, depth, want):
    """The exact-f32 entries at b = 16 and 32 take the widest of 128, 64
    and 32 columns that F needs and at which the deepest lane's CTA
    (depth * bn slot-columns) stays within its share of the grid, n_slots
    * F / (n_sms * F32_SMALL_HUB_SHARE = 2); else 32. The operand's rows
    pad to a multiple of 4 floats."""
    assert T.F32_SMALL_HUB_SHARE == 2
    bn, ld = T.f32_small_geometry(b, F, n_sms, n_slots, depth)
    assert (bn, ld) == want
    assert ld % 4 == 0 and 0 <= ld - F < 4


@pytest.mark.parametrize("F", [128, 70, 8])
@pytest.mark.parametrize("b", [16, 32])
def test_f32_launch_args_small_blocks(b, F, monkeypatch):
    """_f32_launch_args at b = 16 and 32: f32_small_geometry's (bn, ld) for
    the blocks' slot count and the plan's depth, the operand padded to
    ld columns (zeros) or copied to a 16-byte-aligned buffer; without a
    depth it raises (no geometry to fall back to)."""
    monkeypatch.setattr(T, "_sm_count", lambda index: 132)
    blocks = torch.zeros(600, b, b)
    x = torch.arange(4 * b * F, dtype=torch.float32).reshape(4 * b, F)
    base = torch.empty(x.numel() + 1)
    view = base[1:].view(4 * b, F)
    view.copy_(x)
    for depth in (1, 500):
        (f, ld), bn, dense = T._f32_launch_args(blocks, view, 2, depth)
        assert (bn, ld) == T.f32_small_geometry(b, F, 132, 600, depth)
        assert f == F and dense.shape == (4 * b, ld) and dense.data_ptr() % 16 == 0
        assert torch.equal(dense[:, :F], view) and not dense[:, F:].any()
    if F % 4 == 0:
        assert T._f32_launch_args(blocks, x, 2, 1)[2] is x
    with pytest.raises(ValueError, match="depth"):
        T._f32_launch_args(blocks, x, 2)


# -- the small-block tensor-core loop (bf16 and K3 at b = 16, 32) ----------

@pytest.mark.parametrize("b,F,n_sms,n_slots,depth,want", [
    (32, 128, 132, 814720, 5148, (64, 128)),   # gorder's hub at b = 32
    (16, 128, 132, 954112, 8620, (32, 128)),   # gorder's hub at b = 16
    (32, 128, 132, 814720, 3000, (128, 128)),  # a shallower hub
    (32, 128, 132, 814720, 8000, (32, 128)),   # a deeper one
    (32, 128, 132, 700880, 5152, (64, 128)),   # the flat plan (K1, gorder)
    (32, 128, 132, 840960, 1184, (128, 128)),  # rcmk: no hub
    (32, 256, 132, 18000, 134, (128, 256)),    # dense rows, few lanes
    (32, 128, 1, 200, 100, (128, 128)),        # one SM: exactly the share
    (32, 128, 1, 199, 100, (64, 128)),         # just past it
    (16, 8, 1, 1000, 1, (32, 8)),              # never wider than F needs
    (32, 70, 1, 1000, 1, (128, 72)),           # ragged F pads to 8
    (16, 133, 1, 1000, 1, (128, 136)),
    (32, 33, 1, 1000, 1, (64, 40)),
    (16, 128, 132, 0, 0, (128, 128)),          # no slots: nothing is deep
])
def test_bf16_small_geometry(b, F, n_sms, n_slots, depth, want):
    """The bf16 and K3 entries at b = 16 and 32 take the widest of 128, 64
    and 32 columns that F needs and at which the deepest lane's CTA (depth
    * bn slot-columns) stays within n_slots * F / (n_sms *
    BF16_SMALL_HUB_SHARE); else 32. The operand's rows pad to a multiple
    of 8 bf16 (16-byte copies)."""
    assert T.BF16_SMALL_HUB_SHARE == 2
    bn, ld = T.bf16_small_geometry(b, F, n_sms, n_slots, depth)
    assert (bn, ld) == want
    assert ld % 8 == 0 and 0 <= ld - F < 8


@pytest.mark.parametrize("F", [128, 70, 8, 133])
@pytest.mark.parametrize("b", [16, 32])
def test_bf16_launch_args_small_blocks(b, F, monkeypatch):
    """_bf16_launch_args at b = 16 and 32: (n_slots, n_dense_rows, F, ld)
    and bf16_small_geometry's bn for the blocks' slot count and the plan's
    depth; ld a multiple of 8; the operand padded with zero columns only
    where F is ragged, else passed as it is (an aligned one) or copied to
    a 16-byte-aligned buffer (a view at an odd offset); without a depth it
    raises (no geometry to fall back to)."""
    monkeypatch.setattr(T, "_sm_count", lambda index: 132)
    blocks = torch.zeros(600, b, b, dtype=torch.bfloat16)
    x = (torch.arange(4 * b * F).reshape(4 * b, F) % 251 - 125).to(torch.bfloat16)
    view = torch.empty(x.numel() + 1, dtype=torch.bfloat16)[1:].view(x.shape)
    view.copy_(x)
    assert view.is_contiguous() and view.data_ptr() % 16
    for depth in (1, 500):
        sizes, bn, dense = T._bf16_launch_args(blocks, view, 2, depth)
        assert (bn, sizes[3]) == T.bf16_small_geometry(b, F, 132, 600, depth)
        assert sizes[:3] == (600, 4 * b, F) and sizes[3] % 8 == 0
        assert dense.shape == (4 * b, sizes[3]) and dense.data_ptr() % 16 == 0
        assert torch.equal(dense[:, :F], view) and not dense[:, F:].any()
    padded = T._bf16_launch_args(blocks, x, 2, 1)[2]
    assert (padded is x) == (F % 8 == 0)
    with pytest.raises(ValueError, match="depth"):
        T._bf16_launch_args(blocks, x, 2)


@pytest.mark.parametrize("F", [128, 70, 8])
@pytest.mark.parametrize("b", [16, 32, 64])
def test_k3_launch_args(b, F, monkeypatch):
    """_k3_launch_args: one split of the f32 operand into (2N, ld) bf16
    planes, ld = F rounded up to a multiple of 8; bn from
    bf16_small_geometry at b = 16 and 32 (for the plan's depth) and from
    bf16_tile_geometry at 64; at b = 16 and 32 without a depth it raises
    before the split."""
    monkeypatch.setattr(T, "_sm_count", lambda index: 132)
    x = torch.as_tensor(np.random.default_rng(F).standard_normal(
        (4 * b, F)).astype(np.float32))
    splits = []
    monkeypatch.setattr(T, "split_operand",
                        lambda d: splits.append(d) or T.split_operand_plain(d))
    sizes, bn, xp = T._k3_launch_args(b, 600, x, 40, 500)
    ld = -(-F // 8) * 8
    assert sizes == (600, 4 * b, F, ld) and len(splits) == 1
    assert torch.equal(xp, T.split_operand_plain(x))
    want = (T.bf16_small_geometry(b, F, 132, 600, 500) if b < 64
            else T.bf16_tile_geometry(b, 40, F, 132))
    assert (bn, ld) == want
    if b < 64:
        with pytest.raises(ValueError, match="depth"):
            T._k3_launch_args(b, 600, x, 40)
        assert len(splits) == 1


def test_lane_order_is_deepest_first_and_stable():
    """lane_order: each group's R lanes share its step count; the lanes by
    step count, deepest first, ties in packed order; depth is the deepest
    lane's slots."""
    order, depth = T.lane_order(np.array([0, 3, 3, 8, 10, 13]), 2, 4)
    assert order.dtype == np.int32
    assert order.tolist() == [4, 5, 0, 1, 8, 9, 6, 7, 2, 3]
    assert depth == 5 * 4
    order, depth = T.lane_order(np.array([0, 1, 1, 2]), 1, 8)  # a flat walk
    assert order.tolist() == [0, 2, 1] and depth == 8
    order, depth = T.lane_order(np.array([0]), 16, 4)  # no groups
    assert order.size == 0 and depth == 0


def _hub_parts(b, seed):
    """24 block-rows of 40 block-columns: block-row 7 holds 30 blocks,
    block-row 3 none, the others 6 to 12 (a hub among shallow lanes; over
    8 real blocks a block-row, so the f32 plan sorts)."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for r in range(24):
        n = 30 if r == 7 else 0 if r == 3 else int(rng.integers(6, 13))
        rows += [r] * n
        cols += sorted(rng.choice(40, n, replace=False).tolist())
    blocks = rng.standard_normal((len(rows), b, b)).astype(np.float32)
    return (np.asarray(rows, np.int32), np.asarray(cols, np.int32), blocks,
            (24 * b - 5, 40 * b - 3), b)


def _walk_of(plan):
    """(pointer, R, slots a step) of a plan's CTA walk."""
    layout, geom = plan.statics[0], plan.statics[-1]
    if layout == "sorted":
        return plan.arrays[5], geom[0], geom[1]
    if layout == "rowgroup":
        return plan.arrays[3], geom[0], geom[1]
    return plan.arrays[3], 1, geom


# (plan kwargs, layout): exact f32 on each layout a plan packs, and bf16's
# row groups; "high" and bf16 plans carry the same arrays
LANE_ORDER_PLANS = [
    ({}, "sorted"), ({"depth_sort": False}, "flat"),
    ({"resident": True, "depth_sort": False}, "resident"),
    ({"precision": "high"}, "sorted"),
    ({"dtype": torch.bfloat16, "depth_sort": False}, "rowgroup"),
    ({"dtype": torch.bfloat16}, "sorted"),
]


@pytest.mark.parametrize("b", [16, 32])
@pytest.mark.parametrize("case", range(len(LANE_ORDER_PLANS)))
def test_plan_lane_order(case, b):
    """Every plan (the forward one and its grad plan's Aᵀ, which packs
    its own layout) carries its walk's lane order as its last array, an
    int32 permutation of the lanes, deepest first, ties in packed order,
    and the deepest lane's slots in statics[6]; the JAX packer's arrays
    before it are unchanged (the parity tests hold them). The order moves
    only which CTA runs when: the plan's answer is the plain versions'."""
    kw, layout = LANE_ORDER_PLANS[case]
    bsr = t_bsr.BSR.from_parts(*_hub_parts(b, seed=b + case))
    grad = T.bsr_spmm_pallas_plan(bsr, grad=True, device="cpu", **kw)
    fwd, bwd = grad.arrays
    assert fwd.statics[0] == layout
    for plan in (fwd, bwd):
        order = plan.arrays[-1]
        ptr, R, per_step = _walk_of(plan)
        steps = np.repeat(np.diff(ptr.numpy()), R)
        assert order.dtype == torch.int32
        assert sorted(order.tolist()) == list(range(steps.size))
        o = order.numpy()
        assert (np.diff(steps[o]) <= 0).all()
        same = np.diff(steps[o]) == 0
        assert (np.diff(o)[same] > 0).all()
        assert plan.statics[6] == steps.max() * per_step
    # the hub (30 blocks) is the forward plan's deepest lane
    assert fwd.statics[6] >= 30
    x = np.random.default_rng(b).standard_normal((bsr.shape[1], 9)).astype(np.float32)
    assert torch.equal(fwd(x), T.plain_apply(fwd, x))


def test_kernel_build_hashes_headers_and_includes_csrc(tmp_path, monkeypatch):
    """A library's name hashes its source and every header of csrc/ (an
    edit of the ring header that bsr_spmm.cu and bsr_spmm_int8.cu share
    rebuilds both), and nvcc gets csrc/ on its include path, so a source
    copied elsewhere (a variant build) still finds the header. nvcc is
    stubbed: no compiler runs here."""
    assert "tma_ring.cuh" in {h.name for h in _kernels.HEADERS}
    src = _kernels.SOURCES[1]
    header = tmp_path / "tma_ring.cuh"
    header.write_text("// one\n")
    monkeypatch.setattr(_kernels, "HEADERS", (header,))
    first = _kernels.library_path(src)
    assert _kernels.library_path(src) == first
    header.write_text("// two\n")
    assert _kernels.library_path(src) != first
    commands = []

    class FakeNvcc:
        returncode = 0

        def __init__(self, cmd, **kw):
            commands.append(cmd)
            (tmp_path / cmd[cmd.index("-o") + 1]).write_bytes(b"")

        def communicate(self):
            return "", ""

    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_kernels, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_kernels.subprocess, "Popen", FakeNvcc)
    paths = _kernels.build()
    assert len(commands) == len(_kernels.SOURCES) and all(p.exists() for p in paths)
    assert paths[1] == _kernels.library_path(src)
    for cmd in commands:
        assert cmd[cmd.index("-I") + 1] == str(_kernels.INCLUDE_DIR)
