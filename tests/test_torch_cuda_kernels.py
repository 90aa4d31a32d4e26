"""The CUDA kernels K1 (flat grouped gather), K2 (depth-sorted row
groups), K4 (consecutive row groups) and K5 (single-row resident), each
in f32 (on the pipelined FFMA loop at every b; at b = 16 and 32 its
small instances, with a hub lane thousands of slots deep among shallow
ones) and, on the tensor cores (the wgmma ring at b = 64 and 128, the
small-block mma.sync loop at b = 16 and 32, with its hub lanes too), in
bf16, K3 (the bf16x3 product, on K1's, K2's and K5's layouts, on the same
two tensor-core loops) and its operand split,
the int8 kernels K6 (flat), K7
(depth-sorted, group-scale and per-slot scales), K8 (consecutive row
groups) and K9 (single-row resident), all four on the int8 tensor cores
(the wgmma ring at b = 64 and 128, the small-block mma.sync loop at b =
16 and 32, with its hub lanes), and their operand's quantization
(quantize_int8, bit for bit), the CSR kernel K10 (one strip,
and column strips; f32, and bf16 at precision="default") and the f32
ELL tier's kernel (sdb_ell_spmm) against their plain PyTorch versions
on the card,
their launch counters (none under run(plan, x, plain=True)), the
wrappers' refusals, grad plans' backward on
the card against the plain backward, and the bench timers, spmm_tune's
handling of a refused launch and the profiler's trace of a launch. CUDA kernels have no CPU mode, so
these tests skip without a GPU; run them on one with

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

(tests/conftest.py imports jax, which these tests do not need).

Tolerance: 1e-5 relative to max |plain| (same operands in the same
dtype; only the order of the f32 sums differs), and bit-equality on the
inputs whose sums are exact in f32: the one that tells bf16x3 from exact
f32, the one that holds the bf16 tensor-core kernels to float64, and the
one that holds the int8 tensor-core kernels to float64."""

import importlib

import numpy as np
import pytest
import torch

from spmm_denseblock_tpu_torch.formats.bsr import BSR, random_bsr
from spmm_denseblock_tpu_torch.formats.csr import CSR, random_csr
from spmm_denseblock_tpu_torch.ops import _kernels, assert_allclose, spmm_scipy
from spmm_denseblock_tpu_torch.ops.plan import Plan, run as plan_run
from spmm_denseblock_tpu_torch.ops.reference import (
    bf16_exact_case,
    bf16x3_exact_case,
    int8_exact_case,
)

T = importlib.import_module("spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas")
TI = importlib.import_module("spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas_int8")
TP = importlib.import_module("spmm_denseblock_tpu_torch.ops.csr_spmm_pallas")

torch.set_num_threads(2)

# a string condition is evaluated when the test runs, not at import
pytestmark = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="needs an NVIDIA GPU: the CUDA kernels have no CPU mode",
)

TOL = 1e-5


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def _bsr(nb, b, p, seed, empty=(1, 5)):
    src = random_bsr(p, nb, nb, block_size=b, seed=seed)
    keep = ~np.isin(src.block_rows, empty)
    return BSR.from_parts(src.block_rows[keep], src.block_cols[keep],
                          src.blocks[keep], (nb * b - 3, nb * b - 7), b)


def _check(plan, x, kernel):
    before = kernel.launches
    got = plan(x)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    want = T.plain_apply(plan, x)
    assert got.shape == want.shape and got.dtype == torch.float32
    rel = (got - want).abs().max().item() / max(want.abs().max().item(), 1.0)
    assert rel < TOL, rel
    return got


@pytest.mark.parametrize("b", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("layout", ["flat", "sorted"])
def test_kernel_matches_plain(b, dtype, layout):
    """37 block-rows (not a multiple of R=16: absent lanes at pos 0),
    two empty block-rows (covered by zero blocks), ragged F. bf16 takes
    the flat layout only with resident=False."""
    bsr = _bsr(37, b, 0.3, seed=b)
    plan = T.bsr_spmm_pallas_plan(bsr, dtype=dtype, grad=False,
                                  depth_sort=layout == "sorted",
                                  resident=False if layout == "flat" else None,
                                  device="cuda")
    assert plan.statics[0] == layout
    kernel = getattr(_kernels, f"bsr_spmm_{layout}" + ("_bf16" if dtype else ""))
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (bsr.shape[1], 133)).astype(np.float32), device="cuda")
    got = _check(plan, x, kernel)
    if dtype is None:
        assert_allclose(got, spmm_scipy(bsr, x.cpu().numpy()))


def test_plan_matches_cpu_plan():
    bsr = _bsr(20, 32, 0.4, seed=1)
    x = np.random.default_rng(1).standard_normal((bsr.shape[1], 64)).astype(np.float32)
    cpu = T.bsr_spmm_pallas_plan(bsr, grad=False, device="cpu")
    gpu = T.bsr_spmm_pallas_plan(bsr, grad=False, device="cpu").to("cuda")
    assert_allclose(gpu(torch.as_tensor(x, device="cuda")), cpu(x))
    # with no device the plan goes to the card
    default = T.bsr_spmm_pallas_plan(bsr, grad=False)
    assert all(t.device.type == "cuda" for t in default.buffers())
    assert_allclose(default(torch.as_tensor(x, device="cuda")), cpu(x))


def test_wrappers_refuse_bad_operands():
    bsr = _bsr(8, 8, 0.5, seed=2)
    counts = [k.launches for k in _kernels.KERNELS]
    plan = T.bsr_spmm_pallas_plan(bsr, grad=False, device="cuda")
    with pytest.raises(ValueError, match="block size"):
        plan(torch.zeros(bsr.shape[1], 4, device="cuda"))
    plan = T.bsr_spmm_pallas_plan(_bsr(8, 16, 0.5, seed=2), grad=False,
                                  device="cuda")
    step_rows, slot_cols, blocks, step_ptr, _ = plan.arrays
    with pytest.raises(TypeError, match="dtype"):
        T.spmm_flat(step_rows, step_ptr, slot_cols, blocks.half(),
                    torch.zeros(128, 4, device="cuda", dtype=torch.half),
                    plan.statics[-1])
    with pytest.raises(ValueError, match="device"):
        T.spmm_flat(step_rows, step_ptr, slot_cols, blocks,
                    torch.zeros(128, 4), plan.statics[-1])
    assert [k.launches for k in _kernels.KERNELS] == counts


def _x(bsr, F=133, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(
        (bsr.shape[1], F)).astype(np.float32), device="cuda")


@pytest.mark.parametrize("b", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
@pytest.mark.parametrize("nb", [7, 37])
def test_rowgroup_kernel_matches_plain(b, dtype, nb):
    """K4 with f32 and bf16 operands. 7 block-rows at R=16 is one group
    with 9 phantom lanes, which must not store (the output has 7*b
    rows); 37 adds two empty rows and a ragged F."""
    bsr = _bsr(nb, b, 0.3, seed=b)
    cov = T._ensure_covering(bsr)
    R, gh = 16, 2
    step_groups, slot_cols, blocks_pad, n_groups = T._pack_rowgroups(
        cov.block_rows, cov.block_cols, cov.blocks, gh, R)
    dev = lambda a: torch.as_tensor(a, device="cuda")
    td = dtype or torch.float32
    group_ptr = T.group_pointer(step_groups, n_groups)
    args = (dev(step_groups), dev(group_ptr), dev(slot_cols),
            dev(blocks_pad).to(td))
    order, depth = T.lane_order(group_ptr, R, gh)
    x = _x(bsr)
    k_needed = bsr.n_block_cols * b
    x = torch.nn.functional.pad(x, (0, 0, 0, k_needed - x.shape[0])).to(td)
    kernel, other = _kernels.bsr_spmm_rowgroup, _kernels.bsr_spmm_rowgroup_bf16
    if dtype is not None:
        kernel, other = other, kernel
    before = kernel.launches, other.launches
    got = T.spmm_rowgroup(*args, x, bsr.n_block_rows, R, gh,
                          lane_order=dev(order), depth=depth)
    torch.cuda.synchronize()
    assert (kernel.launches, other.launches) == (before[0] + 1, before[1])
    want = T.spmm_rowgroup_plain(args[0], args[2], args[3], x,
                                 bsr.n_block_rows, R, gh)
    assert got.shape == want.shape == (bsr.n_block_rows * b, 133)
    rel = (got - want).abs().max().item() / max(want.abs().max().item(), 1.0)
    assert rel < TOL, rel


def test_rowgroup_plan_uses_k4():
    bsr = _bsr(37, 32, 0.3, seed=3)
    plan = T.bsr_spmm_pallas_plan(bsr, dtype=torch.bfloat16, grad=False,
                                  depth_sort=False, device="cuda")
    assert plan.statics[0] == "rowgroup"
    _check(plan, _x(bsr), _kernels.bsr_spmm_rowgroup_bf16)


# -- the bf16 tensor-core instances of K1, K2, K4 and K5 ---------------------

BF16_KERNELS = {"sorted": "bsr_spmm_sorted_bf16", "rowgroup": "bsr_spmm_rowgroup_bf16",
                "flat": "bsr_spmm_flat_bf16", "resident": "bsr_spmm_resident_bf16"}
# the bf16 plan's arguments that pack each layout
BF16_LAYOUT_KW = {"sorted": {"depth_sort": True}, "rowgroup": {"depth_sort": False},
                  "flat": {"resident": False},
                  "resident": {"precision": "high", "resident": True}}


def _bf16_plan(bsr, layout):
    plan = T.bsr_spmm_pallas_plan(bsr, dtype=torch.bfloat16, grad=False,
                                  device="cuda", **BF16_LAYOUT_KW[layout])
    assert plan.statics[0] == layout
    return plan


def _check_bf16(plan, x, layout):
    """One launch of the layout's bf16 entry and none of any other
    kernel (the f32 K2 and K4 counters stay put); returns (kernel,
    plain)."""
    kernel = getattr(_kernels, BF16_KERNELS[layout])
    counts = {k.symbol: k.launches for k in _kernels.KERNELS}
    got = plan(x)
    torch.cuda.synchronize()
    counts[kernel.symbol] += 1
    assert {k.symbol: k.launches for k in _kernels.KERNELS} == counts
    want = T.plain_apply(plan, x)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.isfinite(got).all()
    return got, want


def _widest_tiles(monkeypatch, wide):
    """wide: the geometry sees one SM, so every launch whose F needs more
    than 64 columns takes BN=128 (these small shapes take 64 on the
    card's SM count)."""
    if wide:
        monkeypatch.setattr(T, "_sm_count", lambda index: 1)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("F", [70, 256])
@pytest.mark.parametrize("layout", list(BF16_KERNELS))
@pytest.mark.parametrize("b", [16, 32, 64, 128])
def test_bf16_kernels_bit_exact(b, layout, F, wide, monkeypatch):
    """On bf16_exact_case every partial sum is an integer under 2^24, so
    the bf16 entries (the tensor-core ring at b = 64 and 128, the
    small-block mma.sync loop below) must equal float64 and their plain
    versions bit for bit:
    a misplaced fragment, swizzle or transposed operand would show.
    F=70 pads the operand to 72 columns; 7 block-rows leave absent (K2)
    and phantom (K4) lanes and an empty row (a zero block in K1/K5)."""
    _widest_tiles(monkeypatch, wide)
    bsr, x, want = bf16_exact_case(b, F, seed=b + F)
    got, plain = _check_bf16(_bf16_plan(bsr, layout), torch.as_tensor(x, device="cuda"),
                             layout)
    np.testing.assert_array_equal(got.double().cpu().numpy(), want)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("nb", [7, 37])
@pytest.mark.parametrize("F", [8, 70, 133, 256, 512])
@pytest.mark.parametrize("layout", list(BF16_KERNELS))
@pytest.mark.parametrize("b", [16, 32, 64, 128])
def test_bf16_kernels_match_plain(b, layout, F, nb, wide, monkeypatch):
    """The tensor-core loops (the ring at b = 64 and 128, the small-block
    mma.sync loop at 16 and 32) on random data within 1e-5 of their plain
    versions: ragged F (8 fits one 64-column box; 70 and 133 pad), 7
    block-rows (absent and phantom lanes), 37 (two empty rows), tiles of
    the width the card's geometry picks and of the widest the F needs."""
    _widest_tiles(monkeypatch, wide)
    bsr = _bsr(nb, b, 0.3, seed=b + nb)
    got, want = _check_bf16(_bf16_plan(bsr, layout), _x(bsr, F=F, seed=F), layout)
    rel = (got - want).abs().max().item() / max(want.abs().max().item(), 1.0)
    assert rel < TOL, rel


@pytest.mark.parametrize("layout", list(BF16_KERNELS))
@pytest.mark.parametrize("b", [16, 32, 64])
def test_bf16_entries_refuse_bad_geometry(b, layout):
    """A launch the entry refuses returns its cudaError_t and the wrapper
    raises; no launch is counted: an F tile width it has no kernel for
    (96 and 256 at every b, 32 on the ring at b = 64), an operand row
    length that is not a multiple of 8 or is shorter than F, and at b =
    16 and 32 (the small-block loop) a null lane order or an operand that
    does not start on 16 bytes."""
    bsr, _, _ = bf16_exact_case(b, 70)
    plan = _bf16_plan(bsr, layout)
    blocks = plan.arrays[2]
    dense = torch.zeros(bsr.shape[1], 72, device="cuda", dtype=torch.bfloat16)
    out = torch.empty(bsr.shape[0], 70, device="cuda")
    counts = [k.launches for k in _kernels.KERNELS]
    stream = torch.cuda.current_stream().cuda_stream
    kernel = getattr(_kernels, BF16_KERNELS[layout])
    order = plan.arrays[-1]
    if layout == "sorted":
        win_ids, slot_cols, _, pos, lane_valid, group_ptr, _ = plan.arrays
        R, gh, W = plan.statics[-1]
        head = (group_ptr, win_ids, pos, lane_valid, slot_cols)
        lanes, tail = (lane_valid.shape[0],), (R, gh, W, b)
    elif layout == "rowgroup":
        _, slot_cols, _, group_ptr, _ = plan.arrays
        R, gh = plan.statics[-1]
        head = (group_ptr, slot_cols)
        lanes, tail = ((group_ptr.shape[0] - 1) * R, plan.statics[1]), (R, gh, b)
    else:  # flat and resident: the step pointer, one lane per block-row
        _, slot_cols, _, step_ptr, _ = plan.arrays
        head = (step_ptr, slot_cols)
        lanes, tail = (plan.statics[1],), (plan.statics[-1], b)
    head = [t.data_ptr() for t in head]
    d, lo = dense.data_ptr(), order.data_ptr()
    # (operand, ld, bn, lane order)
    bad = [(d, 72, 96, lo), (d, 72, 256, lo), (d, 70, 64, lo), (d, 64, 64, lo)]
    bad += [(d, 72, 32, lo)] if b == 64 else [(d, 72, 64, 0), (d + 2, 72, 64, lo)]
    for ptr, ld, bn, lo_ptr in bad:
        with pytest.raises(RuntimeError, match="cudaError_t"):
            kernel(*head, lo_ptr, blocks.data_ptr(), ptr, out.data_ptr(), *lanes,
                   blocks.shape[0], dense.shape[0], 70, ld, *tail, bn, stream)
    assert [k.launches for k in _kernels.KERNELS] == counts


@pytest.mark.parametrize("layout", list(BF16_KERNELS))
@pytest.mark.parametrize("b", [16, 32, 64, 128])
def test_bf16_operand_at_odd_offset(b, layout):
    """A contiguous bf16 operand that starts 2 bytes past a 16-byte
    boundary (a view at an odd element offset): the ring's TMA map and
    the small-block loop's 16-byte copies need an aligned base, so the
    wrapper copies it; every bf16
    entry gives float64's answer and its plain version's, bit for bit."""
    bsr, x, want = bf16_exact_case(b, 256, seed=b + 1)
    base = torch.empty(x.size + 1, dtype=torch.bfloat16, device="cuda")
    view = base[1:].view(x.shape)
    view.copy_(torch.as_tensor(x))
    assert view.is_contiguous() and view.data_ptr() % 16 == 2
    got, plain = _check_bf16(_bf16_plan(bsr, layout), view, layout)
    np.testing.assert_array_equal(got.double().cpu().numpy(), want)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("kw,layout,dtype", [
    ({"resident": False}, "flat", torch.bfloat16),
    ({"depth_sort": False}, "flat", None),
    ({"precision": "high", "resident": True}, "resident", torch.bfloat16),
    ({"resident": True, "depth_sort": False}, "resident", None),
])
def test_k1_k5_counters_split_by_dtype(kw, layout, dtype):
    """bf16 K1 and K5 count on their own entries (bsr_spmm_flat_bf16,
    bsr_spmm_resident_bf16) and f32 K1 and K5 on theirs: one launch, on
    the one counter of the layout and dtype."""
    bsr = _bsr(37, 64, 0.3, seed=9)
    plan = T.bsr_spmm_pallas_plan(bsr, dtype=dtype, grad=False, device="cuda", **kw)
    assert plan.statics[0] == layout
    name = f"bsr_spmm_{layout}" + ("_bf16" if dtype else "")
    counts = {k.symbol: k.launches for k in _kernels.KERNELS}
    _check(plan, _x(bsr, F=96, seed=9), getattr(_kernels, name))
    counts["sdb_" + name] += 1
    assert {k.symbol: k.launches for k in _kernels.KERNELS} == counts


INT8_CASES = {
    # name: (plan kwargs, kernel)
    "flat": ({"resident": False}, "bsr_spmm_int8_flat"),
    "sorted": ({"depth_sort": True}, "bsr_spmm_int8_sorted"),
    "sorted_per_slot": ({"depth_sort": True, "group_scale": False},
                        "bsr_spmm_int8_sorted"),
    "rowgroup": ({"depth_sort": False}, "bsr_spmm_int8_rowgroup"),
}


@pytest.mark.parametrize("b", [16, 32, 64, 128])
@pytest.mark.parametrize("case", list(INT8_CASES))
@pytest.mark.parametrize("nb", [7, 37])
def test_int8_kernel_matches_plain(b, case, nb):
    """K6, K7 (both scale modes) and K8 on the same quantized operand as
    their plain versions. 37 block-rows: K7's second window holds 5 rows,
    so 3 absent lanes sit at pos 0; 7 block-rows: K8's one group has a
    phantom lane. Two empty rows, ragged F, a calibrated plan for b=64."""
    bsr = _bsr(nb, b, 0.3, seed=b + 1)
    kw, name = INT8_CASES[case]
    x = _x(bsr, seed=1)
    if b == 64:
        kw = {**kw, "calibration": x}
    plan = TI.bsr_spmm_pallas_int8_plan(bsr, device="cuda", **kw)
    assert plan.statics[0] == case.split("_")[0]
    got = _check(plan, x, getattr(_kernels, name))
    want = spmm_scipy(bsr, x.cpu().numpy())
    rel = np.abs(got.cpu().numpy() - want).max() / np.abs(want).max()
    assert rel < 6e-2, rel


def test_int8_wrappers_refuse_bad_operands():
    """Wrong dtypes, and scales of another layout's length: a per-slot
    scales array fed to the group-scale layout (and back) raises."""
    bsr = _bsr(21, 16, 0.4, seed=4)
    plan = TI.bsr_spmm_pallas_int8_plan(bsr, depth_sort=True, device="cuda")
    win_ids, slot_cols, qblocks, scales, pos, lane_valid, group_ptr = plan.arrays[:7]
    nbr = plan.statics[1]
    R, gh, W, _ = plan.statics[5]
    q, cs = TI.quantize_operand(plan, _x(bsr))
    counts = [k.launches for k in _kernels.KERNELS]
    run = lambda qb, sc, gs, qd=q, c=cs: TI.spmm_int8_sorted(
        win_ids, pos, slot_cols, qb, sc, qd, c, lane_valid, group_ptr, nbr,
        R, gh, W, gs)
    per_slot = torch.ones(qblocks.shape[0], device="cuda")
    with pytest.raises(ValueError, match="scales"):
        run(qblocks, per_slot, True)
    with pytest.raises(ValueError, match="scales"):
        run(qblocks, scales, False)
    with pytest.raises(TypeError, match="dtype"):
        run(qblocks.float(), scales, True)
    with pytest.raises(TypeError, match="scales"):
        run(qblocks, scales.double(), True)
    with pytest.raises(ValueError, match="col_scale"):
        run(qblocks, scales, True, c=cs[:-1])
    with pytest.raises(ValueError, match="device"):
        run(qblocks, scales, True, qd=q.cpu())
    flat = TI.bsr_spmm_pallas_int8_plan(bsr, resident=False, device="cuda")
    step_rows, f_cols, f_q, f_scales, step_ptr = flat.arrays[:5]
    with pytest.raises(ValueError, match="scales"):
        TI.spmm_int8_flat(step_rows, step_ptr, f_cols, f_q, f_scales[:-1], q,
                          cs, flat.statics[5])
    assert [k.launches for k in _kernels.KERNELS] == counts


def saturated_lane_case(device="cpu", b=128, signed=False):
    """A group-scale plan whose lane sums pass 2^24: 8 block-rows of gh =
    2048 / b blocks (one lane-step per row; 16 at b = 128, 64 at b = 32)
    and an operand whose entries all quantize to +-127: all ones, or with
    signed=True each depth k's block column and operand row of one sign
    s_k, so every product is +127^2. Each output is one lane sum of 2048
    products 127^2 = 33,032,192. A float32 running sum rounds past 2^24;
    an exact sum does not."""
    nb, gh = 8, 2048 // b
    rows = np.repeat(np.arange(nb), gh).astype(np.int32)
    cols = np.tile(np.arange(gh), nb).astype(np.int32)
    sign = (np.where(np.random.default_rng(b).random(gh * b) < 0.5, -1.0, 1.0)
            if signed else np.ones(gh * b)).astype(np.float32)
    blocks = np.broadcast_to(sign.reshape(gh, 1, b), (gh, b, b))
    blocks = np.tile(blocks, (nb, 1, 1)).astype(np.float32)
    bsr = BSR.from_parts(rows, cols, blocks, (nb * b, gh * b), b)
    plan = TI.bsr_spmm_pallas_int8_plan(bsr, depth_sort=True, group=gh,
                                        device=device)
    x = torch.as_tensor(np.repeat(sign[:, None], 8, axis=1), device=device)
    exact = np.float32(np.float32(1 / 127.0) * np.float32(33032192.0))
    exact = np.float32(np.float32(1.0 / 127.0) * exact)
    return plan, x, exact


@pytest.mark.parametrize("b,signed", [(128, False), (32, True)])
def test_int8_group_scale_sum_is_exact(b, signed):
    """K7's group-scale lane sum passes 2^24 (127^2 * 2048) and stays
    exact in int32, on the ring (b = 128, all ones) and on the small-block
    loop (b = 32, 64 slots a lane-step, blocks and operand at +-127): the
    kernel's answer equals the plain version's (an exact float64 sum) and
    the exact lane sum bit for bit."""
    plan, x, exact = saturated_lane_case(device="cuda", b=b, signed=signed)
    assert plan.statics[5][:2] == (8, 2048 // b)
    assert plan.arrays[2].abs().min() == 127
    got = _check(plan, x, _kernels.bsr_spmm_int8_sorted)
    assert torch.equal(got, TI.run_quantized(plan, *TI.quantize_operand(plan, x),
                                             plain=True))
    assert (got.cpu().numpy() == exact).all()


# -- K6-K9 on the int8 tensor cores (b = 64 and 128) ------------------------

INT8_RING_CASES = {
    # name: (plan kwargs, layout, kernel)
    "sorted": ({"depth_sort": True}, "sorted", "bsr_spmm_int8_sorted"),
    "sorted_per_slot": ({"depth_sort": True, "group_scale": False}, "sorted",
                        "bsr_spmm_int8_sorted"),
    "rowgroup": ({"depth_sort": False}, "rowgroup", "bsr_spmm_int8_rowgroup"),
    "flat": ({"resident": False}, "flat", "bsr_spmm_int8_flat"),
    "resident": ({"resident": True, "f_tile": 128}, "resident",
                 "bsr_spmm_int8_resident"),
}


def _int8_plan(bsr, case):
    kw, layout, name = INT8_RING_CASES[case]
    plan = TI.bsr_spmm_pallas_int8_plan(bsr, device="cuda", **kw)
    assert plan.statics[0] == layout
    return plan, getattr(_kernels, name)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("F", [70, 256])
@pytest.mark.parametrize("nb", [7, 37])
@pytest.mark.parametrize("b", [16, 32, 64, 128])
@pytest.mark.parametrize("case", list(INT8_RING_CASES))
def test_int8_ring_bit_exact(case, b, nb, F, wide, monkeypatch):
    """On int8_exact_case nothing rounds before the column scale, so K7
    (both scale modes), K8, K6 and K9 on the ring (b = 64 and 128) and on
    the small-block loop (b = 16 and 32) must equal float64 and their
    plain versions bit for bit: a swizzle, descriptor, ldmatrix or
    fragment error would show. 37 block-rows leave absent (K7) and
    phantom (K8) lanes, and empty rows (K6, K9: a row of zero blocks); F =
    70 is ragged (rows of the transposed operand past F read as zeros);
    the ring at tiles of 64 columns and of the widest the F needs, the
    small-block loop at 32 columns and at its geometry's width."""
    if wide:  # one SM: every F > 64 takes 128-column tiles
        monkeypatch.setattr(TI, "_sm_count", lambda index: 1)
    elif b < 64:
        _force_int8_small_bn(monkeypatch, 32)
    bsr, x, want = int8_exact_case(b, F, seed=b + nb + F, n_block_rows=nb)
    plan, kernel = _int8_plan(bsr, case)
    x = torch.as_tensor(x, device="cuda")
    got = _check(plan, x, kernel)
    np.testing.assert_array_equal(got.double().cpu().numpy(), want)
    assert torch.equal(got, T.plain_apply(plan, x))


@pytest.mark.parametrize("view", ["offset", "strided"])
@pytest.mark.parametrize("case", ["sorted", "rowgroup", "flat", "resident"])
@pytest.mark.parametrize("b", [16, 32, 64, 128])
def test_int8_operand_at_odd_offset(b, case, view):
    """K7, K8, K6 and K9 on a quantized operand 1 byte past a 16-byte boundary
    (contiguous) and on a non-contiguous one: the transposed copy both
    loops read is aligned and contiguous whatever it is given; the answer
    equals float64 and the plain version bit for bit."""
    bsr, x, want = int8_exact_case(b, 256, seed=b + 1)
    plan, kernel = _int8_plan(bsr, case)
    q, cs = TI.quantize_operand(plan, torch.as_tensor(x, device="cuda"))
    if view == "offset":
        base = torch.empty(q.numel() + 16, dtype=torch.int8, device="cuda")
        skip = (1 - base.data_ptr()) % 16
        qv = base[skip:skip + q.numel()].view(q.shape)
        qv.copy_(q)
        assert qv.is_contiguous() and qv.data_ptr() % 16 == 1
    else:
        wide = torch.zeros(q.shape[0], q.shape[1] + 3, dtype=torch.int8,
                           device="cuda")
        wide[:, 1:-2] = q
        qv = wide[:, 1:-2]
        assert not qv.is_contiguous()
    before = kernel.launches
    got = TI.run_quantized(plan, qv, cs)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    np.testing.assert_array_equal(got.double().cpu().numpy(), want)
    assert torch.equal(got, TI.run_quantized(plan, qv, cs, plain=True))


@pytest.mark.parametrize("case", ["sorted", "rowgroup", "flat", "resident"])
def test_int8_ring_takes_a_transposed_operand(case):
    """run_quantized(qdense_t=transpose_operand(q)) launches the ring on
    the caller's transposed operand, with the answer of the call that
    makes it, and so does quantize_operand(transposed=True)'s operand
    alone (qdense None); one that is not (F, N) contiguous int8 raises
    before any launch."""
    bsr, x, want = int8_exact_case(128, 96, seed=5)
    plan, kernel = _int8_plan(bsr, case)
    q, cs = TI.quantize_operand(plan, torch.as_tensor(x, device="cuda"))
    qt = TI.transpose_operand(q)
    got = TI.run_quantized(plan, q, cs, qdense_t=qt)
    np.testing.assert_array_equal(got.double().cpu().numpy(), want)
    qt2, cs2 = TI.quantize_operand(plan, torch.as_tensor(x, device="cuda"),
                                   transposed=True)
    assert torch.equal(qt2, qt) and torch.equal(cs2, cs)
    assert torch.equal(TI.run_quantized(plan, None, cs2, qdense_t=qt2), got)
    before = kernel.launches
    for bad in (q, qt[:, :-16], qt.t().contiguous().t(), qt.to(torch.uint8)):
        with pytest.raises(ValueError, match="qdense_t"):
            TI.run_quantized(plan, q, cs, qdense_t=bad)
    assert kernel.launches == before


@pytest.mark.parametrize("case", ["sorted", "rowgroup", "flat", "resident"])
def test_int8_entries_refuse_bad_geometry(case):
    """A K7, K8, K6 or K9 launch the entry refuses returns its cudaError_t
    and the wrapper raises; no launch is counted: an F tile width neither
    loop has a kernel for (the ring takes 64 and 128 at b = 64 and 128,
    the small-block loop 32, 64 and 128 at b = 16 and 32), no transposed
    operand (read at every b), and no lane order at b = 16 and 32. The
    same arguments with the tile width, operand and lane order the plan
    gives launch."""
    stream = torch.cuda.current_stream().cuda_stream
    for b, bn, with_t, with_order in (
            (64, 96, True, True), (64, 256, True, True), (128, 32, True, True),
            (16, 256, True, True), (32, 48, True, True), (16, 64, False, True),
            (64, 64, False, True), (32, 64, True, False), (16, 32, True, False),
            (32, 64, True, True)):
        bsr, x, _ = int8_exact_case(b, 70)
        plan, kernel = _int8_plan(bsr, case)
        qt, cs = TI.quantize_operand(plan, torch.as_tensor(x, device="cuda"),
                                     transposed=True)
        out = torch.empty(bsr.shape[0], 70, device="cuda")
        qt_ptr = qt.data_ptr() if with_t else 0
        n_layout = 7 if case == "sorted" else 5
        order = plan.arrays[n_layout].data_ptr() if with_order else 0
        if case == "sorted":
            win_ids, slot_cols, qblocks, scales, pos, lane_valid, group_ptr = plan.arrays[:7]
            R, gh, W, gs = plan.statics[5]
            ptrs = (group_ptr, win_ids, pos, lane_valid, slot_cols, order, qblocks,
                    scales)
            sizes = (lane_valid.shape[0], qblocks.shape[0], qt.shape[1], 70, R, gh,
                     W, b, bn, int(gs))
        elif case == "rowgroup":
            step_groups, slot_cols, qblocks, scales, group_ptr = plan.arrays[:5]
            R, gh = plan.statics[5]
            ptrs = (group_ptr, slot_cols, order, qblocks, scales)
            sizes = ((group_ptr.shape[0] - 1) * R, plan.statics[1], qblocks.shape[0],
                     qt.shape[1], 70, R, gh, b, bn)
        else:
            step_rows, slot_cols, qblocks, scales, step_ptr = plan.arrays[:5]
            group = plan.statics[5][0] if case == "resident" else plan.statics[5]
            ptrs = (step_ptr, slot_cols, order, qblocks, scales)
            sizes = (plan.statics[1], qblocks.shape[0], qt.shape[1], 70, group, b, bn)
        ptrs = [p if isinstance(p, int) else p.data_ptr() for p in ptrs]
        ptrs += [qt_ptr, cs.data_ptr(), out.data_ptr()]
        counts = [k.launches for k in _kernels.KERNELS]
        if with_t and with_order and bn == 64 and b == 32:
            kernel(*ptrs, *sizes, stream)  # the plan's own arguments launch
            torch.cuda.synchronize()
            counts[_kernels.KERNELS.index(kernel)] += 1
        else:
            with pytest.raises(RuntimeError, match="cudaError_t"):
                kernel(*ptrs, *sizes, stream)
        assert [k.launches for k in _kernels.KERNELS] == counts


def _force_int8_small_bn(monkeypatch, bn):
    """The int8 entries at b = 16 and 32 launch at bn columns."""
    monkeypatch.setattr(TI, "int8_small_geometry",
                        lambda b, F, n_sms, n_slots, depth: bn)


@pytest.mark.parametrize("case", list(INT8_RING_CASES))
@pytest.mark.parametrize("bn", [32, 64, 128])
@pytest.mark.parametrize("F", [8, 70, 200])
@pytest.mark.parametrize("b", [16, 32])
def test_int8_small_instances_match_plain(b, F, bn, case, monkeypatch):
    """Each instance of the small-block int8 loop (b = 16 and 32, tiles of
    32, 64 and 128 columns, per-slot and group scales) on every walk, on
    37 block-rows (absent and phantom lanes, empty rows) and ragged F:
    within 1e-5 of its plain version on random data, and bit for bit
    equal to the same kernel at 32 columns (each output's terms are
    added in the same order at every tile width)."""
    bsr = _bsr(37, b, 0.3, seed=b + F)
    plan, kernel = _int8_plan(bsr, case)
    x = _x(bsr, F=F, seed=F)
    _force_int8_small_bn(monkeypatch, bn)
    got = _check(plan, x, kernel)
    _force_int8_small_bn(monkeypatch, 32)
    assert torch.equal(got, plan(x))


@pytest.mark.parametrize("case", ["sorted", "sorted_per_slot", "flat"])
@pytest.mark.parametrize("b", [16, 32])
def test_int8_small_hub_lane(b, case):
    """One hub lane 4,096 blocks deep among lanes of a few blocks, on the
    small-block int8 loop (K7 in both scale modes, K6), started first by
    the plan's lane order: the hub's 4,096 scaled slot (or lane-step)
    sums, added in f32 in walk order, stay within 1e-5 of the plain
    version on standard-normal data."""
    hub = 4096
    kw, _, name = INT8_RING_CASES[case]
    bsr, x_np = _hub_bsr(b, hub, False, seed=b)
    plan = TI.bsr_spmm_pallas_int8_plan(bsr, device="cuda", **kw)
    assert plan.statics[6] >= hub
    order = plan.arrays[7 if case.startswith("sorted") else 5]
    assert order.dtype == torch.int32
    got = _check(plan, torch.as_tensor(x_np, device="cuda"), getattr(_kernels, name))
    want = spmm_scipy(bsr, x_np)
    assert np.abs(got.cpu().numpy() - want).max() / np.abs(want).max() < 6e-2


# -- the int8 operand's quantization (quantize_int8) ------------------------

Q_ROWS, Q_OUT = 300, 320  # operand rows, and rows with the block grid's pad


def _quantize_input(kind, F, seed):
    """(x (Q_ROWS, F) f32, scales (F,) f32, powers of two) of one case.
    ties: each column's absmax is 127 s (so its dynamic scale is s
    exactly) and every other entry is (k + 1/2) s, rows 0 and 1 2.5 s and
    -1.5 s: every quotient is a tie, 2.5 -> 2 and -1.5 -> -2 (half to
    even); clip: entries up to 300 s, past a static scale s's +-127;
    zero: every third column zeros (dynamic scale 1, q 0) among columns
    of random magnitudes; nonfinite: random columns with one NaN in each
    column f = 0 (mod 4), one +Inf at f = 1 and one -Inf at f = 2."""
    rng = np.random.default_rng(seed)
    s = np.exp2(rng.integers(-8, 8, size=F)).astype(np.float32)
    if kind in ("zero", "nonfinite"):
        x = (rng.standard_normal((Q_ROWS, F)) * rng.uniform(0.01, 50.0, F))
        if kind == "zero":
            x[:, ::3] = 0.0
        else:
            rows = rng.integers(0, Q_ROWS, size=F)
            x[rows, np.arange(F)] = np.array([np.nan, np.inf, -np.inf, 1.0])[
                np.arange(F) % 4]
        return x.astype(np.float32), s
    top = 127 if kind == "ties" else 300
    x = (rng.integers(-top, top, size=(Q_ROWS, F)) + 0.5) * s
    if kind == "ties":
        x[0], x[1] = 2.5 * s, -1.5 * s
        x[rng.integers(2, Q_ROWS, size=F), np.arange(F)] = (
            127.0 * s * rng.choice([-1.0, 1.0], size=F))
    return x.astype(np.float32), s


def _f32_view(x, view):
    """x on the card: contiguous, one float past a 16-byte boundary, or a
    column slice of a wider buffer (row stride F + 5)."""
    t = torch.as_tensor(x, device="cuda")
    if view == "offset":
        base = torch.empty(t.numel() + 4, device="cuda")
        skip = (4 - base.data_ptr() % 16) % 16 // 4
        v = base[skip:skip + t.numel()].view(t.shape)
        v.copy_(t)
        assert v.is_contiguous() and v.data_ptr() % 16 == 4
        return v
    if view == "strided":
        wide = torch.zeros(t.shape[0], t.shape[1] + 5, device="cuda")
        wide[:, 2:-3] = t
        return wide[:, 2:-3]
    return t


@pytest.mark.parametrize("view", ["contiguous", "offset", "strided"])
@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("F", [1, 70, 133])
@pytest.mark.parametrize("kind", ["ties", "clip", "zero", "nonfinite"])
def test_quantize_kernel_bit_exact(kind, F, static, transposed, view):
    """quantize_int8 on the card (one launch) equals its plain version
    (quantize_per_column with the pad, then transpose_operand) on the
    same operand and on the CPU, bit for bit: the int8 values and the
    scales, dynamic and static, both layouts, pad rows zero. A NaN
    quantizes to 0, a static +-Inf to +-127, and a dynamic +-Inf column
    (scale Inf) to 0, as JAX's _quantize_cols(_static) give."""
    x, s = _quantize_input(kind, F, seed=F + 7)
    xv = _f32_view(x, view)
    cs = torch.as_tensor(s, device="cuda") if static else None
    before = _kernels.quantize_int8.launches
    q, got_cs = TI.quantize_int8(xv, Q_OUT, cs, transposed)
    torch.cuda.synchronize()
    assert _kernels.quantize_int8.launches == before + 1
    want_q, want_cs = TI.quantize_int8_plain(xv, Q_OUT, cs, transposed)
    cpu_q, cpu_cs = TI.quantize_int8_plain(torch.as_tensor(x), Q_OUT,
                                           None if cs is None else cs.cpu(),
                                           transposed)
    assert q.shape == ((F, Q_OUT) if transposed else (Q_OUT, F))
    assert q.dtype == torch.int8 and q.is_contiguous() and q.data_ptr() % 16 == 0
    assert torch.equal(q, want_q) and torch.equal(got_cs, want_cs)
    assert torch.equal(q.cpu(), cpu_q) and torch.equal(got_cs.cpu(), cpu_cs)
    rows = q.t() if transposed else q
    assert not rows[Q_ROWS:].any()
    if kind == "ties":
        assert (rows[0] == 2).all() and (rows[1] == -2).all()
        assert torch.equal(got_cs.cpu(), torch.as_tensor(s))
    if kind == "clip" and static:
        assert (rows.abs() == 127).sum() > Q_ROWS * F // 4
    if kind == "zero" and not static:
        assert (got_cs[::3] == 1).all() and not rows[:, ::3].any()
    if kind == "nonfinite":
        xc = torch.as_tensor(x, device="cuda")
        assert not rows[:Q_ROWS][xc.isnan()].any()
        if static:
            assert (rows[:Q_ROWS][xc == np.inf] == 127).all()
            assert (rows[:Q_ROWS][xc == -np.inf] == -127).all()
        else:
            assert (got_cs[::4] == 1).all() and got_cs[1::4].isinf().all()
            assert got_cs[2::4].isinf().all()
            assert not rows[:, 1::4].any() and not rows[:, 2::4].any()


def test_quantize_entry_refuses_bad_geometry():
    """The wrapper refuses fewer output rows than the operand has, and a
    transposed layout whose rows are not a multiple of 16 bytes; the
    entry refuses an unaligned transposed output and a missing scratch
    (cudaError_t); no launch is counted."""
    x = torch.ones(40, 8, device="cuda")
    counts = [k.launches for k in _kernels.KERNELS]
    for n_out, transposed in ((32, False), (40, True)):
        with pytest.raises(ValueError, match="n_out"):
            TI.quantize_int8(x, n_out, None, transposed)
    q = torch.empty(8 * 48 + 16, dtype=torch.int8, device="cuda")
    cs = torch.empty(16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    for q_ptr, absmax in ((q.data_ptr() + 1, cs.data_ptr() + 32),
                          (q.data_ptr(), 0)):
        with pytest.raises(RuntimeError, match="cudaError_t"):
            _kernels.quantize_int8(x.data_ptr(), 0, absmax, q_ptr, cs.data_ptr(),
                                   8, 40, 8, 48, 1, stream)
    assert [k.launches for k in _kernels.KERNELS] == counts


@pytest.mark.parametrize("static", [False, True])
def test_plan_call_quantizes_with_one_kernel(static, monkeypatch):
    """At b = 128 a plan's call on the card makes its operand with one
    quantize_int8 launch and runs neither quantize_per_column nor
    transpose_operand (replaced here by functions that raise): K6, K7
    (both scale modes), K8 and K9 each answer as the plain path, bit for
    bit, with dynamic and with static (calibrated) scales."""
    bsr, x, want = int8_exact_case(128, 256, seed=11, n_block_rows=37)
    x = torch.as_tensor(x, device="cuda")
    plans, wants = {}, {}
    for case, (kw, layout, name) in INT8_RING_CASES.items():
        if static:
            kw = {**kw, "calibration": x[:2000]}
        plans[case] = (TI.bsr_spmm_pallas_int8_plan(bsr, device="cuda", **kw),
                       getattr(_kernels, name))
        assert plans[case][0].statics[0] == layout
        wants[case] = T.plain_apply(plans[case][0], x)
    if not static:
        assert all(torch.equal(w.double().cpu(), torch.as_tensor(want))
                   for w in wants.values())

    def refused(*args, **kwargs):
        raise AssertionError("a plan's call on the card made an (N, F) int8 operand")

    monkeypatch.setattr(TI, "quantize_per_column", refused)
    monkeypatch.setattr(TI, "transpose_operand", refused)
    for case, (plan, kernel) in plans.items():
        before = _kernels.quantize_int8.launches, kernel.launches
        got = plan(x)
        torch.cuda.synchronize()
        assert (_kernels.quantize_int8.launches, kernel.launches) == (
            before[0] + 1, before[1] + 1)
        assert torch.equal(got, wants[case]), case


K3_K5_CASES = {
    # name: (plan kwargs, layout, kernel)
    "k3_flat": ({"precision": "high", "depth_sort": False}, "flat",
                "bsr_spmm_flat_bf16x3"),
    "k3_sorted": ({"precision": "high", "depth_sort": True}, "sorted",
                  "bsr_spmm_sorted_bf16x3"),
    "k3_resident": ({"precision": "high", "resident": True, "depth_sort": False},
                    "resident", "bsr_spmm_resident_bf16x3"),
    "k5": ({"resident": True, "depth_sort": False}, "resident",
           "bsr_spmm_resident"),
    "k5_bf16": ({"resident": True, "precision": "high", "dtype": torch.bfloat16},
                "resident", "bsr_spmm_resident_bf16"),
}


@pytest.mark.parametrize("b", [16, 32, 64, 128])
@pytest.mark.parametrize("case", list(K3_K5_CASES))
def test_k3_k5_kernel_matches_plain(b, case):
    """K3's three instances and K5 (f32 and bf16) against their plain
    versions; 37 block-rows with two empty ones (about 10 real blocks
    per row, so "high" can sort), ragged F. K3 is f32-grade: within
    1e-4 of the scipy oracle."""
    bsr = _bsr(37, b, 0.3, seed=b + 2)
    kw, layout, name = K3_K5_CASES[case]
    plan = T.bsr_spmm_pallas_plan(bsr, grad=False, device="cuda", **kw)
    assert plan.statics[0] == layout
    got = _check(plan, _x(bsr, seed=2), getattr(_kernels, name))
    want = spmm_scipy(bsr, _x(bsr, seed=2).cpu().numpy())
    rel = np.abs(got.cpu().numpy() - want).max() / np.abs(want).max()
    assert rel < (3e-2 if "dtype" in kw else 1e-4), rel


K3_LAYOUT_KERNELS = {
    # layout: (plan kwargs, K3 kernel, the exact f32 kernel of the layout);
    # K3 has no row-group instance, and f32 K4's plan is packed by hand
    "sorted": ({}, "bsr_spmm_sorted_bf16x3", "bsr_spmm_sorted"),
    "flat": ({"depth_sort": False}, "bsr_spmm_flat_bf16x3", "bsr_spmm_flat"),
    "resident": ({"resident": True, "depth_sort": False},
                 "bsr_spmm_resident_bf16x3", "bsr_spmm_resident"),
    "rowgroup": (None, None, "bsr_spmm_rowgroup"),
}


def _f32_rowgroup_plan(bsr) -> Plan:
    """f32 K4's plan. The plan routes only bf16 to the row-group layout,
    so this packs it as the bf16 plan does (R = 16, the power-of-two
    group capped at 16) and keeps the blocks in f32."""
    cov = T._ensure_covering(bsr)
    rows = cov.block_rows[: cov.nnzb]
    gh = min(T._auto_group_pow2(cov.nnzb, np.unique(rows).size), 16)
    R, _ = T._rowgroup_policy(2, gh)
    step_groups, slot_cols, blocks, n_groups = T._pack_rowgroups(
        rows, cov.block_cols[: cov.nnzb], cov.blocks[: cov.nnzb], gh, R)
    group_ptr = T.group_pointer(step_groups, n_groups)
    order, depth = T.lane_order(group_ptr, R, gh)
    statics = ("rowgroup", cov.n_block_rows, *bsr.shape,
               cov.n_block_cols * bsr.b, "exact", depth, (R, gh))
    return Plan([step_groups, slot_cols, blocks, group_ptr, order],
                T._pallas_apply, statics, device="cuda")


def _layout_plan(bsr, layout, precision=None) -> Plan:
    """The plan of `layout` in K3_LAYOUT_KERNELS: K3 with
    precision="high", else the layout's exact f32 kernel."""
    kw = K3_LAYOUT_KERNELS[layout][0]
    plan = (_f32_rowgroup_plan(bsr) if kw is None else
            T.bsr_spmm_pallas_plan(bsr, grad=False, precision=precision,
                                   device="cuda", **kw))
    assert plan.statics[0] == layout
    return plan


def _exact_runs(layout, want3, want_exact):
    """(precision, kernel, want) of each plan a layout runs on
    bf16x3_exact_case: K3 where the layout has it, then the exact kernel."""
    _, k3, exact = K3_LAYOUT_KERNELS[layout]
    return ((("high", k3, want3),) if k3 else ()) + ((None, exact, want_exact),)


def _run_counted(plan, x, name, k3):
    """plan(x), checking that it launched `name` once and nothing else
    but, for K3 (k3=True), the operand split once."""
    counts = {k.symbol: k.launches for k in _kernels.KERNELS}
    got = plan(x)
    torch.cuda.synchronize()
    counts["sdb_" + name] += 1
    if k3:
        counts["sdb_split_bf16"] += 1
    assert {k.symbol: k.launches for k in _kernels.KERNELS} == counts
    return got


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("b", [16, 32, 64, 128])
@pytest.mark.parametrize("layout", list(K3_LAYOUT_KERNELS))
def test_k3_kernel_is_bf16x3_not_exact_f32(layout, b, wide, monkeypatch):
    """bf16x3_exact_case makes every partial sum exact in f32, so the
    order of the kernel's sums cannot hide what it computes: each K3
    instance must give A_hi X_hi + A_hi X_lo + A_lo X_hi bit for bit, and
    the exact kernel on the same layout (K2, K1, K5) A X bit for bit. A
    K3 that kept lo*lo, lost a split or truncated instead of rounding to
    even would miss the first; the two answers differ in most entries.
    f32 K4 (row groups, no K3 instance) must give A X too. K3 runs on the
    tensor-core ring at b = 64 and 128 and on the small-block mma.sync
    loop at 16 and 32, the exact f32 kernels on the pipelined FFMA loop,
    at the card's tile widths and at the widest (F=200 is ragged); each
    K3 call splits the operand once."""
    _widest_tiles(monkeypatch, wide)
    bsr, x, want3, want_exact = bf16x3_exact_case(F=200, seed=b, b=b)
    x = torch.as_tensor(x, device="cuda")
    for precision, name, want in _exact_runs(layout, want3, want_exact):
        plan = _layout_plan(bsr, layout, precision)
        got = _run_counted(plan, x, name, precision == "high")
        np.testing.assert_array_equal(got.double().cpu().numpy(), want)


@pytest.mark.parametrize("layout", list(K3_LAYOUT_KERNELS))
@pytest.mark.parametrize("b", [16, 64, 128])
def test_k3_and_f32_k2_operand_at_odd_offset(b, layout):
    """An f32 operand that starts 4 bytes past a 16-byte boundary: the
    split kernel reads it as it is (its planes are a fresh buffer), the
    exact f32 kernels' pipelined loop (K1, K2, K4, K5) gets an aligned
    copy; every answer is still the exact case's, bit for bit."""
    bsr, x, want3, want_exact = bf16x3_exact_case(F=96, seed=b + 1, b=b)
    base = torch.empty(x.size + 1, device="cuda")
    view = base[1:].view(x.shape)
    view.copy_(torch.as_tensor(x))
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    for precision, name, want in _exact_runs(layout, want3, want_exact):
        plan = _layout_plan(bsr, layout, precision)
        got = _run_counted(plan, view, name, precision == "high")
        np.testing.assert_array_equal(got.double().cpu().numpy(), want)


def _deep_bsr(b=128, nb=6, depth=34, seed=0):
    """nb block-rows of `depth` random blocks each over 40 block-columns:
    rows of depth*b (4,352 at b=128, as ddi's) terms."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(nb), depth).astype(np.int32)
    cols = np.concatenate([np.sort(rng.choice(40, depth, replace=False))
                           for _ in range(nb)]).astype(np.int32)
    blocks = rng.standard_normal((rows.size, b, b)).astype(np.float32)
    return BSR.from_parts(rows, cols, blocks, (nb * b, 40 * b), b)


@pytest.mark.parametrize("precision,layout", [
    (precision, layout) for precision in ("high", None)
    for layout in K3_LAYOUT_KERNELS
    if precision is None or K3_LAYOUT_KERNELS[layout][1]])
def test_k3_and_f32_k2_deep_rows_match_plain(precision, layout):
    """Rows of 4,352 terms (34 blocks of 128, as ddi's): K3 on the ring
    (its two-level sums) and the exact f32 kernels (K1, K2, K4, K5 on the
    pipelined FFMA loop) within 1e-5 of their plain versions, and within
    1e-4 of float64."""
    bsr = _deep_bsr()
    _, k3, exact = K3_LAYOUT_KERNELS[layout]
    plan = _layout_plan(bsr, layout, precision)
    x = _x(bsr, F=256, seed=6)
    got = _run_counted(plan, x, k3 if precision else exact, precision == "high")
    want = T.plain_apply(plan, x)
    rel = (got - want).abs().max().item() / max(want.abs().max().item(), 1.0)
    assert rel < TOL, rel
    ref = bsr.to_dense().astype(np.float64) @ x.cpu().numpy().astype(np.float64)
    assert np.abs(got.cpu().numpy() - ref).max() / np.abs(ref).max() < 1e-4


def _sorting_bsr(nb, b, seed):
    """nb block-rows, rows 1 and 5 empty and the others holding 12 blocks
    of 16 block-columns (so the f32 plan sorts), ragged logical shape."""
    rng = np.random.default_rng(seed)
    live = [r for r in range(nb) if r not in (1, 5)]
    rows = np.repeat(live, 12).astype(np.int32)
    cols = np.concatenate([np.sort(rng.choice(16, 12, replace=False))
                           for _ in live]).astype(np.int32)
    blocks = rng.standard_normal((rows.size, b, b)).astype(np.float32)
    return BSR.from_parts(rows, cols, blocks, (nb * b - 3, 16 * b - 7), b)


@pytest.mark.parametrize("layout", list(K3_LAYOUT_KERNELS))
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("nb", [7, 37])
@pytest.mark.parametrize("F", [8, 70, 133, 256, 512])
@pytest.mark.parametrize("b", [16, 32, 64, 128])
def test_f32_k2_pipelined_loop_matches_plain(b, F, nb, wide, layout, monkeypatch):
    """The exact f32 kernels (the pipelined FFMA loop at every b: K2 on its
    sorted walk, K1 and K5 on the flat one, K4 on row groups) on random
    data within 1e-5 of their plain versions: ragged F (70 and 133 pad the
    operand to a multiple of 4), absent and phantom lanes (7 and 37
    block-rows at R = 16; 12 blocks in every other row, so the f32 plan
    sorts), tiles of the width the card's geometry picks and of the
    widest the F needs (at b = 16 and 32, 32 and 128 columns here)."""
    _widest_tiles(monkeypatch, wide)
    bsr = _sorting_bsr(nb, b, seed=b + nb)
    plan = _layout_plan(bsr, layout)
    _check(plan, _x(bsr, F=F, seed=F + 1),
           getattr(_kernels, K3_LAYOUT_KERNELS[layout][2]))


def _force_small_bn(monkeypatch, bn):
    """The exact-f32 entries at b = 16 and 32 launch at bn columns."""
    monkeypatch.setattr(T, "f32_small_geometry",
                        lambda b, F, n_sms, n_slots, depth: (bn, -(-F // 4) * 4))


@pytest.mark.parametrize("layout", list(K3_LAYOUT_KERNELS))
@pytest.mark.parametrize("bn", [32, 64, 128])
@pytest.mark.parametrize("F", [8, 70, 200])
@pytest.mark.parametrize("b", [16, 32])
def test_f32_small_instances_match_plain(b, F, bn, layout, monkeypatch):
    """Each small instance of the pipelined loop (b = 16 and 32, tiles of
    32, 64 and 128 columns: microtiles of 1 x 4 up to 4 x 8) on every
    walk, against the plain version within 1e-5, on 37 block-rows (absent
    and phantom lanes) and ragged F; and its answer equal bit for bit to
    the same kernel at 32 columns, whose sums run in the same order."""
    bsr = _sorting_bsr(37, b, seed=b + F)
    plan = _layout_plan(bsr, layout)
    x = _x(bsr, F=F, seed=F)
    kernel = getattr(_kernels, K3_LAYOUT_KERNELS[layout][2])
    _force_small_bn(monkeypatch, bn)
    got = _check(plan, x, kernel)
    _force_small_bn(monkeypatch, 32)
    assert torch.equal(got, plan(x))


def _f32_entry_args(plan, layout):
    """(the pointer arrays before blocks, the lane order last; the sizes
    before F; the sizes between ld and bn) of the entry an exact f32 plan
    launches."""
    b = plan.arrays[2].shape[1]
    if layout == "sorted":
        win_ids, slot_cols, _, pos, lane_valid, group_ptr, order = plan.arrays
        R, gh, W = plan.statics[-1]
        return ((group_ptr, win_ids, pos, lane_valid, slot_cols, order),
                (lane_valid.shape[0],), (R, gh, W, b))
    if layout == "rowgroup":
        _, slot_cols, _, group_ptr, order = plan.arrays
        R, gh = plan.statics[-1]
        return ((group_ptr, slot_cols, order),
                ((group_ptr.shape[0] - 1) * R, plan.statics[1]), (R, gh, b))
    _, slot_cols, _, step_ptr, order = plan.arrays  # flat and resident
    return (step_ptr, slot_cols, order), (plan.statics[1],), (plan.statics[-1], b)


@pytest.mark.parametrize("layout", list(K3_LAYOUT_KERNELS))
@pytest.mark.parametrize("b", [16, 32, 64])
def test_f32_k2_entry_refuses_bad_geometry(b, layout):
    """Each exact f32 entry (K2, K1, K5, K4) refuses a tile width it has
    no instance for (96 and 256 at every b, 32 at b = 64), an operand row
    length that is not a multiple of 4, or shorter than F, a misaligned
    operand, and at b = 16 and 32 a null lane order: the wrapper raises and
    no launch is counted."""
    bsr = _sorting_bsr(7, b, seed=3)
    plan = _layout_plan(bsr, layout)
    head, lanes, tail = _f32_entry_args(plan, layout)
    kernel = getattr(_kernels, K3_LAYOUT_KERNELS[layout][2])
    dense = torch.zeros(bsr.n_block_cols * b, 72, device="cuda")
    out = torch.empty(bsr.n_block_rows * b, 70, device="cuda")
    counts = [k.launches for k in _kernels.KERNELS]
    ptrs = [t.data_ptr() for t in (*head, plan.arrays[2])]
    stream = torch.cuda.current_stream().cuda_stream
    d = dense.data_ptr()
    # (operand, ld, bn, lane order)
    order = ptrs[-2]
    bad = [(d, 72, 96, order), (d, 72, 256, order), (d, 70, 64, order),
           (d, 68, 64, order), (d + 4, 72, 64, order)]
    bad += [(d, 72, 32, order)] if b == 64 else [(d, 72, 64, 0), (d, 72, 32, 0)]
    for ptr, ld, bn, lo in bad:
        ptrs[-2] = lo
        with pytest.raises(RuntimeError, match="cudaError_t"):
            kernel(*ptrs, ptr, out.data_ptr(), *lanes, 70, ld, *tail, bn, stream)
    assert [k.launches for k in _kernels.KERNELS] == counts


def _hub_bsr(b, hub, exact, seed=0):
    """40 block-rows over `hub` block-columns: block-row 21 holds a block
    in every column (hub blocks, a lane thousands of slots deep) and the
    others 2 to 6 (a few slots), block-row 3 none. exact=True: blocks and
    operand hold integers of magnitude <= 2, so every partial sum of an
    output is an integer under 2^24 and exact in f32 in any order; else
    standard-normal values. Returns (bsr, x (hub*b, 64) f32)."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for r in range(40):
        c = (np.arange(hub) if r == 21 else [] if r == 3 else
             np.sort(rng.choice(hub, size=int(rng.integers(2, 7)), replace=False)))
        rows += [r] * len(c)
        cols += list(c)
    shape = (len(rows), b, b)
    vals = (lambda sh: rng.integers(-2, 3, size=sh)) if exact else rng.standard_normal
    blocks = vals(shape).astype(np.float32)
    x = vals((hub * b, 64)).astype(np.float32)
    return BSR.from_parts(np.asarray(rows, np.int32), np.asarray(cols, np.int32),
                          blocks, (40 * b, hub * b), b), x


@pytest.mark.parametrize("layout", list(K3_LAYOUT_KERNELS))
@pytest.mark.parametrize("b", [16, 32])
def test_f32_small_hub_lane(b, layout):
    """One hub lane 2,000 blocks deep among lanes of a few blocks (the
    arxiv stand-in's shape under gorder, in small): the plan's lane order
    starts the deepest lane first, and the geometry gives it 32-column
    tiles on the card's SMs. On integer data every exact-f32 kernel
    equals float64 bit for bit; on standard-normal data it is within 1e-5
    of its plain version and within 1e-4 of float64."""
    hub, F = 2000, 64
    name = K3_LAYOUT_KERNELS[layout][2]
    for exact in (True, False):
        bsr, x_np = _hub_bsr(b, hub, exact, seed=b)
        plan = _layout_plan(bsr, layout)
        depth = plan.statics[6]
        assert depth >= hub
        assert T.f32_small_geometry(b, F, T._sm_count(0), plan.arrays[2].shape[0],
                                    depth)[0] == 32
        x = torch.as_tensor(x_np, device="cuda")
        ref = bsr.to_scipy().astype(np.float64) @ x_np.astype(np.float64)
        if exact:
            got = _run_counted(plan, x, name, False)
            np.testing.assert_array_equal(got.double().cpu().numpy(), ref)
        else:
            got = _check(plan, x, getattr(_kernels, name))
            assert np.abs(got.cpu().numpy() - ref).max() / np.abs(ref).max() < 1e-4


# the plans of the small-block tensor-core loop (b = 16 and 32): the bf16
# entries on each layout and K3 on each of its layouts, (plan kwargs,
# kernel)
MMA_CASES = {
    **{f"bf16 {layout}": ({"dtype": torch.bfloat16, **kw}, BF16_KERNELS[layout])
       for layout, kw in BF16_LAYOUT_KW.items()},
    **{f"k3 {layout}": ({"precision": "high", **kw}, k3)
       for layout, (kw, k3, _) in K3_LAYOUT_KERNELS.items() if k3},
}


def _mma_plan(bsr, case) -> Plan:
    kw, _ = MMA_CASES[case]
    plan = T.bsr_spmm_pallas_plan(bsr, grad=False, device="cuda", **kw)
    assert plan.statics[0] == case.split()[1]
    return plan


def _force_bf16_small_bn(monkeypatch, bn):
    """The bf16 and K3 entries at b = 16 and 32 launch at bn columns."""
    monkeypatch.setattr(T, "bf16_small_geometry",
                        lambda b, F, n_sms, n_slots, depth: (bn, -(-F // 8) * 8))


@pytest.mark.parametrize("case", list(MMA_CASES))
@pytest.mark.parametrize("bn", [32, 64, 128])
@pytest.mark.parametrize("F", [8, 70, 200])
@pytest.mark.parametrize("b", [16, 32])
def test_mma_small_instances_match_plain(b, F, bn, case, monkeypatch):
    """Each instance of the small-block tensor-core loop (b = 16 and 32,
    tiles of 32, 64 and 128 columns, one plane or K3's two) on every walk,
    against its plain version within 1e-5, on 37 block-rows (absent and
    phantom lanes) and ragged F; and its answer equal bit for bit to the
    same kernel at 32 columns: each output's sums run in the same order at
    every tile width."""
    bsr = _sorting_bsr(37, b, seed=b + F)
    plan = _mma_plan(bsr, case)
    x = _x(bsr, F=F, seed=F)
    kernel = getattr(_kernels, MMA_CASES[case][1])
    _force_bf16_small_bn(monkeypatch, bn)
    got = _check(plan, x, kernel)
    _force_bf16_small_bn(monkeypatch, 32)
    assert torch.equal(got, plan(x))


@pytest.mark.parametrize("case", ["bf16 sorted", "k3 sorted", "bf16 flat"])
@pytest.mark.parametrize("b", [16, 32])
def test_mma_small_hub_lane(b, case):
    """One hub lane 4,096 blocks deep among lanes of a few blocks, on the
    small-block tensor-core loop (bf16 K2 and K1, K3 on K2's layout),
    started first by the plan's lane order: on integer data the answer
    equals float64 bit for bit; on standard-normal data the two-level sums
    keep the hub's chain of 4,096 slots within 1e-5 of the plain version
    (and K3 within 1e-4 of float64)."""
    hub = 4096
    name = MMA_CASES[case][1]
    for exact in (True, False):
        bsr, x_np = _hub_bsr(b, hub, exact, seed=b)
        plan = _mma_plan(bsr, case)
        assert plan.statics[6] >= hub
        x = torch.as_tensor(x_np, device="cuda")
        ref = bsr.to_scipy().astype(np.float64) @ x_np.astype(np.float64)
        got = _check(plan, x, getattr(_kernels, name))
        if exact:
            np.testing.assert_array_equal(got.double().cpu().numpy(), ref)
        elif case.startswith("k3"):
            assert np.abs(got.cpu().numpy() - ref).max() / np.abs(ref).max() < 1e-4


def test_k3_wrappers_take_f32_only():
    """K3's wrappers take the plan's bf16 block planes and an f32 operand:
    a bf16 operand, or f32 blocks, raise before any launch, as does a
    resident operand that is not (nbc, b, F)."""
    bsr = _bsr(8, 16, 0.5, seed=5)
    plan = T.bsr_spmm_pallas_plan(bsr, grad=False, resident=True,
                                  precision="high", device="cuda")
    step_rows, slot_cols, planes, step_ptr, _ = plan.arrays
    assert planes.dtype == torch.bfloat16 and planes.dim() == 2
    x3 = torch.zeros(8, 16, 4, device="cuda", dtype=torch.bfloat16)
    counts = [k.launches for k in _kernels.KERNELS]
    with pytest.raises(TypeError, match="dtype"):
        T.spmm_resident(step_rows, step_ptr, slot_cols, planes, x3,
                        plan.statics[-1], bf16x3=True)
    with pytest.raises(TypeError, match="dtype"):
        T.spmm_resident(step_rows, step_ptr, slot_cols, planes.float(), x3.float(),
                        plan.statics[-1], bf16x3=True)
    with pytest.raises(ValueError, match="nbc, b, F"):
        T.spmm_resident(step_rows, step_ptr, slot_cols, planes,
                        x3.float().reshape(-1, 4), plan.statics[-1], bf16x3=True)
    assert [k.launches for k in _kernels.KERNELS] == counts


@pytest.mark.parametrize("shape", [(1, 1), (300, 70), (1024, 512)])
def test_split_kernel_matches_plain(shape):
    """K3's operand split on the card equals its plain version bit for
    bit (zero pad columns included), one launch a call; an operand at an
    odd offset too."""
    x = torch.as_tensor(np.random.default_rng(shape[1]).standard_normal(
        shape).astype(np.float32), device="cuda")
    base = torch.empty(x.numel() + 1, device="cuda")
    view = base[1:].view(shape)
    view.copy_(x)
    for operand in (x, view):
        before = _kernels.split_bf16.launches
        got = T.split_operand(operand)
        torch.cuda.synchronize()
        assert _kernels.split_bf16.launches == before + 1
        assert torch.equal(got, T.split_operand_plain(operand))


def _rect_bsr(b, depth=13, seed=0):
    """6 x 16 block grid, block-rows 1 and 4 and block-columns 4 and 11
    empty: A sorts (>= 8 real blocks per row), Aᵀ packs flat."""
    rng = np.random.default_rng(seed)
    live = np.setdiff1d(np.arange(16), [4, 11])
    rows = np.repeat([0, 2, 3, 5], depth)
    cols = np.concatenate([np.sort(rng.choice(live, depth, replace=False))
                           for _ in range(4)])
    blocks = rng.standard_normal((rows.size, b, b)).astype(np.float32)
    return BSR.from_parts(rows.astype(np.int32), cols.astype(np.int32), blocks,
                          (6 * b - 3, 16 * b - 3), b)


@pytest.mark.parametrize("b", [32, 128])
@pytest.mark.parametrize("kw,kernels", [
    ({}, ("bsr_spmm_sorted", "bsr_spmm_flat")),
    ({"precision": "high"}, ("bsr_spmm_sorted_bf16x3", "bsr_spmm_flat_bf16x3")),
    ({"resident": True}, ("bsr_spmm_sorted", "bsr_spmm_resident")),
])
def test_grad_plan_backward_on_card(b, kw, kernels):
    """A grad plan on the card: the forward launches A's kernel once and
    the backward Aᵀ's kernel once; the gradient matches the plain
    backward (plain_apply, both directions plain) within 1e-5."""
    bsr = _rect_bsr(b)
    plan = T.bsr_spmm_pallas_plan(bsr, device="cuda", **kw)
    fwd_k, bwd_k = (getattr(_kernels, n) for n in kernels)
    x0 = _x(bsr, F=70, seed=3)
    g = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (bsr.shape[0], 70)).astype(np.float32), device="cuda")
    counts = fwd_k.launches, bwd_k.launches
    x = x0.clone().requires_grad_(True)
    plan(x).backward(g)
    torch.cuda.synchronize()
    assert (fwd_k.launches, bwd_k.launches) == (counts[0] + 1, counts[1] + 1)
    xp = x0.clone().requires_grad_(True)
    T.plain_apply(plan, xp).backward(g)
    assert (fwd_k.launches, bwd_k.launches) == (counts[0] + 1, counts[1] + 1)
    rel = (x.grad - xp.grad).abs().max().item() / xp.grad.abs().max().item()
    assert rel < TOL, rel
    want = bsr.to_dense().T.astype(np.float64) @ g.cpu().numpy()
    assert np.abs(x.grad.cpu().numpy() - want).max() / np.abs(want).max() < 1e-4


# -- K9 (int8 single-row resident) and K10 (CSR) ----------------------------


@pytest.mark.parametrize("b", [16, 32, 64, 128])
@pytest.mark.parametrize("nb", [7, 37])
def test_k9_kernel_matches_plain(b, nb):
    """K9 (resident=True with an explicit f_tile) against its plain
    version on the same quantized operand, two empty rows, ragged F."""
    bsr = _bsr(nb, b, 0.3, seed=b + 3)
    plan = TI.bsr_spmm_pallas_int8_plan(bsr, resident=True, f_tile=128,
                                        device="cuda")
    assert plan.statics[0] == "resident"
    x = _x(bsr, seed=5)
    counts = _kernels.bsr_spmm_int8_flat.launches
    got = _check(plan, x, _kernels.bsr_spmm_int8_resident)
    assert _kernels.bsr_spmm_int8_flat.launches == counts
    want = spmm_scipy(bsr, x.cpu().numpy())
    assert np.abs(got.cpu().numpy() - want).max() / np.abs(want).max() < 6e-2


def test_k9_wrapper_refuses_bad_operands():
    bsr = _bsr(8, 16, 0.5, seed=6)
    plan = TI.bsr_spmm_pallas_int8_plan(bsr, resident=True, f_tile=128,
                                        device="cuda")
    step_rows, slot_cols, qblocks, scales, step_ptr = plan.arrays[:5]
    group = plan.statics[5][0]
    q, cs = TI.quantize_operand(plan, _x(bsr))
    q3 = q.reshape(-1, 16, q.shape[1])
    counts = [k.launches for k in _kernels.KERNELS]
    with pytest.raises(TypeError, match="dtype"):
        TI.spmm_int8_resident(step_rows, step_ptr, slot_cols, qblocks.float(),
                              scales, q3, cs, group)
    with pytest.raises(ValueError, match="nbc, b, F"):
        TI.spmm_int8_resident(step_rows, step_ptr, slot_cols, qblocks, scales,
                              q, cs, group)
    with pytest.raises(ValueError, match="device"):
        TI.spmm_int8_resident(step_rows, step_ptr, slot_cols, qblocks, scales,
                              q3.cpu(), cs, group)
    with pytest.raises(ValueError, match="contiguous"):
        TI.spmm_int8_resident(step_rows, step_ptr, slot_cols,
                              qblocks.transpose(1, 2), scales, q3, cs, group)
    with pytest.raises(ValueError, match="f_tile"):
        TI.bsr_spmm_pallas_int8_plan(bsr, resident=True, f_tile=96,
                                     device="cuda")(_x(bsr, F=70))
    assert [k.launches for k in _kernels.KERNELS] == counts


def _csr(n_rows=700, n_cols=500, p=0.03, seed=0):
    """Rows 0-9 (empty head rows) and 256-511 (an empty band at R=256)
    hold no nonzeros; the last band is ragged."""
    src = random_csr(p, n_rows, n_cols, seed=seed)
    rows = src.row_ids()
    keep = ~np.isin(rows, list(range(10)) + list(range(256, 512)))
    return CSR.from_coo(rows[keep], src.indices[keep], src.data[keep],
                        (n_rows, n_cols))


def _check_csr(plan, x):
    got = _check(plan, x, _kernels.csr_spmm)
    assert got.shape == (plan.statics[0], x.shape[1])
    return got


@pytest.mark.parametrize("F", [1, 7, 64, 256, 512])
def test_csr_kernel_matches_plain(F):
    """K10 against its plain version (1e-5) and the scipy oracle (1e-4):
    F = 1 and 7 take the scalar path, 64 to 512 the float4 path (one and
    two F tiles); empty rows store zeros."""
    csr = _csr(seed=F)
    plan = TP.csr_spmm_pallas_plan(csr, grad=False, device="cuda")
    x = torch.as_tensor(np.random.default_rng(F).standard_normal(
        (csr.n_cols, F)).astype(np.float32), device="cuda")
    got = _check_csr(plan, x)
    assert not got[:10].any() and not got[256:512].any()
    assert_allclose(got, spmm_scipy(csr, x.cpu().numpy()))


@pytest.mark.parametrize("shape", [(10, 12), (0, 12), (12, 0)])
def test_csr_kernel_empty_matrix(shape):
    """No nonzeros: zeros of the right shape (none for 0 rows), the
    dummies of the empty bands never read (X may have no rows)."""
    csr = CSR.from_coo([], [], None, shape)
    plan = TP.csr_spmm_pallas_plan(csr, grad=False, device="cuda")
    x = torch.ones(shape[1], 5, device="cuda")
    before = _kernels.csr_spmm.launches
    got = plan(x)
    torch.cuda.synchronize()
    assert _kernels.csr_spmm.launches == before + 1
    assert got.shape == (shape[0], 5) and not got.any()
    assert torch.equal(got, T.plain_apply(plan, x))


def test_csr_wrapper_refuses_bad_operands():
    csr = _csr(300, 200)
    plan = TP.csr_spmm_pallas_plan(csr, grad=False, device="cuda")
    args = plan.arrays
    R, n_partials = plan.statics[2], plan.statics[4]
    x = torch.ones(200, 16, device="cuda")
    counts = [k.launches for k in _kernels.KERNELS]
    with pytest.raises(TypeError, match="dtype"):
        TP.spmm_csr_segment(*args, x.double(), R, n_partials)
    with pytest.raises(TypeError, match="dtype"):
        TP.spmm_csr_segment(args[0].long(), *args[1:], x, R, n_partials)
    with pytest.raises(TypeError, match="dtype"):
        TP.spmm_csr_segment(*args[:5], args[5].int(), *args[6:], x, R, n_partials)
    with pytest.raises(ValueError, match="device"):
        TP.spmm_csr_segment(*args, x.cpu(), R, n_partials)
    with pytest.raises(ValueError, match="contiguous"):
        TP.spmm_csr_segment(*args, torch.ones(16, 200, device="cuda").T, R,
                            n_partials)
    assert [k.launches for k in _kernels.KERNELS] == counts


@pytest.mark.parametrize("F", [7, 256, 600])
def test_csr_kernel_split_rows(F):
    """Rows longer than SEGMENT_NNZ (512) split into segments whose
    partial rows a second pass adds: rows of 5,000 (duplicate columns),
    1,025 and 513 nonzeros among short rows; against the plain version
    (1e-5) and scipy (1e-4)."""
    rng = np.random.default_rng(F)
    deg = rng.integers(0, 20, size=300)
    deg[[3, 10, 299]] = (5000, 1025, 513)
    rows = np.repeat(np.arange(300), deg)
    csr = CSR.from_coo(rows, rng.integers(0, 400, size=rows.size),
                       rng.standard_normal(rows.size), (300, 400))
    plan = TP.csr_spmm_pallas_plan(csr, grad=False, device="cuda")
    assert plan.arrays[8].tolist() == [3, 10, 299]  # split_row
    x = torch.as_tensor(rng.standard_normal((400, F)).astype(np.float32),
                        device="cuda")
    got = _check_csr(plan, x)
    assert_allclose(got, spmm_scipy(csr, x.cpu().numpy()))


def _strip_csr(F):
    """2,000 rows over 2^16 columns: rows 0-9 and 700-899 empty, rows 13,
    1500 and 1999 of 3,000, 1,025 and 513 nonzeros (split into segments;
    duplicate columns kept), the rest 0 to 40."""
    rng = np.random.default_rng(F)
    deg = rng.integers(0, 41, size=2000)
    deg[list(range(10)) + list(range(700, 900))] = 0
    deg[[13, 1500, 1999]] = (3000, 1025, 513)
    rows = np.repeat(np.arange(2000), deg)
    return CSR.from_coo(rows, rng.integers(0, 1 << 16, size=rows.size),
                        rng.standard_normal(rows.size), (2000, 1 << 16))


@pytest.mark.parametrize("F", [203, 300])
def test_csr_kernel_column_strips(F, monkeypatch):
    """K10 over X of 2^16 rows, where csr_strip_width cuts F into several
    strips on the card's L2 (128 columns on an H100): ragged F (203 takes
    the scalar path, 300 the float4 path with a last strip of 44), split
    rows and empty rows, within 1e-5 of the plain version and 1e-4 of
    scipy. Every strip width sums each output's terms in the same order,
    so strips of 32, 64 and 96 columns and one strip of all of F give the
    same answer bit for bit."""
    csr = _strip_csr(F)
    K = csr.n_cols
    assert 1 < -(-F // TP.csr_strip_width(K, F, TP._l2_bytes(0)))
    plan = TP.csr_spmm_pallas_plan(csr, grad=False, device="cuda")
    assert plan.arrays[8].tolist() == [13, 1500, 1999]  # split_row
    x = torch.as_tensor(np.random.default_rng(F).standard_normal(
        (K, F)).astype(np.float32), device="cuda")
    got = _check_csr(plan, x)
    assert not got[:10].any() and not got[700:900].any()
    assert_allclose(got, spmm_scipy(csr, x.cpu().numpy()))
    for W in (32, 64, 96, F):
        monkeypatch.setattr(TP, "csr_strip_width", lambda K, F, l2, itemsize=4, W=W: W)
        assert torch.equal(_check_csr(plan, x), got), W


def _int_values(csr: CSR, seed: int) -> CSR:
    """csr with integer values of magnitude <= 16."""
    vals = np.random.default_rng(seed).integers(-16, 17, size=csr.nnz)
    return CSR(csr.indptr, csr.indices, vals.astype(np.float32), csr.shape)


def _short_row_csr(seed=0):
    """12,000 rows of 0 to 16 nonzeros (about 8, as arxiv's) over 12,000
    columns, rows 0-9 and 5000-5299 empty, rows 40 and 9000 of 1,500 and
    600 nonzeros (split into segments; duplicate columns kept)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 17, size=12000)
    deg[list(range(10)) + list(range(5000, 5300))] = 0
    deg[[40, 9000]] = (1500, 600)
    rows = np.repeat(np.arange(12000), deg)
    return CSR.from_coo(rows, rng.integers(0, 12000, size=rows.size),
                        rng.standard_normal(rows.size), (12000, 12000))


def _offset(x, elements):
    """x's values in a bf16 tensor whose data starts `elements` past a
    fresh allocation's (an odd offset takes the kernel's 2-byte loads, 4
    its 8-byte loads): .to(torch.bfloat16) hands such a tensor on as it
    is."""
    buf = torch.empty(x.numel() + elements, dtype=torch.bfloat16, device=x.device)
    view = buf[elements:].view(x.shape)
    view.copy_(x)
    return view


def _bf16_case(csr, F, seed, monkeypatch, widths=(), x_of=lambda x: x):
    """K10's one-bf16-pass kernel on csr at width F: on integer values
    and operand it equals float64 bit for bit; on normal data it lies
    within 1e-5 of its plain version and 3e-2 of float64; strips of each
    of `widths` columns give the same bits; the f32 entry never runs.
    x_of places the operand (an offset view)."""
    rng = np.random.default_rng(seed)
    f32_before = _kernels.csr_spmm.launches
    ints = _int_values(csr, seed)
    plan = TP.csr_spmm_pallas_plan(ints, precision="default", grad=False, device="cuda")
    assert plan.arrays[2].dtype == torch.bfloat16
    xi = rng.integers(-16, 17, size=(csr.n_cols, F)).astype(np.float32)
    got_i = _check(plan, x_of(torch.as_tensor(xi, device="cuda")), _kernels.csr_spmm_bf16)
    want = ints.to_scipy().astype(np.float64) @ xi.astype(np.float64)
    assert np.array_equal(got_i.cpu().numpy(), want.astype(np.float32))
    plan = TP.csr_spmm_pallas_plan(csr, precision="default", grad=False, device="cuda")
    x = x_of(torch.as_tensor(rng.standard_normal((csr.n_cols, F)).astype(np.float32),
                             device="cuda"))
    got = _check(plan, x, _kernels.csr_spmm_bf16)
    want = csr.to_scipy().astype(np.float64) @ x.float().cpu().numpy().astype(np.float64)
    # the bf16 gate of tests/test_conformance.py: max |err| / max |ref|
    assert np.abs(got.cpu().numpy() - want).max() / np.abs(want).max() < 3e-2
    for W in widths:
        with monkeypatch.context() as m:
            m.setattr(TP, "csr_bf16_strip_width", lambda K, F, l2, W=W: W)
            assert torch.equal(_check(plan, x, _kernels.csr_spmm_bf16), got), W
    assert _kernels.csr_spmm.launches == f32_before
    return got


@pytest.mark.parametrize("F", [7, 64, 128, 256, 300, 512])
def test_csr_bf16_kernel(F, monkeypatch):
    """K10's one-bf16-pass kernel (precision="default",
    sdb_csr_spmm_bf16): F = 7 its 2-byte loads, 300 its 8-byte loads (F %
    8 == 4), the rest its 16-byte loads; F <= 256 one strip of the rows
    of _csr (empty head rows and an empty band), 300 and 512 two strips of
    the bf16 rule (152 + 148, 256 + 256) over X of 2^16 rows with rows
    split into segments and empty rows. Every case as _bf16_case holds
    it, the same bits at strips of 8, 24, 64, 128, 152 and 256 columns
    (those narrower than F; 8 and 24 four lanes a segment, 152 a warp
    with lanes past the strip) and at one strip where F <= 256."""
    csr = _strip_csr(F) if F >= 300 else _csr(seed=F)
    if F >= 300:
        assert -(-F // TP.csr_bf16_strip_width(csr.n_cols, F, TP._l2_bytes(0))) == 2
    widths = [W for W in (8, 24, 64, 128, 152, 256) if W < F]
    got = _bf16_case(csr, F, F, monkeypatch,
                     widths + ([F] if F <= TP.CSR_BF16_MAX_STRIP else []))
    if F < 300:
        assert not got[:10].any() and not got[256:512].any()
    else:
        assert not got[:10].any() and not got[700:900].any()


@pytest.mark.parametrize("offset", [0, 1, 4])
def test_csr_bf16_kernel_short_rows(offset, monkeypatch):
    """The serve graph's case at a small size: rows of about 8 nonzeros
    at F = 128 with the L2 made small enough for the bf16 rule to cut two
    strips of 64 (four segments a warp), split rows and empty rows, the
    bf16 operand 16-byte aligned (offset 0), at an odd offset (2-byte
    loads) and 8 bytes off (8-byte loads): as _bf16_case holds it, at
    strips of 8, 64 and 128 columns too, and every placement gives the
    aligned operand's bits."""
    csr = _short_row_csr()
    l2 = int(2 * csr.n_cols * 100 / TP.CSR_BF16_L2_SHARE)  # 100 columns fit
    monkeypatch.setattr(TP, "_l2_bytes", lambda index: l2)
    assert TP.csr_bf16_strip_width(csr.n_cols, 128, l2) == 64
    plan = TP.csr_spmm_pallas_plan(csr, precision="default", grad=False, device="cuda")
    assert plan.arrays[8].tolist() == [40, 9000]  # split_row
    got = _bf16_case(csr, 128, 21, monkeypatch, (8, 64, 128),
                     lambda x: _offset(x.to(torch.bfloat16), offset))
    assert not got[:10].any() and not got[5000:5300].any()
    aligned = _bf16_case(csr, 128, 21, monkeypatch)
    assert torch.equal(got, aligned)


def test_csr_bf16_entry_refuses_a_strip_width():
    """A strip width narrower than F that is not a positive multiple of 8,
    or a strip wider than 256 columns (one strip of F = 300, or W = 264),
    has no kernel: the entry returns its cudaError_t, the wrapper raises,
    and no launch is counted."""
    csr = _csr(300, 200)
    plan = TP.csr_spmm_pallas_plan(csr, precision="default", grad=False, device="cuda")
    seg = plan.arrays[5:]
    x = torch.ones(200, 300, dtype=torch.bfloat16, device="cuda")
    out = torch.empty(300, 300, device="cuda")
    partial = torch.empty(max(plan.statics[4], 1), 300, device="cuda")
    counts = [k.launches for k in _kernels.KERNELS]
    for W in (0, -8, 12, 99, 264, 300, 1000):
        with pytest.raises(RuntimeError, match="cudaError_t"):
            _kernels.csr_spmm_bf16(
                *(t.data_ptr() for t in (*seg[:3], plan.arrays[0], plan.arrays[2],
                                         x, out, partial, *seg[3:])),
                seg[0].shape[0], seg[3].shape[0], 300, W,
                torch.cuda.current_stream().cuda_stream)
    assert [k.launches for k in _kernels.KERNELS] == counts


def test_csr_entry_refuses_a_strip_width():
    """A strip width narrower than F that is not a positive multiple of
    32 has no kernel: the entry returns its cudaError_t, the wrapper
    raises, and no launch is counted."""
    csr = _csr(300, 200)
    plan = TP.csr_spmm_pallas_plan(csr, grad=False, device="cuda")
    seg = plan.arrays[5:]
    x = torch.ones(200, 100, device="cuda")
    out = torch.empty(300, 100, device="cuda")
    partial = torch.empty(max(plan.statics[4], 1), 100, device="cuda")
    counts = [k.launches for k in _kernels.KERNELS]
    for W in (0, -32, 48, 99):
        with pytest.raises(RuntimeError, match="cudaError_t"):
            _kernels.csr_spmm(
                *(t.data_ptr() for t in (*seg[:3], plan.arrays[0], plan.arrays[2],
                                         x, out, partial, *seg[3:])),
                seg[0].shape[0], seg[3].shape[0], 100, W,
                torch.cuda.current_stream().cuda_stream)
    assert [k.launches for k in _kernels.KERNELS] == counts


def test_csr_grad_plan_backward_on_card():
    """The csr_pallas grad plan on a rectangular matrix: the forward
    launches K10 once on A and the backward once on Aᵀ; the gradient
    matches the plain backward within 1e-5 and the dense oracle within
    1e-4."""
    csr = random_csr(0.08, 200, 150, seed=11)
    plan = TP.csr_spmm_pallas_plan(csr, chunk=128, row_band=64, device="cuda")
    x0 = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (150, 40)).astype(np.float32), device="cuda")
    g = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (200, 40)).astype(np.float32), device="cuda")
    before = _kernels.csr_spmm.launches
    x = x0.clone().requires_grad_(True)
    plan(x).backward(g)
    torch.cuda.synchronize()
    assert _kernels.csr_spmm.launches == before + 2
    xp = x0.clone().requires_grad_(True)
    T.plain_apply(plan, xp).backward(g)
    assert _kernels.csr_spmm.launches == before + 2
    rel = (x.grad - xp.grad).abs().max().item() / xp.grad.abs().max().item()
    assert rel < TOL, rel
    assert_allclose(x.grad, csr.to_dense().T @ g.cpu().numpy())


def test_csr_xla_and_bcoo_on_card():
    """The compiler-built CSR tiers on the card agree with K10 (1e-4);
    neither launches a kernel of the port."""
    from spmm_denseblock_tpu_torch.ops import spmm_plan

    csr = _csr(400, 300, seed=7)
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (300, 33)).astype(np.float32), device="cuda")
    want = _check_csr(TP.csr_spmm_pallas_plan(csr, grad=False, device="cuda"), x)
    counts = [k.launches for k in _kernels.KERNELS]
    for impl in ("csr_xla", "bcoo"):
        assert_allclose(spmm_plan(csr, impl=impl)(x), want.cpu().numpy())
    assert [k.launches for k in _kernels.KERNELS] == counts


# -- the ELL, hybrid and windowed tiers (torch ops around the kernels) -------


def _dense_block_graph(seed=12):
    """16 block-rows of 32: in each, ~10 of 16 full 32 x 32 blocks (>= 8
    real blocks a block-row on average, so the dense part's plans sort:
    K2, K7) and a sparse tail over the whole matrix."""
    from spmm_denseblock_tpu_torch.convert.csr2bsr import bsr_to_csr

    dense = bsr_to_csr(random_bsr(1.0, 16, 16, block_size=32, seed=seed))
    tail = random_csr(0.01, 512, seed=seed + 1)
    rows = np.concatenate([dense.row_ids(), tail.row_ids()])
    cols = np.concatenate([dense.indices, tail.indices])
    vals = np.concatenate([dense.values(), tail.values()])
    return CSR.from_coo(rows, cols, vals, (512, 512))


def _ell_case(case):
    """(matrix, planner, kwargs) of one ELL-tier case."""
    E = importlib.import_module("spmm_denseblock_tpu_torch.ops.csr_spmm_ell")

    valued = random_csr(0.03, 700, 500, seed=21)
    pattern = random_csr(0.03, 700, 500, seed=21, values="ones")
    # 5,000 rows of 4 nonzeros: one class past _SCAN_MIN_M = 4,096 rows
    rng = np.random.default_rng(22)
    scan_csr = CSR.from_coo(np.repeat(np.arange(5000), 4), rng.integers(0, 500, 20000),
                            rng.random(20000, dtype=np.float32), (5000, 500))
    return {
        "f32": (valued, E.csr_spmm_ell_plan, {"grad": False}),
        "bf16": (valued, E.csr_spmm_ell_plan, {"grad": False, "dtype": torch.bfloat16}),
        "pattern": (pattern, E.csr_spmm_ell_plan, {"grad": False}),
        "scan": (scan_csr, E.csr_spmm_ell_plan, {"grad": False, "reduce": "scan"}),
        "compact": (valued, E.csr_spmm_ell_plan,
                    {"grad": False, "compact": "force", "compact_slots": 512}),
        "banded": (valued, E.csr_spmm_ell_banded_plan, {"grad": False, "band_rows": 128}),
        "int8 pattern": (pattern, E.csr_spmm_ell_int8_plan, {}),
        "int8 valued": (valued, E.csr_spmm_ell_int8_plan, {}),
        "int8 calibrated": (valued, E.csr_spmm_ell_int8_plan,
                            {"calibration": np.random.default_rng(5).standard_normal(
                                (500, 40)).astype(np.float32)}),
    }[case]


@pytest.mark.parametrize("case", ["f32", "bf16", "pattern", "scan", "compact",
                                  "banded", "int8 pattern", "int8 valued",
                                  "int8 calibrated"])
def test_ell_plans_on_card_match_cpu(case):
    """Each ELL plan on the card against the same plan on the CPU: int8
    pattern-only bit for bit (int32 sums, the quantization kernel
    bit-equal to its plain version), the rest within 1e-5 (the order of
    the f32 sums); the f32 csr_ell plans run the ELL kernel, the int8
    plans quantize with quantize_int8, each one launch a call, and no
    other kernel of the port runs (bf16 and banded: torch ops). The work
    figure positions: the f32 plans' the nnz stored entries the kernel
    walks, the bf16 plan's the CPU plan's slots, pads included."""
    csr, planner, kw = _ell_case(case)
    x_np = np.random.default_rng(6).standard_normal((csr.n_cols, 40)).astype(np.float32)
    cpu_plan = planner(csr, device="cpu", **kw)
    want = cpu_plan(x_np)
    plan = planner(csr, device="cuda", **kw)
    counts = [k.launches for k in _kernels.KERNELS]
    got = plan(torch.as_tensor(x_np, device="cuda"))
    torch.cuda.synchronize()
    int8 = case.startswith("int8")
    f32 = case in ("f32", "pattern", "scan", "compact")  # the f32 csr_ell kernel
    launched = [k.launches - c for k, c in zip(_kernels.KERNELS, counts)]
    assert launched == [int(int8 and k is _kernels.quantize_int8
                            or f32 and k is _kernels.ell_spmm) for k in _kernels.KERNELS]
    if f32 or case == "bf16":
        assert plan.positions == (csr.nnz if f32 else cpu_plan.positions)
    if case in ("f32", "bf16"):  # ragged rows: the CPU walks pads too
        assert cpu_plan.positions > csr.nnz
    assert got.shape == want.shape and got.dtype == torch.float32
    if case == "int8 pattern":
        assert torch.equal(got.cpu(), want)
    else:
        rel = (got.cpu() - want).abs().max().item() / want.abs().max().item()
        assert rel < TOL, rel


def _ell_kernel_csr(valued: bool, n_rows=3000, n_cols=2500, seed=30) -> CSR:
    """Rows of 0 to 12 nonzeros, a fifth of them of one (the K = 1 class,
    beside the empty rows' pad slots), rows 0-9 empty, row 17 a hub of
    1,500 nonzeros and the last row 513 (past SEGMENT_NNZ: split into
    segments; duplicate columns kept); seeded values or none."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 13, n_rows)
    deg[rng.random(n_rows) < 0.2] = 1
    deg[:10] = 0
    deg[[17, n_rows - 1]] = (1500, 513)
    rows = np.repeat(np.arange(n_rows), deg)
    vals = rng.standard_normal(rows.size).astype(np.float32) if valued else None
    return CSR.from_coo(rows, rng.integers(0, n_cols, rows.size), vals, (n_rows, n_cols))


def _ell_kernel_check(plan, csr, x):
    """The f32 ELL plan on the card: one launch of its kernel, within 1e-5
    of its plain version (_check) and of a float64 product."""
    got = _check(plan, x, _kernels.ell_spmm)
    want = csr.to_scipy().astype(np.float64) @ x.cpu().numpy().astype(np.float64)
    assert np.abs(got.cpu().numpy() - want).max() / max(np.abs(want).max(), 1.0) < TOL
    return got


@pytest.mark.parametrize("F", [40, 128, 256, 300])
@pytest.mark.parametrize("compact", ["off", "force"])
@pytest.mark.parametrize("valued", [True, False])
def test_ell_kernel_matches_plain(valued, compact, F):
    """The f32 csr_ell plan's kernel (sdb_ell_spmm) on valued (pads at row
    0) and pattern-only (pads at the zero row, never appended on the card)
    layouts, plain and compacted chunks (resolved at build), K = 1
    classes, empty rows and split rows: within 1e-5 of its plain version
    and of float64; the empty rows store zeros."""
    E = importlib.import_module("spmm_denseblock_tpu_torch.ops.csr_spmm_ell")
    csr = _ell_kernel_csr(valued)
    plan = E.csr_spmm_ell_plan(csr, grad=False, compact=compact, compact_slots=512,
                               device="cuda")
    assert plan.statics[2] == valued and plan.statics[4] > 0  # partial rows
    assert 1 in {K for _, K, *_ in plan.statics[1]}
    x = torch.as_tensor(np.random.default_rng(F).standard_normal(
        (csr.n_cols, F)).astype(np.float32), device="cuda")
    got = _ell_kernel_check(plan, csr, x)
    assert not got[:10].any()


@pytest.mark.parametrize("F,W", [(128, 64), (300, 100), (303, 104)])
@pytest.mark.parametrize("valued", [True, False])
def test_ell_kernel_column_strips(valued, F, W, monkeypatch):
    """X in equal strips of ell_strip_width's width: at F = 128 with the
    card's L2 made small enough that 70 columns of X fill its share (two
    strips of 64, as on arxiv), and past the kernel's widest strip of 128
    columns (300: three strips of 100 on 16-byte loads; 303: of 104 and a
    last of 95 on 4-byte loads); within 1e-5 of plain and float64. Every
    strip width (4, 32, 64, 100 and 128 columns: 1 to 32 lanes a segment)
    sums each output's terms in the same order, so all give the same
    bits; a strip of 132 columns, narrower than F, is refused."""
    E = importlib.import_module("spmm_denseblock_tpu_torch.ops.csr_spmm_ell")
    csr = _ell_kernel_csr(valued, seed=31)
    if F == 128:
        l2 = int(4 * csr.n_cols * 70 / E.ELL_L2_SHARE)
        monkeypatch.setattr(E, "_l2_bytes", lambda index: l2)
    assert E.ell_strip_width(csr.n_cols, F, E._l2_bytes(0)) == W
    plan = E.csr_spmm_ell_plan(csr, grad=False, device="cuda")
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (csr.n_cols, F)).astype(np.float32), device="cuda")
    got = _ell_kernel_check(plan, csr, x)
    for W in (4, 32, 64, 100, 128):
        monkeypatch.setattr(E, "ell_strip_width", lambda K, F, l2, W=W: W)
        assert torch.equal(_check(plan, x, _kernels.ell_spmm), got), W
    if F > E.ELL_MAX_STRIP:
        monkeypatch.setattr(E, "ell_strip_width", lambda K, F, l2: 132)
        with pytest.raises(RuntimeError, match="sdb_ell_spmm"):
            plan(x)


@pytest.mark.parametrize("shape", [(10, 12), (0, 12), (12, 0)])
def test_ell_kernel_empty_matrix(shape):
    """No nonzeros (every row one pad slot, never read) or no rows (an
    empty layout): zeros of the right shape through the kernel's one
    launch, equal to the plain version's."""
    E = importlib.import_module("spmm_denseblock_tpu_torch.ops.csr_spmm_ell")
    plan = E.csr_spmm_ell_plan(CSR.from_coo([], [], None, shape), grad=False,
                               device="cuda")
    x = torch.ones(shape[1], 5, device="cuda")
    before = _kernels.ell_spmm.launches
    got = plan(x)
    torch.cuda.synchronize()
    assert _kernels.ell_spmm.launches == before + 1
    assert got.shape == (shape[0], 5) and not got.any()
    assert torch.equal(got, T.plain_apply(plan, x))


def test_ell_wrapper_refuses_bad_operands():
    E = importlib.import_module("spmm_denseblock_tpu_torch.ops.csr_spmm_ell")
    csr = _ell_kernel_csr(True, 300, 200)
    plan = E.csr_spmm_ell_plan(csr, grad=False, device="cuda")
    positions, cols, vals, *seg = plan.arrays
    n_rows, n_partials = csr.n_rows, plan.statics[4]
    x = torch.ones(200, 16, device="cuda")
    counts = [k.launches for k in _kernels.KERNELS]
    with pytest.raises(TypeError, match="dtype"):
        E.spmm_ell(cols, vals, *seg, x.double(), n_rows, n_partials)
    with pytest.raises(TypeError, match="dtype"):
        E.spmm_ell(cols.long(), vals, *seg, x, n_rows, n_partials)
    with pytest.raises(TypeError, match="dtype"):
        E.spmm_ell(cols, vals, seg[0].int(), *seg[1:], x, n_rows, n_partials)
    with pytest.raises(ValueError, match="device"):
        E.spmm_ell(cols, vals, *seg, x.cpu(), n_rows, n_partials)
    with pytest.raises(ValueError, match="CUDA tensors"):
        E.spmm_ell(cols.cpu(), vals.cpu(), *(t.cpu() for t in seg), x.cpu(), n_rows,
                   n_partials)
    with pytest.raises(ValueError, match="contiguous"):
        E.spmm_ell(cols, vals, *seg, torch.ones(16, 200, device="cuda").T, n_rows,
                   n_partials)
    with pytest.raises(ValueError, match="same slots"):
        E.spmm_ell(cols, vals[1:], *seg, x, n_rows, n_partials)
    assert [k.launches for k in _kernels.KERNELS] == counts


@pytest.mark.parametrize("valued", [True, False])
def test_ell_grad_plan_backward_on_card(valued):
    """A csr_ell grad plan on the card: the forward launches the ELL
    kernel once on A's layout and the backward once on Aᵀ's; the gradient
    matches the plain backward within 1e-5 and float64 Aᵀ g within 1e-5."""
    E = importlib.import_module("spmm_denseblock_tpu_torch.ops.csr_spmm_ell")
    csr = _ell_kernel_csr(valued, 2000, 2600, seed=32)
    plan = E.csr_spmm_ell_plan(csr, device="cuda")
    rng = np.random.default_rng(5)
    x0 = torch.as_tensor(rng.standard_normal((csr.n_cols, 72)).astype(np.float32),
                         device="cuda")
    g = torch.as_tensor(rng.standard_normal((csr.n_rows, 72)).astype(np.float32),
                        device="cuda")
    before = _kernels.ell_spmm.launches
    x = x0.clone().requires_grad_(True)
    plan(x).backward(g)
    torch.cuda.synchronize()
    assert _kernels.ell_spmm.launches == before + 2
    xp = x0.clone().requires_grad_(True)
    T.plain_apply(plan, xp).backward(g)
    assert _kernels.ell_spmm.launches == before + 2
    rel = (x.grad - xp.grad).abs().max().item() / xp.grad.abs().max().item()
    assert rel < TOL, rel
    want = csr.to_scipy().T.astype(np.float64) @ g.cpu().numpy().astype(np.float64)
    assert np.abs(x.grad.cpu().numpy() - want).max() / np.abs(want).max() < TOL


def test_ell_kernel_engaged_on_an_arxiv_size_hybrid():
    """spmm_plan(impl="hybrid") on a graph of ogbn-arxiv's 169,343 nodes
    (~8 nonzeros a row and 24 dense 128-blocks on the diagonal), F = 128:
    the remainder runs the ELL kernel, one launch a call, and with program
    tracing on the leaf counts it on sdb.kernel/csr_ell and the remainder's
    stored entries, the slots the kernel walks, on sdb.positions/csr_ell;
    the answer within 1e-5 of the plan's plain version."""
    from spmm_denseblock_tpu_torch.ops import spmm_plan
    from spmm_denseblock_tpu_torch.utils import profiling

    n = 169_343
    tail = random_csr(8 / n, n, seed=33)
    blk = np.arange(24 * 128)
    rows = np.concatenate([tail.row_ids(), np.repeat(blk, 128)])
    cols = np.concatenate([tail.indices, (blk[:, None] // 128 * 128
                                          + np.arange(128)).reshape(-1)])
    vals = np.random.default_rng(34).random(rows.size).astype(np.float32)
    csr = CSR.from_coo(rows, cols, vals, (n, n))
    plan = spmm_plan(csr, impl="hybrid", block_size=128, density_threshold=0.5,
                     grad=False)
    assert plan.subplans is not None and len(plan.subplans) == 2
    assert plan.subplans[1].name == "csr_ell"
    x = torch.as_tensor(np.random.default_rng(35).standard_normal(
        (n, 128)).astype(np.float32), device="cuda")
    before = _kernels.ell_spmm.launches
    prev = profiling.enable(True)
    try:
        profiling.take()
        got = plan(x)
        torch.cuda.synchronize()
        counts = profiling.take()["counts"]
    finally:
        profiling.enable(prev)
    assert _kernels.ell_spmm.launches == before + 1
    assert counts["sdb.kernel/csr_ell"] == 1
    assert counts["sdb.positions/csr_ell"] == counts["sdb.nnz/csr_ell"]
    assert counts["sdb.nnz/csr_ell"] == plan.subplans[1].nnz > 0
    want = T.plain_apply(plan, x)
    rel = (got - want).abs().max().item() / want.abs().max().item()
    assert rel < TOL, rel


def _planted(n, fill, block_rows, seed) -> CSR:
    """n nodes: a random tail of ~8 nonzeros a row plus diagonal 128-blocks
    at block_rows, each holding `fill` of its 16,384 entries."""
    rng = np.random.default_rng(seed)
    tail = random_csr(8 / n, n, seed=seed)
    k = int(fill * 128 * 128)
    pos = np.stack([rng.choice(128 * 128, k, replace=False) for _ in block_rows])
    br = np.asarray(block_rows, np.int64)[:, None] * 128
    rows = np.concatenate([tail.row_ids(), (br + pos // 128).ravel()])
    cols = np.concatenate([tail.indices, (br + pos % 128).ravel()])
    return CSR.from_coo(rows, cols, rng.random(rows.size).astype(np.float32), (n, n))


@pytest.mark.parametrize("case", ["arxiv_size", "full_blocks"])
def test_auto_prices_by_the_kernels(case):
    """spmm_plan(impl="auto", grad=True) on the card prices the scorer's
    candidates by the f32 kernels (sdb.route: pricing "kernel"). On a
    stand-in of ogbn-arxiv's 169,343 nodes whose 700 dense 128-blocks are
    10% full it routes to csr_ell: every forward and backward call runs
    the ELL kernel (sdb.kernel/csr_ell), and the answers and Aᵀ gradients
    lie within 1e-5 of the plan's plain version. On full diagonal blocks,
    one a block-row (over a budget that sends it to the scorer), it still
    builds a hybrid."""
    from spmm_denseblock_tpu_torch.ops import spmm_plan
    from spmm_denseblock_tpu_torch.utils import profiling

    if case == "arxiv_size":
        n = 169_343
        rows = np.random.default_rng(36).choice(n // 128, 700, replace=False)
        csr, kw, want = _planted(n, 0.10, rows, 37), {}, "csr_ell"
    else:
        n = 48 * 128
        csr, kw, want = _planted(n, 1.0, range(48), 38), {"bsr_bytes_budget": 1 << 26}, "hybrid"
    prev = profiling.enable(True)
    try:
        profiling.take()
        plan = spmm_plan(csr, impl="auto", feat_dim=128, grad=True, **kw)
        (route,) = [s.attrs for s in profiling.take()["spans"] if s.name == "sdb.route"]
        rng = np.random.default_rng(39)
        x = torch.as_tensor(rng.standard_normal((n, 128)).astype(np.float32),
                            device="cuda").requires_grad_(True)
        g = torch.as_tensor(rng.standard_normal((n, 128)).astype(np.float32), device="cuda")
        got = plan(x)
        (got * g).sum().backward()
        torch.cuda.synchronize()
        counts = profiling.take()["counts"]
    finally:
        profiling.enable(prev)
    assert route["impl"] == want and route["pricing"] == "kernel", route
    assert route["cost"] <= route["runner_up_cost"], route
    if want == "csr_ell":  # the forward call and Aᵀ's in the backward
        assert counts["sdb.kernel/csr_ell"] == 2, counts
        assert counts["sdb.positions/csr_ell"] == counts["sdb.nnz/csr_ell"] == 2 * csr.nnz
    grad, x.grad = x.grad.clone(), None
    plain = plan_run(plan, x, plain=True)
    (plain * g).sum().backward()
    assert (got - plain).abs().max().item() / plain.abs().max().item() < TOL
    assert (grad - x.grad).abs().max().item() / x.grad.abs().max().item() < TOL


def _per_head_f64(csr: CSR, values, x) -> np.ndarray:
    """float64 A_h @ X_h by head, A_h the pattern with values[h], X_h
    column block h of x."""
    v, x = values.double().cpu().numpy(), x.double().cpu().numpy()
    D = x.shape[1] // v.shape[0]
    outs = []
    for h in range(v.shape[0]):
        a = CSR(csr.indptr, csr.indices, v[h], csr.shape).to_scipy().astype(np.float64)
        outs.append(a @ x[:, h * D:(h + 1) * D])
    return np.concatenate(outs, 1)


@pytest.mark.parametrize("heads,D", [(1, 128), (1, 250), (3, 250), (3, 40), (3, 7)])
def test_ell_kernel_call_values(heads, D, monkeypatch):
    """A values="call" csr_ell plan (the pattern plan) on the card: H heads
    of D columns in one launch of sdb_ell_spmm (D = 128, 40: 16-byte
    loads; 250: 8-byte, the second and third of three heads starting 8
    bytes past a 16-byte boundary; 7: 4-byte), the values (H, nnz) in the
    pattern's entry order read through each segment's offset, across the
    K = 1 class, empty rows, split rows and strips (the widest that fits,
    then 4, 32 and 64 columns a strip inside each head): within 1e-5 of
    the plain version (the chunk loop on the values scattered into their
    slots) and of a float64 product by head; every strip width and a
    second call give the same bits."""
    E = importlib.import_module("spmm_denseblock_tpu_torch.ops.csr_spmm_ell")
    csr = _ell_kernel_csr(False, seed=36)
    plan = E.csr_spmm_ell_plan(csr, grad=False, values="call", device="cuda")
    assert plan.call_values and plan.statics[4] > 0  # partial rows
    rng = np.random.default_rng(D)
    x = torch.as_tensor(rng.standard_normal((csr.n_cols, heads * D)).astype(np.float32),
                        device="cuda")
    v = torch.as_tensor(rng.standard_normal((heads, csr.nnz)).astype(np.float32),
                        device="cuda")
    before = _kernels.ell_spmm.launches
    got = plan(x, values=v if heads > 1 else v[0])
    torch.cuda.synchronize()
    assert _kernels.ell_spmm.launches == before + 1
    want = plan_run(plan, x, plain=True, values=v)
    assert _kernels.ell_spmm.launches == before + 1
    assert got.shape == (csr.n_rows, heads * D) and not got[:10].any()
    rel = (got - want).abs().max().item() / want.abs().max().item()
    assert rel < TOL, rel
    want64 = _per_head_f64(csr, v, x)
    assert np.abs(got.cpu().numpy() - want64).max() / np.abs(want64).max() < TOL
    assert torch.equal(plan(x, values=v), got)
    for W in (4, 32, 64):
        monkeypatch.setattr(E, "ell_strip_width", lambda K, F, l2, W=W: W)
        assert torch.equal(plan(x, values=v), got), W


def test_ell_kernel_call_values_refused():
    """The pattern plan on the card: values of the wrong length, or heads
    that do not divide F, raise before any launch; a call under autograd
    whose operand needs a gradient raises."""
    E = importlib.import_module("spmm_denseblock_tpu_torch.ops.csr_spmm_ell")
    csr = _ell_kernel_csr(False, 400, 300, seed=37)
    plan = E.csr_spmm_ell_plan(csr, grad=False, values="call", device="cuda")
    x = torch.ones(300, 12, device="cuda")
    before = _kernels.ell_spmm.launches
    with pytest.raises(ValueError, match="nnz"):
        plan(x, values=torch.ones(2, csr.nnz + 1, device="cuda"))
    with pytest.raises(ValueError, match="multiple"):
        plan(x, values=torch.ones(5, csr.nnz, device="cuda"))
    with pytest.raises(RuntimeError, match="no gradient"):
        plan(x.requires_grad_(True), values=torch.ones(3, csr.nnz, device="cuda"))
    assert _kernels.ell_spmm.launches == before


@pytest.mark.parametrize("dtype,kernel,n_quantize", [
    (None, "bsr_spmm_sorted", 0), (torch.bfloat16, "bsr_spmm_sorted_bf16", 0),
    (torch.int8, "bsr_spmm_int8_sorted", 2)])
def test_hybrid_plan_launches_its_dense_kernel(dtype, kernel, n_quantize):
    """spmm_plan(impl="hybrid") on a graph whose dense part has >= 8 real
    blocks a block-row: the dense part runs K2 (f32, bf16) or K7 (int8,
    with quantize_int8 for it and for the int8 ELL remainder), once a
    call, and the answer equals the CPU plan's within 1e-5; the dense
    part within 1e-5 of its plain version."""
    from spmm_denseblock_tpu_torch.ops import spmm_plan

    csr = _dense_block_graph()
    kw = dict(impl="hybrid", block_size=32, density_threshold=0.5, grad=False,
              dtype=dtype)
    plan = spmm_plan(csr, **kw)
    assert plan.subplans is not None and len(plan.subplans) == 2
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (512, 72)).astype(np.float32), device="cuda")
    counter = getattr(_kernels, kernel)
    before, q_before = counter.launches, _kernels.quantize_int8.launches
    got = plan(x)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert _kernels.quantize_int8.launches == q_before + n_quantize
    want = spmm_plan(csr, device="cpu", **kw)(x.cpu())
    rel = (got.cpu() - want).abs().max().item() / want.abs().max().item()
    assert rel < TOL, rel
    _check(plan.subplans[0], x, counter)


@pytest.mark.parametrize("case", ["windowed", "windowed bf16", "windowed_int8",
                                  "windowed_int8 calibrated", "tiered"])
def test_windowed_plans_on_card_match_cpu(case):
    """The windowed tiers on the card against their CPU plans:
    windowed_int8 bit for bit at window=2048 (two f32 spans of 1,024
    columns, each exact, added in int32; one window a tile), the rest
    within 1e-5."""
    from spmm_denseblock_tpu_torch.ops import spmm_plan

    csr = _dense_block_graph(seed=14)
    x_np = np.random.default_rng(8).standard_normal((512, 24)).astype(np.float32)
    if case == "tiered":
        kw = dict(impl="tiered", tile_rows=64, window=128, grad=False)
    else:
        kw = dict(impl=case.split()[0], tile_rows=64, window=2048)
        kw.update({"dtype": torch.bfloat16} if "bf16" in case else {})
        kw.update({"calibration": x_np} if "calibrated" in case else {})
        kw.update({} if "int8" in case else {"grad": False})
    want = spmm_plan(csr, device="cpu", **kw)(x_np)
    got = spmm_plan(csr, **kw)(torch.as_tensor(x_np, device="cuda"))
    if "int8" in case:
        assert torch.equal(got.cpu(), want)
    else:
        rel = (got.cpu() - want).abs().max().item() / want.abs().max().item()
        assert rel < TOL, rel


# -- the bench harness's timers and spmm_tune on the card ---------------------


def test_time_chained_agrees_with_cuda_ms_on_k2():
    """bench/timing on the card: time_chained (a chain through _mix,
    between CUDA events) gives K2's time within 10% of cuda_ms's plain
    repeated calls on the same plan and operand, at a shape where K2 runs
    for about a millisecond (the chain's _mix adds a pass over X)."""
    from spmm_denseblock_tpu_torch.bench.timing import (
        cuda_ms,
        time_chained,
        time_chained_square,
    )

    bsr = random_bsr(0.05, 256, 256, block_size=128, seed=2)
    plan = T.bsr_spmm_pallas_plan(bsr, grad=False, device="cuda")
    assert plan.statics[0] == "sorted"
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (bsr.shape[1], 512)).astype(np.float32), device="cuda")
    before = _kernels.bsr_spmm_sorted.launches
    with torch.no_grad():
        events = cuda_ms(lambda: plan(x), iters=20) / 1e3
        chained = time_chained(plan, x, iters=20)
        square = time_chained_square(plan, x, iters=20)
    assert _kernels.bsr_spmm_sorted.launches - before == 22 + 2 * 22
    for t in (chained, square):
        assert abs(t - events) <= 0.10 * events, (t, events)


def test_spmm_tune_raises_a_refused_launch(monkeypatch):
    """A K10 launch the entry refuses (a strip width of 33 columns, which
    has no kernel, forced through csr_strip_width) is a CUDA launch
    failure: spmm_tune raises it instead of reporting the candidate. The
    refusal comes before the launch, so the card stays usable: the same
    tune without the forced width times both candidates and picks one."""
    from spmm_denseblock_tpu_torch.ops import spmm_tune

    csr = random_csr(0.01, 4096, seed=5)
    x = np.random.default_rng(5).standard_normal((4096, 128)).astype(np.float32)
    with monkeypatch.context() as m:
        m.setattr(TP, "csr_strip_width", lambda K, F, l2, itemsize=4: 33)
        with pytest.raises(RuntimeError, match="cudaError_t"):
            spmm_tune(csr, x, candidates=("csr_xla", "csr_pallas"), grad=False)
    plan, report = spmm_tune(csr, x, candidates=("csr_xla", "csr_pallas"), grad=False)
    assert report["best"] in ("csr_xla", "csr_pallas")
    assert all(report[k]["ms"] > 0 for k in ("csr_xla", "csr_pallas"))
    assert_allclose(plan(torch.as_tensor(x, device="cuda")), spmm_scipy(csr, x))


def test_trace_names_the_kernel_entry(tmp_path):
    """utils.trace on the card: the Chrome trace of one K2 call names the
    entry sdb_bsr_spmm_sorted (the launcher's range) and holds device
    kernels."""
    import json

    from spmm_denseblock_tpu_torch.utils import trace

    bsr = random_bsr(0.8, 16, 16, block_size=128, seed=1)
    plan = T.bsr_spmm_pallas_plan(bsr, grad=False, device="cuda")
    assert plan.statics[0] == "sorted"
    x = torch.ones(bsr.shape[1], 64, device="cuda")
    plan(x)
    with trace(str(tmp_path)):
        plan(x)
    (path,) = tmp_path.glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "sdb_bsr_spmm_sorted" in names
    assert any(e.get("cat") == "kernel" for e in events)



# family: (plan kwargs, the counters its call on the card moves), one
# case per layout branch of _pallas_apply and the int8 _run
PLAIN_BSR_CASES = {
    "f32": ({}, {"sdb_bsr_spmm_sorted"}),
    "f32_flat": ({"depth_sort": False}, {"sdb_bsr_spmm_flat"}),
    "f32_resident": ({"resident": True, "depth_sort": False},
                     {"sdb_bsr_spmm_resident"}),
    "bf16": ({"dtype": torch.bfloat16}, {"sdb_bsr_spmm_sorted_bf16"}),
    "bf16_rowgroup": ({"dtype": torch.bfloat16, "depth_sort": False},
                      {"sdb_bsr_spmm_rowgroup_bf16"}),
    "bf16x3": ({"precision": "high"}, {"sdb_bsr_spmm_sorted_bf16x3",
                                       "sdb_split_bf16"}),
    "bf16x3_resident": ({"precision": "high", "resident": True,
                         "depth_sort": False},
                        {"sdb_bsr_spmm_resident_bf16x3", "sdb_split_bf16"}),
}
PLAIN_INT8_CASES = {
    "int8": ({"depth_sort": True}, "sdb_bsr_spmm_int8_sorted"),
    "int8_flat": ({"resident": False}, "sdb_bsr_spmm_int8_flat"),
    "int8_rowgroup": ({"depth_sort": False}, "sdb_bsr_spmm_int8_rowgroup"),
    "int8_resident": ({"resident": True, "f_tile": 128},
                      "sdb_bsr_spmm_int8_resident"),
}


def _plain_case(family):
    """(plan, its operand's rows, the counters its call on the card
    moves) of one hand-kernel family and layout: f32, bf16 and bf16x3 BSR
    (K1-K5), int8 (K6-K9 and the quantizer), K10 and the f32 ELL tier."""
    E = importlib.import_module("spmm_denseblock_tpu_torch.ops.csr_spmm_ell")
    bsr = _bsr(37, 32, 0.3, seed=4)
    if family in PLAIN_INT8_CASES:
        kw, kernel = PLAIN_INT8_CASES[family]
        return (TI.bsr_spmm_pallas_int8_plan(bsr, device="cuda", **kw), bsr.shape[1],
                {kernel, "sdb_quantize_int8"})
    if family == "k10":
        csr = _csr()
        return (TP.csr_spmm_pallas_plan(csr, grad=False, device="cuda"), csr.n_cols,
                {"sdb_csr_spmm"})
    if family == "ell":
        csr = _ell_kernel_csr(True)
        return (E.csr_spmm_ell_plan(csr, grad=False, device="cuda"), csr.n_cols,
                {"sdb_ell_spmm"})
    kw, moved = PLAIN_BSR_CASES[family]
    plan = T.bsr_spmm_pallas_plan(bsr, grad=False, device="cuda", **kw)
    return plan, bsr.shape[1], moved


@pytest.mark.parametrize("family", [*PLAIN_BSR_CASES, *PLAIN_INT8_CASES, "k10", "ell"])
def test_plain_run_launches_no_kernel(family):
    """run(plan, x, plain=True) on the card runs the kernels' plain
    versions: the wrappers choose, and no counter of _kernels.KERNELS
    moves. The same plan's call launches its kernels (each named counter
    once, no other) and agrees with the plain answer."""
    plan, n_cols, moved = _plain_case(family)
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (n_cols, 70)).astype(np.float32), device="cuda")
    counts = {k.symbol: k.launches for k in _kernels.KERNELS}
    want = plan_run(plan, x, plain=True)
    torch.cuda.synchronize()
    assert {k.symbol: k.launches for k in _kernels.KERNELS} == counts
    got = plan(x)
    torch.cuda.synchronize()
    after = {k.symbol: k.launches for k in _kernels.KERNELS}
    assert {n: after[n] - counts[n] for n in after if after[n] != counts[n]} == \
        dict.fromkeys(moved, 1)
    rel = (got - want).abs().max().item() / max(want.abs().max().item(), 1.0)
    assert rel < TOL, rel
