"""The CUDA kernels K1 (flat grouped gather) and K2 (depth-sorted row
groups) against their plain PyTorch versions on the card, their launch
counters, and the wrapper's refusals. CUDA kernels have no CPU mode, so
these tests skip without a GPU; run them on one with

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

(tests/conftest.py imports jax, which these tests do not need).

Tolerance: 1e-5 relative to max |plain| (same operands in the same
dtype; only the order of the f32 sums differs)."""

import importlib

import numpy as np
import pytest
import torch

from spmm_denseblock_tpu_torch.formats.bsr import BSR, random_bsr
from spmm_denseblock_tpu_torch.ops import _kernels, assert_allclose, spmm_scipy

T = importlib.import_module("spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas")

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
    two empty block-rows (covered by zero blocks), ragged F."""
    bsr = _bsr(37, b, 0.3, seed=b)
    plan = T.bsr_spmm_pallas_plan(bsr, dtype=dtype, grad=False,
                                  depth_sort=layout == "sorted", device="cuda")
    assert plan.statics[0] == layout
    kernel = _kernels.bsr_spmm_sorted if layout == "sorted" else _kernels.bsr_spmm_flat
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (bsr.shape[1], 133)).astype(np.float32), device="cuda")
    got = _check(plan, x, kernel)
    if dtype is None:
        assert_allclose(got, spmm_scipy(bsr, x.cpu().numpy()))


def test_plan_matches_cpu_plan():
    bsr = _bsr(20, 32, 0.4, seed=1)
    x = np.random.default_rng(1).standard_normal((bsr.shape[1], 64)).astype(np.float32)
    cpu = T.bsr_spmm_pallas_plan(bsr, grad=False)
    gpu = T.bsr_spmm_pallas_plan(bsr, grad=False).to("cuda")
    assert_allclose(gpu(torch.as_tensor(x, device="cuda")), cpu(x))


def test_wrappers_refuse_bad_operands():
    bsr = _bsr(8, 8, 0.5, seed=2)
    counts = [k.launches for k in _kernels.KERNELS]
    plan = T.bsr_spmm_pallas_plan(bsr, grad=False, device="cuda")
    with pytest.raises(ValueError, match="block size"):
        plan(torch.zeros(bsr.shape[1], 4, device="cuda"))
    plan = T.bsr_spmm_pallas_plan(_bsr(8, 16, 0.5, seed=2), grad=False,
                                  device="cuda")
    step_rows, slot_cols, blocks, step_ptr = plan.arrays
    with pytest.raises(TypeError, match="dtype"):
        T.spmm_flat(step_rows, step_ptr, slot_cols, blocks.half(),
                    torch.zeros(128, 4, device="cuda", dtype=torch.half),
                    plan.statics[-1])
    with pytest.raises(ValueError, match="device"):
        T.spmm_flat(step_rows, step_ptr, slot_cols, blocks,
                    torch.zeros(128, 4), plan.statics[-1])
    assert [k.launches for k in _kernels.KERNELS] == counts
