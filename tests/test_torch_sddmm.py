"""SDDMM (both tiers) and the dense-block GEMM, JAX package against the
port, on the CPU, on seeded numpy inputs.

Tolerances: f32 1e-5 relative to max |JAX| (the same products; only the
order of the f32 sums differs). bf16 block tier the same 1e-5: both
packages multiply the bf16 operands exactly in f32 and return f32. bf16
element tier: both round each product to bf16, sum in f32 and round the
sum to bf16, so a different f32 summation order can move an answer by
one bf16 ulp, 2^-7 of it: 1e-2 relative to max |JAX|."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmm_denseblock_tpu.formats.csr as j_csr
import spmm_denseblock_tpu.ops as j_ops
import spmm_denseblock_tpu_torch.formats.csr as t_csr
import spmm_denseblock_tpu_torch.ops as t_ops
from spmm_denseblock_tpu.convert.csr2bsr import csr_to_bsr as j_csr_to_bsr
from spmm_denseblock_tpu_torch.convert.csr2bsr import csr_to_bsr

torch.set_num_threads(2)

TOL = 1e-5
BF16_ELEMENT_TOL = 1e-2


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _operands(n_rows, n_cols, d, dtype, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n_rows, d)).astype(np.float32)
    y = rng.standard_normal((n_cols, d)).astype(np.float32)
    if dtype == "bfloat16":
        return (jnp.asarray(x, jnp.bfloat16), jnp.asarray(y, jnp.bfloat16),
                torch.as_tensor(x).bfloat16(), torch.as_tensor(y).bfloat16())
    return x, y, torch.as_tensor(x), torch.as_tensor(y)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(30, 24, 7), (50, 50, 33)])
def test_sddmm_element_matches_jax(shape, dtype):
    n_rows, n_cols, d = shape
    csr = t_csr.random_csr(0.08, n_rows, n_cols, seed=11)
    jcsr = j_csr.random_csr(0.08, n_rows, n_cols, seed=11)
    jx, jy, tx, ty = _operands(n_rows, n_cols, d, dtype)
    want = np.asarray(j_ops.sddmm(jcsr, jx, jy).astype(jnp.float32))
    got = t_ops.sddmm(csr, tx, ty, device="cpu")
    plan = t_ops.sddmm_plan(csr, device="cpu")
    assert got.dtype == getattr(torch, dtype) and got.shape == (csr.nnz,)
    assert torch.equal(plan(tx, ty), got)
    tol = TOL if dtype == "float32" else BF16_ELEMENT_TOL
    assert _rel(got.float().numpy(), want) < tol
    # and the dense product at the stored positions
    full = tx.double() @ ty.double().T
    ref = full[torch.as_tensor(csr.row_ids()).long(),
               torch.as_tensor(csr.indices).long()]
    assert _rel(got.double().numpy(), ref.numpy()) < tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [4, 8])
def test_sddmm_block_matches_jax(b, dtype):
    """Score blocks on a BSR pattern of a ragged grid (30 x 24, padded up
    to the block grid): f32 out for f32 and bf16 operands alike."""
    csr = t_csr.random_csr(0.08, 30, 24, seed=11)
    bsr = csr_to_bsr(csr, b)
    rows, cols = bsr.block_rows[: bsr.nnzb], bsr.block_cols[: bsr.nnzb]
    jx, jy, tx, ty = _operands(30, 24, 7, dtype, seed=2)
    want = np.asarray(j_ops.sddmm_block_plan(rows, cols, b, 30, 24)(jx, jy))
    plan = t_ops.sddmm_block_plan(rows, cols, b, 30, 24, device="cpu")
    got = plan(tx, ty)
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert got.shape == (bsr.nnzb, b, b)
    assert _rel(got.numpy(), want) < TOL
    # the dense product restricted to each block
    xp = torch.zeros(-(-30 // b) * b, 7, dtype=torch.float64)
    yp = torch.zeros(-(-24 // b) * b, 7, dtype=torch.float64)
    xp[:30], yp[:24] = tx.double(), ty.double()
    full = xp @ yp.T
    for k in range(bsr.nnzb):
        r, c = int(rows[k]) * b, int(cols[k]) * b
        assert _rel(got[k].double().numpy(), full[r:r + b, c:c + b].numpy()) < TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_block_gemm_unsorted_repeated_rows(dtype):
    """An unsorted block list with repeated block-rows (shuffled, as the
    reference's per-block GEMM driver takes them) against JAX, and the
    scatter semantics against spmm_scipy (the JAX package's own test)."""
    csr = t_csr.random_csr(0.05, 64, seed=33)
    b, dim = 8, 32
    bsr = csr_to_bsr(csr, b)
    assert np.array_equal(bsr.blocks, j_csr_to_bsr(
        j_csr.random_csr(0.05, 64, seed=33), b).blocks)
    order = np.random.default_rng(4).permutation(bsr.nnzb)
    rows, cols, blocks = (bsr.block_rows[order], bsr.block_cols[order],
                          bsr.blocks[order])
    assert np.any(np.diff(rows) < 0) and len(np.unique(rows)) < len(rows)
    dense = np.random.default_rng(2).standard_normal((64, dim)).astype(np.float32)
    dense_blk = dense.reshape(8, b, dim)
    if dtype == "bfloat16":
        j_in = (jnp.asarray(blocks, jnp.bfloat16), jnp.asarray(dense_blk, jnp.bfloat16))
        t_in = (torch.as_tensor(blocks).bfloat16(), torch.as_tensor(dense_blk).bfloat16())
    else:
        j_in, t_in = (blocks, dense_blk), (blocks, dense_blk)
    want = np.asarray(j_ops.dense_block_gemm(
        jnp.asarray(rows), jnp.asarray(cols), *j_in, bsr.n_block_rows))
    got = t_ops.dense_block_gemm(rows, cols, *t_in, bsr.n_block_rows, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (8, b, dim)
    assert _rel(got.numpy(), want) < TOL
    if dtype == "float32":
        t_ops.assert_allclose(got.reshape(64, dim), t_ops.spmm_scipy(csr, dense),
                              msg="dense_block_gemm")
