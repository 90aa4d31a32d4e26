"""CSR -> BSR at a static capacity (count_nnzb_device, csr_to_bsr_device,
csr_to_bsr_on_device), JAX package against the port, on the CPU: every
padded array bit-equal to JAX's (block ids, blocks, nnzb), the real
blocks equal to the host converter's, the capacity contract (overfull:
padding parked on the last block-row at column 0; undersized: blocks
past the capacity dropped as JAX drops them), a block grid past 2^31
cells, the empty matrix, and the result fed to spmm_plan."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import spmm_denseblock_tpu.formats.csr as j_csr
import spmm_denseblock_tpu.ops as j_ops
import spmm_denseblock_tpu.ops.device_convert as J
import spmm_denseblock_tpu_torch.formats.csr as t_csr
import spmm_denseblock_tpu_torch.ops as t_ops
import spmm_denseblock_tpu_torch.ops.device_convert as T
from spmm_denseblock_tpu_torch.convert.csr2bsr import csr_to_bsr

torch.set_num_threads(2)


def _pair(p=0.03, n_rows=100, n_cols=90, seed=8, dup=False):
    """The same random CSR in both packages; dup=True adds duplicate
    entries (kept, as ogbl-ddi keeps its duplicate edges)."""
    src = t_csr.random_csr(p, n_rows, n_cols, seed=seed)
    rows, cols, vals = src.row_ids(), np.asarray(src.indices), src.values()
    if dup:
        rows, cols, vals = (np.concatenate([rows, rows[::3]]),
                            np.concatenate([cols, cols[::3]]),
                            np.concatenate([vals, vals[::3] * 0.5]))
        order = np.lexsort((cols, rows))
        rows, cols, vals = rows[order], cols[order], vals[order]
        indptr = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n_rows))])
        args = dict(indptr=indptr.astype(np.int32), indices=cols.astype(np.int32),
                    data=vals.astype(np.float32), shape=(n_rows, n_cols))
        return j_csr.CSR(**args), t_csr.CSR(**args)
    args = dict(indptr=np.asarray(src.indptr), indices=cols, data=vals,
                shape=(n_rows, n_cols))
    return j_csr.CSR(**args), t_csr.CSR(**args)


def _same_as_jax(j_bsr, t_bsr):
    assert t_bsr.nnzb == int(j_bsr.nnzb)
    for name in ("block_rows", "block_cols", "blocks"):
        want = np.asarray(getattr(j_bsr, name))
        got = getattr(t_bsr, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name


@pytest.mark.parametrize("b,dup", [(8, False), (16, False), (16, True)])
def test_matches_jax_and_host(b, dup):
    """No capacity given: phase 1 counts, and the result is JAX's bit for
    bit and the host converter's (no padding then)."""
    jc, tc = _pair(dup=dup)
    host = csr_to_bsr(tc, b)
    nbc = -(-tc.shape[1] // b)
    count = T.count_nnzb_device(tc.row_ids(), tc.indices, nbc, b, device="cpu")
    assert count.dtype == torch.int32 and int(count) == host.nnzb
    assert int(J.count_nnzb_device(jnp.asarray(jc.row_ids()),
                                   jnp.asarray(np.asarray(jc.indices, np.int32)),
                                   nbc, b)) == host.nnzb
    got = T.csr_to_bsr_on_device(tc, b, device="cpu")
    _same_as_jax(J.csr_to_bsr_on_device(jc, b), got)
    assert got.nnzb == host.nnzb
    for name in ("block_rows", "block_cols", "blocks"):
        assert np.array_equal(getattr(got, name), getattr(host, name)), name


@pytest.mark.parametrize("extra", [-9, -1, 7])
def test_capacity_contract(extra):
    """nnzb_max = count + extra: overfull capacities park zero blocks on
    the last block-row at column 0; undersized ones keep the first
    nnzb_max - 1 blocks and the last slot's own block, and report the
    true count, as JAX does."""
    jc, tc = _pair()
    b = 16
    host = csr_to_bsr(tc, b)
    cap = host.nnzb + extra
    got = T.csr_to_bsr_on_device(tc, b, nnzb_max=cap, device="cpu")
    _same_as_jax(J.csr_to_bsr_on_device(jc, b, nnzb_max=cap), got)
    assert got.blocks.shape == (cap, b, b) and got.nnzb == host.nnzb
    keep = min(cap, host.nnzb)
    for name in ("block_rows", "block_cols", "blocks"):
        assert np.array_equal(getattr(got, name)[:keep], getattr(host, name)[:keep])
    if extra > 0:
        assert (got.block_rows[keep:] == host.n_block_rows - 1).all()
        assert (got.block_cols[keep:] == 0).all() and not got.blocks[keep:].any()


def test_huge_block_grid():
    """A grid of 2^40 cells: two elements whose fused int32 keys would
    collide are counted and placed apart (the JAX package's regression
    test, tests/test_convert.py)."""
    b, nbc = 16, 2 ** 20
    row_ids = np.array([0, (2 ** 11) * b], np.int32)
    col_ids = np.array([0, 0], np.int32)
    assert int(T.count_nnzb_device(row_ids, col_ids, nbc, b, device="cpu")) == 2
    got = T.csr_to_bsr_device(row_ids, col_ids, None, 2 ** 20, nbc, b, 4, device="cpu")
    want = J.csr_to_bsr_device(jnp.asarray(row_ids), jnp.asarray(col_ids), None,
                               2 ** 20, nbc, b, 4)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert [int(r) for r in got[0][:2]] == [0, 2 ** 11]
    assert got[2][:2, 0, 0].tolist() == [1.0, 1.0]


@pytest.mark.parametrize("cap", [0, 4])
def test_empty_matrix(cap):
    """No nonzeros: nnzb 0 and every slot padding, as JAX."""
    tc = t_csr.CSR.from_coo([], [], None, (16, 16))
    jc = j_csr.CSR.from_coo([], [], None, (16, 16))
    assert int(T.count_nnzb_device(tc.row_ids(), tc.indices, 2, 8, device="cpu")) == 0
    got = T.csr_to_bsr_on_device(tc, 8, nnzb_max=cap, device="cpu")
    _same_as_jax(J.csr_to_bsr_on_device(jc, 8, nnzb_max=cap), got)
    assert got.nnzb == 0 and (got.block_rows == 1).all()


@pytest.mark.parametrize("impl,b", [("bsr_xla", 8), ("bsr_pallas", 8), ("bsr_pallas", 16)])
def test_feeds_spmm_plan(impl, b):
    """The padded result (capacity past the count) as spmm_plan's input:
    within 1e-4 of spmm_scipy, and JAX's plan on JAX's conversion."""
    jc, tc = _pair(p=0.05, n_rows=64, n_cols=64, seed=2)
    bsr = T.csr_to_bsr_on_device(tc, b, nnzb_max=csr_to_bsr(tc, b).nnzb + 3,
                                 device="cpu")
    x = np.random.default_rng(1).standard_normal((64, 12)).astype(np.float32)
    got = t_ops.spmm_plan(bsr, impl=impl, block_size=b, grad=False, device="cpu")(x)
    t_ops.assert_allclose(got, t_ops.spmm_scipy(tc, x), msg=impl)
    want = j_ops.spmm_plan(J.csr_to_bsr_on_device(jc, b, nnzb_max=bsr.nnzb + 3),
                           impl=impl, block_size=b, grad=False)(x)
    t_ops.assert_allclose(got, np.asarray(want), msg=f"{impl} vs JAX")
