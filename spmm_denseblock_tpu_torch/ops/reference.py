"""Correctness oracles (twin of ``spmm_denseblock_tpu/ops/reference.py``).

Every kernel is checked elementwise against an independent
implementation on the same seeded inputs, with eps 1e-4: scipy on the
host, and a dense torch matmul in full f32.
"""

from __future__ import annotations

import numpy as np
import torch

from spmm_denseblock_tpu_torch.formats.bsr import BSR
from spmm_denseblock_tpu_torch.formats.csr import CSR

CHECK_EPS = 1e-4


def spmm_scipy(mat, dense: np.ndarray) -> np.ndarray:
    """Host oracle for anything with to_scipy (CSR) or to_dense (BSR)."""
    if isinstance(mat, CSR):
        return np.asarray(mat.to_scipy() @ dense, dtype=np.float32)
    return np.asarray(mat.to_dense() @ dense, dtype=np.float32)


def spmm_dense_torch(mat, dense, device=None) -> torch.Tensor:
    """Device oracle: densify, then one f32 matmul. TF32 is switched off
    for the call, so the product is full f32 on a GPU as well."""
    a = mat if isinstance(mat, torch.Tensor) else mat.to_dense()
    b = torch.as_tensor(dense, device=device)
    a = torch.as_tensor(a, device=b.device, dtype=torch.float32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return a @ b.to(torch.float32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def assert_allclose(got, want, eps: float = CHECK_EPS, msg: str = "") -> float:
    """Relative-or-absolute elementwise gate: max |got - want| /
    max(1, |want|) < eps. Returns that maximum."""
    if isinstance(got, torch.Tensor):
        got = got.detach().cpu().float().numpy()
    if isinstance(want, torch.Tensor):
        want = want.detach().cpu().float().numpy()
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    denom = np.maximum(1.0, np.abs(want))
    err = np.max(np.abs(got - want) / denom) if got.size else 0.0
    if err >= eps:
        raise AssertionError(f"{msg} max rel-err {err:.3e} >= {eps:.1e}")
    return float(err)


def _split_bf16_ints(v: np.ndarray):
    """(hi, lo) of integer-valued v with 257 <= |v| <= 511 or v = 0 (split
    into zeros), the split of
    ``_dot3`` worked out by hand: bf16 keeps 8 significant bits, so in
    [256, 512) it holds the even integers; an odd |v| is a tie and rounds
    to the even significand, a multiple of 4. lo = v - hi is -1, 0 or 1."""
    m = np.abs(v)
    hi = np.where(m % 2 == 0, m, np.where((m + 1) % 4 == 0, m + 1, m - 1))
    hi = np.sign(v) * hi
    return hi, v - hi


def bf16x3_exact_case(F: int = 96, seed: int = 0, b: int = 16):
    """An input on which the bf16x3 product (``_dot3``: A_hi X_hi + A_hi
    X_lo + A_lo X_hi) and exact f32 give different answers, each of them
    exact in f32 whatever the order of the sums, so a kernel must match
    its answer bit for bit.

    Every nonzero block and operand value is an integer of magnitude 257
    .. 288, so hi and lo are integers (``_split_bf16_ints``), every
    product is an integer, and one output's terms sum in magnitude to
    under 2^24: every partial sum is exact in f32. That allows 16
    nonzeros in each row of a block: at b = 16 the blocks are full, at
    b = 64 and 128 each row of a block holds 16 nonzeros at random
    columns (the rest zero), so the 4,096-deep rows of the tensor-core
    loop stay exact. The two answers differ by A_lo X_lo. 7 block-rows
    of 12 block-columns, block-row 2 empty and the others holding 10 or
    11 blocks (9 real blocks per block-row on average, so the f32 "high"
    plan sorts by default). Returns (bsr, x (12*b, F) f32, want_bf16x3,
    want_exact), the wants (7*b, F) float64 arrays of f32 values."""
    nbr, nbc = 7, 12
    rng = np.random.default_rng(seed)

    def ints(shape):
        return (rng.integers(257, 289, size=shape)
                * rng.choice([-1, 1], size=shape)).astype(np.float32)

    rows, cols = [], []
    for r in range(nbr):
        if r == 2:
            continue
        c = np.sort(rng.choice(nbc, size=int(rng.integers(10, 12)), replace=False))
        rows += [r] * c.size
        cols += c.tolist()
    blocks = ints((len(rows), b, b))
    x = ints((nbc * b, F))
    if b > 16:  # 16 nonzeros in each row of each block
        keep = rng.random((len(rows), b, b)).argsort(axis=2).argsort(axis=2) < 16
        blocks *= keep
    bsr = BSR.from_parts(np.asarray(rows, np.int32), np.asarray(cols, np.int32),
                         blocks, (nbr * b, nbc * b), b)
    a = bsr.to_dense().astype(np.float64)
    x64 = x.astype(np.float64)
    (ah, al), (xh, xl) = _split_bf16_ints(a), _split_bf16_ints(x64)
    bound = (np.abs(ah) + np.abs(al)) @ (np.abs(xh) + np.abs(xl))
    assert bound.max() < 2.0 ** 24, bound.max()
    want_bf16x3 = ah @ xh + ah @ xl + al @ xh
    want_exact = a @ x64
    assert (want_bf16x3 != want_exact).mean() > 0.5
    return bsr, x, want_bf16x3, want_exact


def bf16_exact_case(b: int = 64, F: int = 96, seed: int = 0):
    """An input on which a bf16 kernel must match float64, and so its
    plain version, bit for bit: every block and operand value is an
    integer of magnitude <= 16 (exact in bf16), so every product is an
    integer and every partial sum of one output an integer under 2^24,
    exact in f32 whatever the order of the sums. A misplaced accumulator
    fragment, a wrong swizzle or an operand read untransposed changes the
    answer instead of rounding it.

    7 block-rows of 12 block-columns, block-row 2 empty and the others
    holding 2 to 6 blocks (about 3.4 real blocks per block-row, so the
    bf16 plan sorts by default and packs consecutive row groups with
    depth_sort=False). Returns (bsr, x (12*b, F) f32, want (7*b, F)
    float64)."""
    nbr, nbc = 7, 12
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for r in range(nbr):
        if r == 2:
            continue
        c = np.sort(rng.choice(nbc, size=int(rng.integers(2, 7)), replace=False))
        rows += [r] * c.size
        cols += c.tolist()
    blocks = rng.integers(-16, 17, size=(len(rows), b, b)).astype(np.float32)
    bsr = BSR.from_parts(np.asarray(rows, np.int32), np.asarray(cols, np.int32),
                         blocks, (nbr * b, nbc * b), b)
    x = rng.integers(-16, 17, size=(nbc * b, F)).astype(np.float32)
    a = bsr.to_dense().astype(np.float64)
    assert (np.abs(a) @ np.abs(x.astype(np.float64))).max() < 2.0 ** 24
    return bsr, x, a @ x.astype(np.float64)


def int8_exact_case(b: int = 64, F: int = 96, seed: int = 0,
                    n_block_rows: int = 7):
    """An input on which an int8 kernel must match float64, and so its
    plain version, bit for bit, in either scale mode: nothing rounds
    before the column scale. Each block is integers of magnitude <= 8
    with one entry of magnitude 127, times its block-row's power of two
    2^e (e in -3 .. 3): every slot scale and every lane-step scale
    (absmax / 127) is that 2^e, and the blocks quantize to the integers.
    Each operand column is integers of magnitude <= 8 with one entry of
    magnitude 127, so the dynamic quantizer maps it to itself. Every
    partial sum of one output is 2^e times an integer under 2^24, exact
    in f32 whatever the order of the sums; the one rounding is the f32
    product with the column scale. A misplaced accumulator fragment, a
    wrong swizzle or descriptor, or a scale of the wrong slot changes the
    answer instead of rounding it.

    n_block_rows block-rows of 12 block-columns, block-row 2 empty and the
    others holding 2 to 6 blocks (int8 sorts only when asked:
    depth_sort=True). Returns (bsr, x (12*b, F) f32, want (n_block_rows*b,
    F) float64): float64's A X, times the column scale in f32."""
    from spmm_denseblock_tpu_torch.ops.bsr_spmm_int8 import quantize_per_column

    nbr, nbc = n_block_rows, 12
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for r in range(nbr):
        if r == 2:
            continue
        c = np.sort(rng.choice(nbc, size=int(rng.integers(2, 7)), replace=False))
        rows += [r] * c.size
        cols += c.tolist()
    n = len(rows)
    q = rng.integers(-8, 9, size=(n, b, b))
    q[np.arange(n), rng.integers(0, b, n), rng.integers(0, b, n)] = (
        127 * rng.choice([-1, 1], n))
    row_scale = np.exp2(rng.integers(-3, 4, size=nbr))
    blocks = (q * row_scale[rows][:, None, None]).astype(np.float32)
    x = rng.integers(-8, 9, size=(nbc * b, F))
    x[rng.integers(0, nbc * b, F), np.arange(F)] = 127 * rng.choice([-1, 1], F)
    x = x.astype(np.float32)
    bsr = BSR.from_parts(np.asarray(rows, np.int32), np.asarray(cols, np.int32),
                         blocks, (nbr * b, nbc * b), b)
    qx, cs = quantize_per_column(torch.from_numpy(x))
    assert torch.equal(qx.float(), torch.from_numpy(x))
    a = bsr.to_dense().astype(np.float64)
    ints = np.abs(a) / np.repeat(row_scale, b)[:, None]
    assert (ints @ np.abs(x.astype(np.float64))).max() < 2.0 ** 24
    want = (a @ x.astype(np.float64)).astype(np.float32) * cs.numpy()
    return bsr, x, want.astype(np.float64)
