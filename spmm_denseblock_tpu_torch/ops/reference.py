"""Correctness oracles (twin of ``spmm_denseblock_tpu/ops/reference.py``).

Every kernel is checked elementwise against an independent
implementation on the same seeded inputs, with eps 1e-4: scipy on the
host, and a dense torch matmul in full f32.
"""

from __future__ import annotations

import numpy as np
import torch

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


def assert_allclose(got, want, eps: float = CHECK_EPS, msg: str = ""):
    """Relative-or-absolute elementwise gate: max |got - want| /
    max(1, |want|) < eps."""
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
