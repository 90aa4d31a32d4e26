"""Hybrid format: a dense-block BSR part and a remainder CSR part (twin
of ``spmm_denseblock_tpu/formats/hybrid.py``).

``convert.divide`` builds one; ``ops.hybrid_spmm`` runs the two parts,
each through its own tier, and adds their outputs: the reference's
divide.cu pattern (z += csrmm2(leftover CSR); z += bsrmm(dense blocks)).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from spmm_denseblock_tpu_torch.formats.bsr import BSR
from spmm_denseblock_tpu_torch.formats.csr import CSR


@dataclasses.dataclass(frozen=True)
class Hybrid:
    """The BSR part holds the blocks whose occupancy reached the density
    threshold of the split, the CSR part every other nonzero:
    dense.to_dense() + remainder.to_dense() is the original matrix."""

    dense: BSR
    remainder: CSR
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return self.dense.nnz_inside() + self.remainder.nnz

    def to_dense(self) -> np.ndarray:
        return self.dense.to_dense() + self.remainder.to_dense()

    def to(self, device, block_dtype: Optional[torch.dtype] = None) -> dict:
        """Both parts' arrays as torch tensors on `device` (BSR.to and
        CSR.to), the blocks cast to `block_dtype` when given."""
        return {"dense": self.dense.to(device, block_dtype),
                "remainder": self.remainder.to(device)}
