from spmm_denseblock_tpu_torch.convert.csr2bsr import bsr_to_csr, csr_to_bsr
from spmm_denseblock_tpu_torch.convert.divide import (
    auto_threshold,
    divide,
    ell_padded_slots,
    score_thresholds,
)
from spmm_denseblock_tpu_torch.convert.pack import pad_dense_rows, repack_bsr, round_up

__all__ = ["csr_to_bsr", "bsr_to_csr", "repack_bsr", "round_up", "pad_dense_rows",
           "divide", "auto_threshold", "ell_padded_slots", "score_thresholds"]
