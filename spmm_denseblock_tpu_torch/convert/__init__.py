from spmm_denseblock_tpu_torch.convert.csr2bsr import bsr_to_csr, csr_to_bsr
from spmm_denseblock_tpu_torch.convert.pack import round_up

__all__ = ["csr_to_bsr", "bsr_to_csr", "round_up"]
