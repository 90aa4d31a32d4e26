from spmm_denseblock_tpu_torch.formats.csr import CSR, random_csr
from spmm_denseblock_tpu_torch.formats.bsr import BSR, random_bsr

__all__ = ["CSR", "BSR", "random_csr", "random_bsr"]
