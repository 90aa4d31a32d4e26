from spmm_denseblock_tpu_torch.formats.csr import CSR, random_csr
from spmm_denseblock_tpu_torch.formats.bsr import BSR, random_bsr
from spmm_denseblock_tpu_torch.formats.hybrid import Hybrid
from spmm_denseblock_tpu_torch.formats.windowed import Windowed, divide_windowed

__all__ = ["CSR", "BSR", "Hybrid", "Windowed", "random_csr", "random_bsr",
           "divide_windowed"]
