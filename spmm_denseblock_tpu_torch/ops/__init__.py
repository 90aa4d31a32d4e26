from spmm_denseblock_tpu_torch.ops.bsr_spmm_int8 import (
    bsr_spmm_int8,
    bsr_spmm_int8_plan,
)
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas import (
    bsr_spmm_pallas,
    bsr_spmm_pallas_plan,
)
from spmm_denseblock_tpu_torch.ops.bsr_spmm_pallas_int8 import bsr_spmm_pallas_int8_plan
from spmm_denseblock_tpu_torch.ops.bsr_spmm_xla import bsr_spmm_xla, bsr_spmm_xla_plan
from spmm_denseblock_tpu_torch.ops.csr_spmm import (
    CHUNK_NNZ_BYTES,
    bcoo_spmm_plan,
    csr_spmm,
    csr_spmm_plan,
)
from spmm_denseblock_tpu_torch.ops.csr_spmm_pallas import (
    csr_spmm_pallas,
    csr_spmm_pallas_plan,
)
from spmm_denseblock_tpu_torch.ops.csr_spmm_ell import (
    csr_spmm_ell,
    csr_spmm_ell_banded_plan,
    csr_spmm_ell_int8_plan,
    csr_spmm_ell_plan,
)
from spmm_denseblock_tpu_torch.ops.dense_block_gemm import dense_block_gemm
from spmm_denseblock_tpu_torch.ops.device_convert import (
    count_nnzb_device,
    csr_to_bsr_device,
    csr_to_bsr_on_device,
)
from spmm_denseblock_tpu_torch.ops.dispatch import PLANNERS, spmm_plan
from spmm_denseblock_tpu_torch.ops.hybrid_spmm import (
    hybrid_spmm,
    hybrid_spmm_int8_plan,
    hybrid_spmm_plan,
)
from spmm_denseblock_tpu_torch.ops.plan import Plan, grad_plan, sum_plan, transb_plan
from spmm_denseblock_tpu_torch.ops.reference import (
    CHECK_EPS,
    assert_allclose,
    spmm_dense_torch,
    spmm_scipy,
)
from spmm_denseblock_tpu_torch.ops.sddmm import sddmm, sddmm_block_plan, sddmm_plan
from spmm_denseblock_tpu_torch.ops.windowed_spmm import (
    tiered_spmm_plan,
    windowed_spmm,
    windowed_spmm_int8_plan,
    windowed_spmm_plan,
)

__all__ = [
    "bsr_spmm_int8",
    "bsr_spmm_int8_plan",
    "bsr_spmm_pallas",
    "bsr_spmm_pallas_plan",
    "bsr_spmm_pallas_int8_plan",
    "bsr_spmm_xla",
    "bsr_spmm_xla_plan",
    "CHUNK_NNZ_BYTES",
    "bcoo_spmm_plan",
    "csr_spmm",
    "csr_spmm_plan",
    "csr_spmm_pallas",
    "csr_spmm_pallas_plan",
    "csr_spmm_ell",
    "csr_spmm_ell_plan",
    "csr_spmm_ell_int8_plan",
    "csr_spmm_ell_banded_plan",
    "hybrid_spmm",
    "hybrid_spmm_plan",
    "hybrid_spmm_int8_plan",
    "windowed_spmm",
    "windowed_spmm_plan",
    "windowed_spmm_int8_plan",
    "tiered_spmm_plan",
    "dense_block_gemm",
    "sddmm",
    "sddmm_plan",
    "sddmm_block_plan",
    "count_nnzb_device",
    "csr_to_bsr_device",
    "csr_to_bsr_on_device",
    "PLANNERS",
    "spmm_plan",
    "Plan",
    "sum_plan",
    "grad_plan",
    "transb_plan",
    "CHECK_EPS",
    "assert_allclose",
    "spmm_dense_torch",
    "spmm_scipy",
]
