"""PyTorch port of spmm_denseblock_tpu for NVIDIA Hopper GPUs.

The JAX package ``spmm_denseblock_tpu`` is the reference; this package
mirrors its module paths and public names. Host-side layout work is
numpy, the sparse kernels are hand-written CUDA (``csrc/``), built with
nvcc at first use, never at import.
"""

from spmm_denseblock_tpu_torch.formats import BSR, CSR

__version__ = "0.1.0"

__all__ = ["CSR", "BSR"]
