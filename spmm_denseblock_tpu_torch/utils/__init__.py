from spmm_denseblock_tpu_torch.utils.profiling import (
    annotate,
    device_info,
    roofline,
    trace,
)

__all__ = ["trace", "annotate", "device_info", "roofline"]
