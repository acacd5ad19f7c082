from repro_torch.kernels.ssd_stage1.ops import (
    SSD_STAGE1_BWD_LAUNCHES,
    SSD_STAGE1_LAUNCHES,
    SSDStage1Function,
    ssd_scan_kernel,
    ssd_stage1_backward_cuda,
    ssd_stage1_cuda,
)

__all__ = [
    "SSD_STAGE1_BWD_LAUNCHES",
    "SSD_STAGE1_LAUNCHES",
    "SSDStage1Function",
    "ssd_scan_kernel",
    "ssd_stage1_backward_cuda",
    "ssd_stage1_cuda",
]
