from repro_torch.kernels.ssd_stage1.ops import SSD_STAGE1_LAUNCHES, ssd_scan_kernel, ssd_stage1_cuda

__all__ = ["SSD_STAGE1_LAUNCHES", "ssd_scan_kernel", "ssd_stage1_cuda"]
