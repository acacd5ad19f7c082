from repro_torch.kernels.thomas.ops import (
    THOMAS_LAUNCHES,
    THOMAS_WIDE_LAUNCHES,
    thomas_cuda,
    thomas_cuda_wide,
)

__all__ = ["THOMAS_LAUNCHES", "THOMAS_WIDE_LAUNCHES", "thomas_cuda", "thomas_cuda_wide"]
