from repro_torch.kernels.partition_stage3.ops import (
    STAGE3_LAUNCHES,
    STAGE3_WIDE_LAUNCHES,
    partition_stage3_cuda,
    partition_stage3_cuda_batched,
    partition_stage3_cuda_wide,
)

__all__ = [
    "STAGE3_LAUNCHES",
    "STAGE3_WIDE_LAUNCHES",
    "partition_stage3_cuda",
    "partition_stage3_cuda_batched",
    "partition_stage3_cuda_wide",
]
