from repro_torch.kernels.partition_stage1.ops import (
    STAGE1_LAUNCHES,
    STAGE1_WIDE_LAUNCHES,
    partition_stage1_cuda,
    partition_stage1_cuda_batched,
    partition_stage1_cuda_wide,
)

__all__ = [
    "STAGE1_LAUNCHES",
    "STAGE1_WIDE_LAUNCHES",
    "partition_stage1_cuda",
    "partition_stage1_cuda_batched",
    "partition_stage1_cuda_wide",
]
