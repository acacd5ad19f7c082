from repro_torch.kernels.partition_stage1.ops import (
    STAGE1_LAUNCHES,
    partition_stage1_cuda,
    partition_stage1_cuda_batched,
)

__all__ = ["STAGE1_LAUNCHES", "partition_stage1_cuda", "partition_stage1_cuda_batched"]
