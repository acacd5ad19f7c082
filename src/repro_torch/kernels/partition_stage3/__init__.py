from repro_torch.kernels.partition_stage3.ops import (
    STAGE3_LAUNCHES,
    partition_stage3_cuda,
    partition_stage3_cuda_batched,
)

__all__ = ["STAGE3_LAUNCHES", "partition_stage3_cuda", "partition_stage3_cuda_batched"]
