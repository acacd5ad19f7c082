from repro_torch.kernels.thomas.ops import THOMAS_LAUNCHES, thomas_cuda

__all__ = ["THOMAS_LAUNCHES", "thomas_cuda"]
