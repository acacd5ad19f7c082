from repro_torch.kernels.tridiag_matvec.ops import MATVEC_LAUNCHES, tridiag_matvec_cuda

__all__ = ["MATVEC_LAUNCHES", "tridiag_matvec_cuda"]
