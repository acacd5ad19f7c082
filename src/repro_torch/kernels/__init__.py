"""Hand-written CUDA kernels of the port and their PyTorch wrappers.

Each subpackage holds one wrapper (CPU tensors → its plain PyTorch version,
CUDA tensors → its kernel from ``repro_torch/csrc``, or an error) and the
launch counter it adds to where it launches. :data:`LAUNCH_COUNTERS` names
them all, so a run can zero them and read which kernels its main path used.
:func:`tridiag_matvec_cuda` is exported here, as ``repro.kernels`` exports
``tridiag_matvec_pallas``.
"""

from typing import Dict

from repro_torch.kernels.common import LaunchCounter
from repro_torch.kernels.partition_stage1.ops import STAGE1_LAUNCHES, STAGE1_WIDE_LAUNCHES
from repro_torch.kernels.partition_stage3.ops import STAGE3_LAUNCHES, STAGE3_WIDE_LAUNCHES
from repro_torch.kernels.ssd_stage1.ops import SSD_STAGE1_BWD_LAUNCHES, SSD_STAGE1_LAUNCHES
from repro_torch.kernels.thomas.ops import THOMAS_LAUNCHES, THOMAS_WIDE_LAUNCHES
from repro_torch.kernels.tridiag_matvec.ops import MATVEC_LAUNCHES, tridiag_matvec_cuda

LAUNCH_COUNTERS: Dict[str, LaunchCounter] = {
    c.name: c
    for c in (
        STAGE1_LAUNCHES,
        THOMAS_LAUNCHES,
        STAGE3_LAUNCHES,
        STAGE1_WIDE_LAUNCHES,
        THOMAS_WIDE_LAUNCHES,
        STAGE3_WIDE_LAUNCHES,
        SSD_STAGE1_LAUNCHES,
        SSD_STAGE1_BWD_LAUNCHES,
        MATVEC_LAUNCHES,
    )
}

__all__ = ["LAUNCH_COUNTERS", "tridiag_matvec_cuda"]
