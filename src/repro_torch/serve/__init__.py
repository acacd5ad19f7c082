"""Serving: the LM step builders, and the solver's serving names from the
session layer, as ``repro.serve`` has them side by side.

The reference's deprecated ``BatchedSolveService`` and
``make_batched_solve_step`` are not ported (ROADMAP, Queue 1).
"""

from repro_torch.core.tridiag.api import AdmissionPolicy, SolveEngine, SolveRequest
from repro_torch.serve.steps import make_decode_step, make_prefill_step

__all__ = [
    "make_decode_step",
    "make_prefill_step",
    "AdmissionPolicy",
    "SolveEngine",
    "SolveRequest",
]
