"""Serving: the LM step builders, and the solver's serving names from the
session layer with the deprecated ``BatchedSolveService`` and
``make_batched_solve_step`` (:mod:`repro_torch.serve.solve`), as
``repro.serve`` has them side by side."""

from repro_torch.serve.solve import (
    AdmissionPolicy,
    BatchedSolveService,
    SolveEngine,
    SolveRequest,
    make_batched_solve_step,
)
from repro_torch.serve.steps import make_decode_step, make_prefill_step

__all__ = [
    "make_decode_step",
    "make_prefill_step",
    "AdmissionPolicy",
    "BatchedSolveService",
    "SolveEngine",
    "SolveRequest",
    "make_batched_solve_step",
]
