"""PyTorch/CUDA port of the tridiagonal partition-method solver.

A second package beside the JAX reference ``repro``: the same front door
(``repro_torch.api.SolverConfig`` → ``TridiagSession``), the same plans and
fitted stream heuristic, with the three partition-stage kernels written by
hand in CUDA C++ for Hopper (``repro_torch/csrc``). It imports ``torch`` and
``numpy`` and nothing of ``jax`` or ``repro``.

Entry points run on the CUDA device unless the caller asks for the CPU
(``SolverConfig(device="cpu")``), where every kernel wrapper runs its plain
PyTorch version instead.
"""

__version__ = "0.1.0"
