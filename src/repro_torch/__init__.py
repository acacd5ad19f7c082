"""PyTorch/CUDA port of the tridiagonal partition-method solver.

A second package beside the JAX reference ``repro``: the same front door
(``repro_torch.api.SolverConfig`` → ``TridiagSession``), the same plans and
fitted stream heuristic, with the partition-stage kernels written by hand in
CUDA C++ for Hopper (``repro_torch/csrc``); and the LM stack's ``ssm``
family served through ``repro_torch.launch.serve``, with the SSD intra-chunk
stage as a hand-written kernel too. It imports ``torch`` and ``numpy`` and
nothing of ``jax`` or ``repro``.

Entry points run on the CUDA device unless the caller asks for the CPU
(``SolverConfig(device="cpu")``, ``serve(device="cpu")``), where every
kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"
