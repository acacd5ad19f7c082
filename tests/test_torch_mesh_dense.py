"""The port's sharded LM path for the attention families (qwen3-4b,
gemma2-27b, internvl2-2b), on four ranks of a (data = 2, model = 2) mesh
on the CPU: one train step against the port's unsharded step and the
reference's unsharded gradients, and qwen3-4b's greedy decode against
both (``torch_mesh_ref`` states the tolerances)."""

import pytest

import torch_mesh_ref as mr


@pytest.mark.parametrize("arch,decode", [("qwen3-4b", True), ("gemma2-27b", False),
                                         ("internvl2-2b", False)])
def test_sharded_step_matches_unsharded(tmp_path, arch, decode):
    mr.run_family(tmp_path, arch, decode=decode)
