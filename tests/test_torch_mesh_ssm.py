"""The port's sharded LM path for the SSM families (mamba2-1.3b,
zamba2-7b), on four ranks of a (data = 2, model = 2) mesh on the CPU: the
SSD stages on each rank's H/tp heads, the gated norm over the whole
d_inner, the shared B/C projections' whole gradients; one train step and
the greedy decode against the port's unsharded path and the reference's
unsharded functions (``torch_mesh_ref`` states the tolerances)."""

import pytest

import torch_mesh_ref as mr


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-7b"])
def test_sharded_step_and_decode_match_unsharded(tmp_path, arch):
    mr.run_family(tmp_path, arch, decode=True)


@pytest.mark.parametrize("layers", [6, 7], ids=["no-tail", "tail"])
def test_sp_tp_hybrid_step_and_decode_match_unsharded(tmp_path, layers):
    """zamba2-7b under ``sp_tp``: the residual stream, the embedding and the
    shared block's [x; x0] split along the sequence, gathered whole before
    ``w_in``; with 7 layers the tail layer runs too."""
    mr.run_family(tmp_path, "zamba2-7b", decode=True, strategy="sp_tp",
                  changes={"num_layers": layers})
