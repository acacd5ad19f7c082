"""The port's sharded LM path for the encoder-decoder (whisper-medium) on
four ranks of a (data = 2, model = 2) mesh on the CPU: the vocab-split
tied embedding, the cross-attention's K/V from the encoder's output and
``dec_pos`` gathered over the FSDP axis; one train step against the port's
unsharded step and the reference's unsharded gradients."""

import torch_mesh_ref as mr


def test_sharded_step_matches_unsharded(tmp_path):
    mr.run_family(tmp_path, "whisper-medium", decode=False)
