"""The port's sharded LM path for the encoder-decoder (whisper-medium) on
four ranks of a (data = 2, model = 2) mesh on the CPU: the vocab-split
tied embedding, the cross-attention's K/V from the encoder's output and
``dec_pos`` gathered over the FSDP axis; one train step against the port's
unsharded step and the reference's unsharded gradients."""

import torch_mesh_ref as mr


def test_sharded_step_matches_unsharded(tmp_path):
    mr.run_family(tmp_path, "whisper-medium", decode=False)


def test_sp_tp_step_and_decode_match_unsharded(tmp_path):
    """whisper-medium under ``sp_tp``: the encoder's and the decoder's
    residual streams split along their own lengths, LayerNorm's scale and
    bias through "f", the encoder's output gathered whole for the
    cross-attention; the train step and the greedy decode."""
    mr.run_family(tmp_path, "whisper-medium", decode=True, strategy="sp_tp")
