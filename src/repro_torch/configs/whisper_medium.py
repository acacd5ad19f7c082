"""Whisper-medium [arXiv:2212.04356] — enc-dec audio backbone.

24 encoder + 24 decoder layers, d_model 1024, 16 heads (MHA), d_ff 4096,
vocab 51865. The conv audio frontend is a STUB per the assignment:
``input_specs()`` supplies precomputed frame embeddings.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="whisper-medium",
        family="encdec",
        num_layers=48,  # 24 enc + 24 dec
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=51_865,
        is_encdec=True,
        enc_layers=24,
        dec_layers=24,
        activation="gelu",
        frontend_tokens=1500,  # whisper 30 s → 1500 frames; stub embeddings
        tie_embeddings=True,   # whisper ties decoder embed/unembed
        norm_eps=1e-5,
    )
)
