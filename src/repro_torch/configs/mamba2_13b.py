"""Mamba2-1.3B [arXiv:2405.21060] — attention-free SSD (state-space duality).

48L, d_model 2048, ssm_state 128, head_dim 64, expand 2, vocab 50280.
The SSD chunked scan is implemented in the partition-method 3-stage form
(DESIGN.md §2.4); ``ssm_chunk`` is the paper-heuristic granularity knob.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="mamba2-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50_280,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=256,
        norm_eps=1e-5,
        tie_embeddings=True,
    )
)
