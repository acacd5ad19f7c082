"""Zamba2-7B hybrid [arXiv:2411.15242] — Mamba2 trunk + shared attn block.

81 Mamba2 layers, d_model 3584, ssm_state 64; one weight-shared
transformer block (32H MHA, d_ff 14336) applied every 6 SSM layers on the
concatenation [hidden; embedding] (2d→d in-projection), per the Zamba design
(per-invocation LoRA omitted — DESIGN.md §Arch-applicability).
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="zamba2-7b",
        family="hybrid",
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        head_dim=112,
        d_ff=14_336,
        vocab_size=32_000,
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        shared_attn_every=6,
        norm_eps=1e-5,
    )
)
