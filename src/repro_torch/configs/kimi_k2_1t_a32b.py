"""Kimi K2 — trillion-param MoE [arXiv:2501.kimi2; paper-table].

61L, d_model 7168, 64 q heads (GQA kv=8; MLA in the original — GQA stand-in
per the assignment), per-expert d_ff 2048, 384 experts top-8 + 1 shared
expert, vocab 163840.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="kimi-k2-1t-a32b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=2048,
        vocab_size=163_840,
        num_experts=384,
        experts_per_token=8,
        moe_d_ff=2048,
        num_shared_experts=1,
        rope_theta=50_000.0,
    )
)
