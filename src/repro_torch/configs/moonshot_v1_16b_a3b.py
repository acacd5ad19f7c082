"""Moonshot/Moonlight-16B-A3B MoE [hf:moonshotai/Moonlight-16B-A3B].

48L, d_model 2048, 16 heads (GQA kv=16 ⇒ MHA), per-expert d_ff 1408,
64 experts top-6 + 2 shared experts, vocab 163840.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="moonshot-v1-16b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,
        vocab_size=163_840,
        num_experts=64,
        experts_per_token=6,
        moe_d_ff=1408,
        num_shared_experts=2,
        rope_theta=50_000.0,
    )
)
