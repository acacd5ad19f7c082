"""Qwen3-4B [hf:Qwen/Qwen3-8B family] — dense with qk-norm GQA.

36L, d_model 2560, 32 heads (GQA kv=8), head_dim 128, d_ff 9728,
vocab 151936, RMSNorm on q/k heads, tied embeddings.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="qwen3-4b",
        family="dense",
        num_layers=36,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=9728,
        vocab_size=151_936,
        qk_norm=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
    )
)
