"""Gemma2-27B [arXiv:2408.00118] — dense with local/global alternation.

46L, d_model 4608, 32 q heads (GQA kv=16), head_dim 128, d_ff 36864 (GeGLU),
vocab 256000; alternating 4096-window local / global attention; attention
logit softcap 50, final logit softcap 30; pre+post block RMSNorm; embeddings
scaled by sqrt(d_model).
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="gemma2-27b",
        family="dense",
        num_layers=46,
        d_model=4608,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        d_ff=36_864,
        vocab_size=256_000,
        activation="gelu_gated",
        attn_softcap=50.0,
        final_softcap=30.0,
        local_window=4096,
        alternate_local_global=True,
        post_block_norm=True,
        tie_embeddings=True,
        emb_scale_by_sqrt_dim=True,
    )
)
