"""InternVL2-2B [arXiv:2404.16821] — InternViT frontend (STUB) + InternLM2 LM.

LM backbone: 24L, d_model 2048, 16 heads (GQA kv=8), d_ff 8192, vocab 92553.
The ViT is a stub per the assignment: ``input_specs()`` supplies 256
precomputed patch embeddings prepended to the text sequence.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="internvl2-2b",
        family="vlm",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92_553,
        frontend_tokens=256,
        rope_theta=1_000_000.0,
    )
)
