"""Nemotron-4-340B [arXiv:2402.16819] — dense, squared-ReLU MLP.

96L, d_model 18432, 96 heads (GQA kv=8), d_ff 73728 (squared-ReLU, ungated),
vocab 256000.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="nemotron-4-340b",
        family="dense",
        num_layers=96,
        d_model=18_432,
        num_heads=96,
        num_kv_heads=8,
        head_dim=192,
        d_ff=73_728,
        vocab_size=256_000,
        activation="sq_relu",
        norm_eps=1e-5,
    )
)
