"""CodeQwen1.5-7B [hf:Qwen/CodeQwen1.5-7B] — dense decoder (qwen1.5 arch).

32L, d_model 4096, 32 heads MHA (kv=32), d_ff 13440, vocab 92416.
"""

from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        arch_id="codeqwen1.5-7b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        head_dim=128,
        d_ff=13_440,
        vocab_size=92_416,
        rope_theta=1_000_000.0,
    )
)
