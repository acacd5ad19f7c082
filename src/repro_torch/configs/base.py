"""Architecture config schema for all assigned architectures.

One frozen dataclass covers the whole pool (dense / MoE / SSM / hybrid /
enc-dec / VLM-audio-frontend); family-specific fields are ignored by families
that don't use them. Exact published hyper-parameters live in
``src/repro_torch/configs/<arch>.py``; reduced smoke variants are derived via
``.smoke()``. A copy of ``repro.configs.base`` with only its imports changed:
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads

    # attention details
    rope_theta: float = 10_000.0
    qk_norm: bool = False
    attn_softcap: Optional[float] = None      # gemma2: 50.0
    final_softcap: Optional[float] = None     # gemma2: 30.0
    local_window: Optional[int] = None        # gemma2: 4096, alternating
    alternate_local_global: bool = False      # gemma2 pattern
    post_block_norm: bool = False             # gemma2 extra norms

    # MLP
    activation: str = "silu_gated"            # silu_gated | gelu_gated | sq_relu

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2 / SSD)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256                      # the paper-heuristic granularity knob

    # hybrid (zamba2): one weight-shared attention block every N ssm layers
    shared_attn_every: int = 0

    # enc-dec (whisper)
    is_encdec: bool = False
    enc_layers: int = 0
    dec_layers: int = 0

    # modality frontend stub (vlm/audio): number of precomputed embeddings
    frontend_tokens: int = 0

    # misc
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    emb_scale_by_sqrt_dim: bool = False       # gemma family
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------ api --
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_full_attention(self) -> bool:
        """True if ANY layer is unbounded-context attention (⇒ long_500k skip)."""
        if self.family == "ssm":
            return False
        return True  # hybrid keeps a shared full-attn block; see DESIGN.md

    @property
    def supports_long_context(self) -> bool:
        """long_500k cells run only for sub-quadratic memory archs."""
        return self.family in ("ssm", "hybrid")

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.resolved_head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)

        def attn_params() -> int:
            return d * hd * (self.num_heads + 2 * self.num_kv_heads) + (
                self.num_heads * hd * d
            )

        def dense_mlp(ff: int) -> int:
            gated = self.activation.endswith("_gated")
            return d * ff * (3 if gated else 2)

        def ssm_params() -> int:
            di, ns, nh = self.ssm_d_inner, self.ssm_state, self.ssm_heads
            in_proj = d * (2 * di + 2 * ns + nh)  # z, x, B, C, dt
            conv = (di + 2 * ns) * self.ssm_conv
            out = di * d + di  # out_proj + gated norm
            return in_proj + conv + out + 2 * nh  # + A, D per head

        per_layer = 0
        if self.family in ("dense", "vlm"):
            per_layer = attn_params() + dense_mlp(self.d_ff)
            total = self.num_layers * per_layer
        elif self.family == "moe":
            experts = self.num_experts * 3 * d * self.moe_d_ff
            shared = self.num_shared_experts * 3 * d * self.moe_d_ff
            router = d * self.num_experts
            total = self.num_layers * (attn_params() + experts + shared + router)
        elif self.family == "ssm":
            total = self.num_layers * ssm_params()
        elif self.family == "hybrid":
            n_shared_applications = (
                self.num_layers // self.shared_attn_every if self.shared_attn_every else 0
            )
            shared_block = 2 * d * d + attn_params() + dense_mlp(self.d_ff)
            total = self.num_layers * ssm_params() + shared_block
            del n_shared_applications
        elif self.family == "encdec":
            enc = self.enc_layers * (attn_params() + dense_mlp(self.d_ff))
            dec = self.dec_layers * (2 * attn_params() + dense_mlp(self.d_ff))
            total = enc + dec
        else:
            raise ValueError(self.family)
        return int(total + emb + d)  # + final norm

    def active_param_count(self) -> int:
        """MoE: params touched per token (for 6·N_active·D)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        hd = self.resolved_head_dim
        attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        active_ffn = (self.experts_per_token + self.num_shared_experts) * 3 * d * self.moe_d_ff
        router = d * self.num_experts
        return int(self.num_layers * (attn + active_ffn + router) + emb + d)

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        changes = dict(
            num_layers=max(2, min(4, self.num_layers)),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads else 0,
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            dtype="float32",
        )
        if self.family == "moe":
            changes.update(num_experts=8, experts_per_token=2, moe_d_ff=64)
        if self.family in ("ssm", "hybrid"):
            changes.update(
                ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
                num_layers=4 if self.family == "ssm" else 6,
            )
        if self.family == "hybrid":
            changes.update(shared_attn_every=3)
        if self.is_encdec:
            changes.update(enc_layers=2, dec_layers=2)
        if self.frontend_tokens:
            changes.update(frontend_tokens=16)
        if self.local_window is not None:
            changes.update(local_window=64)
        return dataclasses.replace(self, **changes)


# Registry populated by the per-arch modules importing ``register``.
_REGISTRY: dict = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.arch_id] = cfg
    return cfg


def get_config(arch_id: str) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (triggers per-arch registration)

    if arch_id not in _REGISTRY:
        raise KeyError(
            f"unknown arch '{arch_id}'; known: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[arch_id]


def list_archs() -> Tuple[str, ...]:
    import repro_torch.configs  # noqa: F401

    return tuple(sorted(_REGISTRY))
