"""Architecture configuration for the model zoo (a copy of the reference's).

One frozen dataclass covers all 10 assigned families (dense / MoE / SSM /
hybrid / enc-dec / VLM-stub / audio-stub).  Layers are grouped into
*cycles*: `block_pattern` is the sequence of block types inside one cycle
(e.g. jamba's ("attn", "mamba" x7)), and parameters for the repeated cycle
are stacked on a leading axis, and the forward pass loops over that axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    d_expert: int             # per-expert FFN hidden size
    every: int = 1            # MoE on layers where (layer_idx % every == rem)
    rem: int = 0
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                         # dense-MLP hidden (0 = no MLP block)
    vocab: int
    d_head: int = 0                   # 0 -> d_model // n_heads
    block_pattern: tuple = ("attn",)  # block types inside one cycle
    moe: Optional[MoESpec] = None
    qk_norm: bool = False
    swa_window: Optional[int] = None  # sliding-window attention
    rope_theta: float = 1e6
    enc_dec: bool = False
    n_enc_layers: int = 0
    n_enc_frames: int = 1500          # whisper encoder memory length
    frontend: Optional[str] = None    # "audio_stub" | "vision_stub"
    n_patches: int = 0                # vlm: image patch-embedding count
    # ssm/mamba/xlstm
    ssm_d_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    mamba_chunk: int = 128
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # training
    remat: bool = True
    remat_group: int = 1   # cycles per outer scan step (2-level remat):
                           # saved carries drop from n_cycles to
                           # n_cycles/remat_group at the cost of one extra
                           # inner forward during backward

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)
        assert self.n_layers % len(self.block_pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not a multiple of the "
            f"block pattern length {len(self.block_pattern)}")

    @property
    def n_cycles(self) -> int:
        return self.n_layers // len(self.block_pattern)

    @property
    def attention_is_subquadratic(self) -> bool:
        """True if long-context decode is feasible (SSM/hybrid/SWA)."""
        kinds = set(self.block_pattern)
        if kinds <= {"mamba", "mlstm", "slstm"}:
            return True
        if "attn" in kinds and self.swa_window is not None:
            return True
        # hybrid: a few attn layers with seq-sharded KV is acceptable
        if "mamba" in kinds and "attn" in kinds:
            return True
        return False

    def layer_block_type(self, layer_idx: int) -> str:
        return self.block_pattern[layer_idx % len(self.block_pattern)]

    def layer_is_moe(self, layer_idx: int) -> bool:
        return (self.moe is not None
                and layer_idx % self.moe.every == self.moe.rem)

    def scaled(self, **overrides) -> "ArchConfig":
        """Reduced copy for CPU smoke tests."""
        return dataclasses.replace(self, **overrides)

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks)."""
        d, hd = self.d_model, self.d_head
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            bt = self.layer_block_type(i)
            if bt == "attn":
                total += d * hd * (self.n_heads + 2 * self.n_kv_heads)
                total += self.n_heads * hd * d
            elif bt == "mamba":
                d_in = self.ssm_expand * d
                total += d * 2 * d_in + d_in * self.ssm_conv
                total += d_in * (2 * self.ssm_d_state + 1) + d_in * self.ssm_d_state
                total += d_in * d
            elif bt == "mlstm":
                d_in = self.ssm_expand * d
                total += d * 2 * d_in + 3 * d_in * hd * 0  # gates folded below
                total += 4 * d_in * d_in // max(self.n_heads, 1) * 0
                total += 3 * d_in * d_in + 3 * d_in + d_in * d
            elif bt == "slstm":
                total += 4 * d * d + 4 * d * d // max(self.n_heads, 1)
                total += (4 * d // 3) * d * 2
            if self.layer_is_moe(i):
                total += d * self.moe.n_experts  # router
                total += self.moe.n_experts * 3 * d * self.moe.d_expert
            elif self.d_ff and bt in ("attn", "mamba"):
                total += 3 * d * self.d_ff
        if self.enc_dec:
            for _ in range(self.n_enc_layers):
                total += 4 * d * hd * self.n_heads + 3 * d * self.d_ff
                total += 4 * d * hd * self.n_heads  # cross attention
        return total


ARCH_REGISTRY: dict = {}


def register_arch(cfg: ArchConfig) -> ArchConfig:
    ARCH_REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if name not in ARCH_REGISTRY:
        # populate the registry lazily
        from ..configs import LM_CONFIGS  # noqa: F401
    return ARCH_REGISTRY[name]
