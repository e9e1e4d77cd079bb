"""Architecture and input-shape configuration: the port's copy of
``repro.configs.base`` (a frozen :class:`ArchConfig` per architecture, a
:class:`ShapeConfig` per input shape), field for field, so a config built
here describes the same model as the reference's."""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    # attention options
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0      # chatglm: 0.5 (partial/2d rotary)
    sliding_window: Optional[int] = None
    mlp: str = "swiglu"             # swiglu | geglu | gelu
    tie_embeddings: bool = False
    # MoE
    num_experts: int = 0
    top_k: int = 1
    moe_every: int = 1              # MoE layer every k-th block
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # SSM / hybrid
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    attn_every: int = 0             # zamba2: shared attn block cadence
    # xLSTM
    xlstm: bool = False
    slstm_every: int = 0            # sLSTM at every k-th block
    # VLM
    cross_attn_every: int = 0
    num_patches: int = 0
    # audio
    num_codebooks: int = 0
    # long-context eligibility
    subquadratic: bool = False
    source: str = ""

    # ---- derived ------------------------------------------------------ #
    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def attn_dim(self) -> int:
        return self.num_heads * self.hd

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.hd

    @property
    def ssm_heads(self) -> int:
        """Mamba2 heads: d_inner = 2*d_model, head_dim = ssm_head_dim."""
        return (2 * self.d_model) // self.ssm_head_dim

    def is_moe_layer(self, i: int) -> bool:
        if self.num_experts == 0:
            return False
        return (i + 1) % self.moe_every == 0

    # ---- parameter counting (for 6ND MODEL_FLOPS) ---------------------- #
    def _mlp_params(self) -> int:
        gated = self.mlp in ("swiglu", "geglu")
        return (3 if gated else 2) * self.d_model * self.d_ff

    def _attn_params(self) -> int:
        return (self.d_model * self.attn_dim          # Q
                + 2 * self.d_model * self.kv_dim      # K, V
                + self.attn_dim * self.d_model)       # O

    def _mamba_params(self) -> int:
        d_in = 2 * self.d_model
        n, g = self.ssm_state, self.ssm_groups
        # in_proj: x, z branches + B, C, dt heads; out_proj
        return (self.d_model * (2 * d_in + 2 * g * n + self.ssm_heads)
                + d_in * self.d_model)

    def _xlstm_params(self) -> int:
        # mLSTM block: q,k,v,o + gates; approximate with 4*d^2 + 2*d*ff-less
        d = self.d_model
        return 4 * d * d + 3 * d * d // 4  # projections + gate projections

    def param_counts(self) -> Tuple[int, int]:
        """(total_params, active_params) excluding the input embedding
        gather (which contributes no matmul FLOPs)."""
        d, v = self.d_model, self.vocab_size
        total = active = 0
        for i in range(self.num_layers):
            if self.xlstm:
                p = self._xlstm_params()
            elif self.family in ("ssm", "hybrid") and not self._is_attn(i):
                p = self._mamba_params()
            else:
                p = self._attn_params()
                if (self.cross_attn_every and
                        (i + 1) % self.cross_attn_every == 0):
                    p += self._attn_params()  # extra cross-attn
            total += p
            active += p
            if self.xlstm:
                continue
            if self.family in ("ssm", "hybrid") and not self._is_attn(i):
                continue
            if self.is_moe_layer(i):
                total += self.num_experts * self._mlp_params()
                active += self.top_k * self._mlp_params()
                if self.shared_expert:
                    total += self._mlp_params()
                    active += self._mlp_params()
                total += d * self.num_experts      # router
                active += d * self.num_experts
            elif self.d_ff:
                total += self._mlp_params()
                active += self._mlp_params()
        # unembedding projection participates in matmul FLOPs
        total += d * v
        active += d * v
        return total, active

    def _is_attn(self, i: int) -> bool:
        """For hybrid (zamba2): True if block i is the shared attn block."""
        if self.family not in ("ssm", "hybrid"):
            return True
        if not self.attn_every:
            return False
        return (i + 1) % self.attn_every == 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def eligible(arch: ArchConfig, shape: ShapeConfig) -> bool:
    """long_500k requires sub-quadratic attention (the reference's
    ``eligible``)."""
    if shape.name == "long_500k":
        return arch.subquadratic
    return True
