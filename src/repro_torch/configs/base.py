"""ArchConfig: one declarative description per architecture. All 10 assigned
architectures + the paper's own MLP are instances; models/ and launch/ consume
nothing but this."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # "train" | "prefill" | "decode"


#: The assigned input-shape set (LM family; seq_len x global_batch).
LM_SHAPES = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense|moe|ssm|hybrid|audio|vlm|mlp
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // n_heads
    # ffn / activation
    mlp_variant: str = "swiglu"   # swiglu|geglu|relu2|mlp
    act: str = "gelu"             # for ungated variants
    norm: str = "rmsnorm"
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    mrope_sections: Optional[tuple] = None   # qwen2-vl M-RoPE
    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # layer pattern: per-period slot kinds; n_layers % len(pattern) == 0.
    # slots: "attn+dense" | "attn+moe" | "attn" (no ffn) | "mamba+dense" |
    #        "mamba+moe" | "mamba" | "mlstm" | "slstm+dense" | "xdec+dense"
    pattern: tuple = ("attn+dense",)
    # ssm hyperparams
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0          # 0 -> d_model//16
    lstm_heads: int = 4
    # encoder-decoder (whisper)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_seq_len: int = 1500       # stub frontend output length
    # modality frontend stub: None | "audio" | "vision"
    frontend: Optional[str] = None
    # capabilities
    source: str = ""

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k: no full-attention prefill dependence —
        SSM/hybrid families only (DESIGN.md §5)."""
        return self.family in ("ssm", "hybrid")

    @property
    def n_periods(self) -> int:
        assert self.n_layers % len(self.pattern) == 0, \
            (self.name, self.n_layers, self.pattern)
        return self.n_layers // len(self.pattern)

    def shapes(self):
        """The assigned shape cells for this arch, with skip reasons."""
        out = []
        for s in LM_SHAPES:
            if s.name == "long_500k" and not self.subquadratic:
                out.append((s, "skipped(full-attention)"))
            else:
                out.append((s, None))
        return out

    def param_count_estimate(self) -> int:
        """Analytic parameter count (embedding + per-layer), for 6ND."""
        d, dh = self.d_model, self.dh
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        total = emb
        per_period = 0
        for slot in self.pattern:
            mixer = slot.split("+")[0]
            ffn = slot.split("+")[1] if "+" in slot else None
            if mixer in ("attn", "xdec"):
                qo = d * self.n_heads * dh * 2
                kv = d * self.n_kv_heads * dh * 2
                per_period += qo + kv
                if mixer == "xdec":
                    per_period += qo + kv          # cross-attention
            elif mixer == "mamba":
                di = self.ssm_expand * d
                dtr = self.ssm_dt_rank or max(16, d // 16)
                per_period += (d * 2 * di + di * (dtr + 2 * self.ssm_d_state)
                               + dtr * di + di * self.ssm_d_state + di
                               + di * d)
            elif mixer == "mlstm":
                di = self.ssm_expand * d
                per_period += d * 2 * di + 3 * di * di + di * d
            elif mixer == "slstm":
                per_period += d * 4 * d + 4 * d * (d // self.lstm_heads) \
                    + d * d
            if ffn == "dense":
                n_mat = 3 if self.mlp_variant in ("swiglu", "geglu") else 2
                d_ff = self.d_ff or ((4 * d // 3 + 127) // 128 * 128)
                per_period += n_mat * d * d_ff
            elif ffn == "moe":
                n_mat = 3
                per_period += (self.n_experts + self.n_shared_experts) \
                    * n_mat * d * self.d_ff + d * self.n_experts
        total += per_period * self.n_periods
        if self.enc_dec:
            enc_per = (d * self.n_heads * dh * 2 + d * self.n_kv_heads * dh * 2
                       + 2 * d * self.d_ff)
            total += enc_per * self.n_enc_layers
        return total

    def active_param_count_estimate(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.param_count_estimate()
        full = self.param_count_estimate()
        n_mat = 3
        d = self.d_model
        moe_slots = sum(1 for s in self.pattern if s.endswith("+moe"))
        expert_params_total = (self.n_experts * n_mat * d * self.d_ff
                               * moe_slots * self.n_periods)
        active_expert = (self.top_k * n_mat * d * self.d_ff
                         * moe_slots * self.n_periods)
        return full - expert_params_total + active_expert
