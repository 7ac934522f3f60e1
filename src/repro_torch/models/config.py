"""Architecture configuration schema (port of ``repro/models/config.py``;
a copy, so the port imports nothing of the JAX package).

One frozen dataclass drives every model. The port serves the dense GQA,
MoE, SSM (mamba2), hybrid (hymba) and encoder-decoder (whisper)
families.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int              # routed experts
    top_k: int
    n_shared: int = 0           # always-on shared experts
    d_ff_expert: int = 0        # per-expert hidden size
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # token->expert dispatch: "einsum" (one-hot (T,E,C) tensors, the
    # classic Switch formulation) or "sort" (argsort + scatter, no
    # T x E x C intermediates - see EXPERIMENTS.md §Perf)
    dispatch: str = "einsum"


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    n_groups: int = 1
    chunk: int = 128
    # d_inner = expand * d_model; n_heads_ssm = d_inner // head_dim
    # cross-device chunk-state exchange under context parallelism:
    # "gather" (all_gather of every device's (decay, state) summary) or
    # "ladder" (Hillis-Steele prefix scan via ppermute: (log2(n)+1)/n of
    # the gather bytes - see EXPERIMENTS.md §Perf)
    cp_exchange: str = "gather"
    # wire dtype for the cross-device state exchange ("float32"/"bfloat16")
    cp_wire_dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str              # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # attention features
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None     # gemma2: 50.0
    final_softcap: Optional[float] = None    # gemma2: 30.0
    qk_norm: bool = False                    # gemma3
    rope_theta: float = 10_000.0
    rope_theta_local: Optional[float] = None  # gemma3: local layers 10k, global 1M
    window: Optional[int] = None             # sliding window for "local" layers
    # per-layer attention pattern: string of 'g' (global) / 'l' (local),
    # tiled to n_layers. None -> all global.
    pattern: Optional[str] = None
    post_norm: bool = False                  # gemma2/3 post-sublayer norms

    # sub-modules
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    meta_tokens: int = 0                     # hymba learnable prefix

    # enc-dec (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0                     # audio frames after conv stub
    # how inputs arrive: tokens | embeddings (vlm) | audio+tokens (whisper)
    input_mode: str = "tokens"

    tie_embeddings: bool = True
    emb_scale: bool = False                  # gemma: embed * sqrt(d)
    act: str = "silu"                        # "gelu": whisper (non-gated)
    norm: str = "rmsnorm"                    # "layernorm": whisper
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    # full-unroll the layer scans (dry-run cost-analysis calibration only:
    # XLA cost analysis counts a while body once, unrolled HLO counts all)
    scan_unroll: bool = False
    # layer remat policy: "full" (recompute everything), "dots" (save
    # matmul outputs - trades HBM for recompute FLOPs), "ssd_state" (save
    # the cross-device SSD prefix states - skips the ladder replay in bwd)
    remat_policy: str = "full"

    # ---- derived ----
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k: no layer does full-attention over the
        whole sequence, or attention-free."""
        if self.arch_type == "ssm":
            return True
        if self.pattern is not None and self.window is not None:
            # global layers still attend fully; eligibility requires their
            # KV to be shardable (it is, over the model axis) AND few of
            # them. We follow the brief: SWA archs are eligible.
            return True
        return False

    def layer_windows(self) -> Tuple[int, ...]:
        """Per-layer window size; 0 means full/global attention."""
        if self.pattern is None or self.window is None:
            return tuple(0 for _ in range(self.n_layers))
        pat = (self.pattern * self.n_layers)[: self.n_layers]
        return tuple(self.window if c == "l" else 0 for c in pat)

    def layer_rope_thetas(self) -> Tuple[float, ...]:
        if self.rope_theta_local is None:
            return tuple(self.rope_theta for _ in range(self.n_layers))
        pat = ((self.pattern or "g") * self.n_layers)[: self.n_layers]
        return tuple(self.rope_theta_local if c == "l" else self.rope_theta
                     for c in pat)

    @property
    def d_inner(self) -> int:
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        assert self.ssm is not None
        return self.d_inner // self.ssm.head_dim

    def n_params(self) -> int:
        """Analytic parameter count (for 6ND roofline math)."""
        d, f, V, L = self.d_model, self.d_ff, self.vocab_size, self.n_layers
        hd = self.head_dim_
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        total = V * d  # embeddings (tied head)
        if not self.tie_embeddings:
            total += V * d
        if self.arch_type == "ssm":
            s = self.ssm
            di = self.d_inner
            conv_dim = di + 2 * s.n_groups * s.d_state
            per = (d * (2 * di + 2 * s.n_groups * s.d_state + self.n_ssm_heads)
                   + s.d_conv * conv_dim + di * d + di + 3 * self.n_ssm_heads)
            return total + L * per
        mlp = 3 * d * f if self.act != "gelu" else 2 * d * f
        per = attn + d * 2  # norms
        if self.moe is not None:
            fe = self.moe.d_ff_expert or f
            per += d * self.moe.n_experts
            per += 3 * d * fe * (self.moe.n_experts + self.moe.n_shared)
        else:
            per += mlp
        if self.arch_type == "hybrid":
            s = self.ssm
            di = self.d_inner
            conv_dim = di + 2 * s.n_groups * s.d_state
            per += (d * (2 * di + 2 * s.n_groups * s.d_state + self.n_ssm_heads)
                    + s.d_conv * conv_dim + di * d + di + 3 * self.n_ssm_heads)
        total += L * per
        if self.arch_type == "encdec":
            enc_per = attn + mlp + d * 2
            cross = attn
            total += self.encoder_layers * enc_per + L * cross
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        fe = self.moe.d_ff_expert or self.d_ff
        all_experts = 3 * d * fe * (self.moe.n_experts + self.moe.n_shared)
        active = 3 * d * fe * (self.moe.top_k + self.moe.n_shared)
        return self.n_params() - L * (all_experts - active)
