"""Architecture configuration for the model zoo (port of ``repro.models.config``).

One ArchConfig fully determines a model: family dispatch, layer pattern,
attention variant, MoE/SSM hyperparameters and the group pattern the layers
repeat in. ``reduced()`` produces the tiny same-family config used by CPU
smoke tests. This is the reference's dataclass whole (fields, properties,
``param_count``, ``active_param_count``, ``reduced``), so a config built from
``dataclasses.asdict`` of a reference config is the same config; the port
builds models of the dense and MoE families (``registry`` says what waits).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "hybrid", "ssm", "encdec"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: Family = "dense"

    # transformer backbone
    num_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 512
    vocab_size: int = 1024
    # pad embedding/head tables so the vocab dim divides the model axis
    # (1 = off). Padded logit columns are masked to -inf in _unembed.
    vocab_pad_multiple: int = 1
    act: Literal["swiglu", "geglu", "gelu"] = "swiglu"
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # rope
    rope: Literal["full", "partial", "mrope", "none"] = "full"
    rope_theta: float = 10000.0
    rope_partial_frac: float = 1.0      # chatglm3 "2d RoPE": 0.5
    mrope_sections: tuple = (16, 24, 24)  # qwen2-vl t/h/w frequency split

    # attention variants
    sliding_window: int = 0             # 0 = full attention
    alt_local_global: bool = False      # gemma2: even layers local, odd global
    attn_softcap: float = 0.0           # gemma2: 50.0
    final_softcap: float = 0.0          # gemma2: 30.0
    query_scale: float | None = None    # None -> head_dim**-0.5
    post_block_norms: bool = False      # gemma2 sandwich norms
    scale_embeddings: bool = False      # gemma2: x *= sqrt(d_model)

    # MoE
    num_experts: int = 0                # 0 = dense MLP
    top_k: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1                  # jamba: MoE on every 2nd layer
    # None => dropless (C = T; exact, used by tests/serving-eval);
    # float => GShard-style capacity with position-priority dropping
    moe_capacity_factor: float | None = 1.25

    # SSM (mamba2 SSD)
    d_inner: int = 0                    # 0 -> 2*d_model when family uses SSM
    ssm_state: int = 128
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128
    hybrid_attn_period: int = 0         # jamba: 1 attn layer per 8

    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0
    input_kind: Literal["tokens", "frames"] = "tokens"  # frames: audio/vision stub

    # paper's technique: photonic-offload projections
    psram_projections: bool = False
    # store projection weights as int8 words + per-column scales (weights
    # stationary in the array, as in the paper) — halves weight HBM bytes
    psram_stored_int8: bool = False
    adc_bits: int = 16

    # execution
    attention_impl: Literal["einsum", "chunked"] = "einsum"
    # keep softmax weights in bf16 after the f32 max/sum reductions
    # (flash-attention numerics; halves logit-sized HBM traffic)
    attn_probs_bf16: bool = False
    attn_chunk: int = 512               # q-chunk for chunked attention
    scan_layers: bool = True
    remat: bool = False
    remat_policy: str = "dots"  # "dots" | "nothing" (full recompute)
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    @property
    def group_size(self) -> int:
        """Layers per scanned group (the repeating pattern unit)."""
        if self.family == "hybrid" and self.hybrid_attn_period:
            return self.hybrid_attn_period
        if self.alt_local_global:
            return 2
        return 1

    @property
    def num_groups(self) -> int:
        n = self.enc_layers or self.num_layers if self.family == "encdec" else self.num_layers
        assert n % self.group_size == 0, (self.name, n, self.group_size)
        return n // self.group_size

    @property
    def d_inner_resolved(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner_resolved // self.ssm_headdim

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m if m > 1 else self.vocab_size

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count N (embedding included once)."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        n_ffn_mats = 3 if self.act in ("swiglu", "geglu") else 2

        def attn_params():
            return d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d

        def mlp_params(width):
            return n_ffn_mats * d * width

        def moe_params():
            return (
                self.num_experts * mlp_params(self.d_ff_expert or ff)
                + d * self.num_experts  # router
            )

        def ssm_params():
            di, ns = self.d_inner_resolved, self.ssm_state
            in_proj = d * (2 * di + 2 * ns + self.ssm_heads)
            conv = (di + 2 * ns) * self.ssm_conv
            out = di * d
            extras = 3 * self.ssm_heads  # A, D, dt_bias
            return in_proj + conv + out + extras

        total = 0
        if self.family == "encdec":
            enc = self.enc_layers * (attn_params() + mlp_params(ff) + 2 * d)
            dec = self.dec_layers * (2 * attn_params() + mlp_params(ff) + 3 * d)
            total = enc + dec
        else:
            for i in range(self.num_layers):
                is_attn = True
                if self.family == "ssm":
                    is_attn = False
                elif self.family == "hybrid" and self.hybrid_attn_period:
                    is_attn = (i % self.hybrid_attn_period) == self.hybrid_attn_period // 2
                total += attn_params() if is_attn else ssm_params()
                if self.num_experts and (i % self.moe_every == self.moe_every - 1):
                    total += moe_params()
                else:
                    total += mlp_params(ff)
                total += 2 * d  # norms
        total += v * d * (1 if self.tie_embeddings else 2)
        return total

    def active_param_count(self) -> int:
        """N_active for MoE rooflines: only top_k experts count."""
        if not self.num_experts:
            return self.param_count()
        full = self.param_count()
        n_ffn_mats = 3 if self.act in ("swiglu", "geglu") else 2
        per_expert = n_ffn_mats * self.d_model * (self.d_ff_expert or self.d_ff)
        n_moe_layers = len(
            [i for i in range(self.num_layers) if i % self.moe_every == self.moe_every - 1]
        )
        inactive = n_moe_layers * (self.num_experts - self.top_k) * per_expert
        return full - inactive

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        g = self.group_size
        return dataclasses.replace(
            self,
            num_layers=2 * g,
            d_model=64,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            d_ff_expert=32 if self.num_experts else 0,
            vocab_size=256,
            num_experts=min(self.num_experts, 4),
            top_k=min(self.top_k, 2),
            moe_capacity_factor=None,  # dropless: exact decode==forward

            d_inner=128,
            ssm_state=16,
            ssm_headdim=32,
            ssm_chunk=8,
            enc_layers=2 if self.enc_layers else 0,
            dec_layers=2 if self.dec_layers else 0,
            sliding_window=8 if self.sliding_window else 0,
            mrope_sections=(4, 6, 6) if self.rope == "mrope" else self.mrope_sections,
            attn_chunk=16,
            dtype="float32",
        )
