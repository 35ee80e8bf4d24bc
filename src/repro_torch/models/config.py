"""Architecture configuration schema for the model zoo.

One dataclass covers all ten assigned architectures; family-specific
features (GQA geometry, qk-norm, QKV bias, MoE, Mamba, M-RoPE, encoder vs
decoder) are flags/sub-configs. Exact per-arch values live in
``src/repro/configs/<id>.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_routed: int                 # routed experts
    top_k: int
    d_ff_expert: int
    n_shared: int = 0             # shared (always-on) experts
    # which layers are MoE: every `freq`-th layer, starting at `first`
    freq: int = 1
    first: int = 0                # deepseek-moe: layer 0 stays dense
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # grouped dispatch (§Perf cell B): sort/scatter within per-sample
    # groups (vmapped over batch) instead of one global token sort, so
    # dispatch collectives reduce to the expert-parallel all-to-all
    grouped_dispatch: bool = False
    min_group_tokens: int = 256   # fall back to global sort below this


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 -> ceil(d_model / 16)
    chunk: int = 128              # chunked selective-scan length


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | hybrid | audio | vlm | ssm
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int                  # 0 for attention-free archs
    n_kv_heads: int = 0
    head_dim: int = 0             # 0 -> d_model // n_heads
    d_ff: int = 0                 # dense FFN hidden (0 for pure-MoE FFNs)
    qkv_bias: bool = False
    qk_norm: bool = False
    causal: bool = True           # False -> encoder-only (hubert)
    tie_embeddings: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    # hybrid interleave: within each group of `hybrid_group` layers, the
    # layer at index `attn_index` is attention, the rest are mamba
    # (jamba: 1 attention per 8 layers)
    hybrid_group: int = 0
    attn_index: int = 0
    # M-RoPE (qwen2-vl): per-axis (t, h, w) rotary sections over head_dim/2
    mrope_sections: Optional[Tuple[int, int, int]] = None
    # modality frontend stub: input embeddings dimensionality (audio/vlm)
    frontend_dim: int = 0
    max_vision_tokens: int = 0    # vlm: image patch embeddings per sample
    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    opt_dtype: str = "float32"
    # attention chunking (flash-semantics) for long sequences
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    # serving geometry
    kv_block_tokens: int = 64
    # paged-KV pool layout: "global" (one flat block pool, vLLM-style,
    # baseline) or "per_seq" (pool factored (B, blocks_per_seq, ...) so the
    # block-table gather is batch-aligned and shard-local -- the per-host
    # pool layout used on TPU serving; see EXPERIMENTS.md §Perf cell A)
    kv_pool_layout: str = "global"

    # ------------------------------------------------------------- derived
    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // max(1, self.n_heads))

    @property
    def dt_rank_(self) -> int:
        if self.mamba is None:
            return 0
        return self.mamba.dt_rank or -(-self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return 0 if self.mamba is None else self.mamba.expand * self.d_model

    def is_attn_layer(self, layer: int) -> bool:
        if self.family == "ssm":
            return False
        if self.hybrid_group:
            return layer % self.hybrid_group == self.attn_index
        return True

    def is_moe_layer(self, layer: int) -> bool:
        if self.moe is None:
            return False
        m = self.moe
        return layer >= m.first and (layer - m.first) % m.freq == 0

    def validate(self) -> None:
        assert self.family in ("dense", "moe", "hybrid", "audio", "vlm", "ssm")
        if self.family == "ssm":
            assert self.mamba is not None and self.n_heads == 0
        if self.family == "hybrid":
            assert self.hybrid_group > 0 and self.mamba is not None
        if self.family in ("dense", "moe", "audio", "vlm"):
            assert self.n_heads > 0
        if self.n_heads:
            assert self.n_kv_heads > 0
            assert self.n_heads % self.n_kv_heads == 0

    # parameter count (for 6ND model-FLOPs in the roofline)
    def param_count(self) -> int:
        D, V = self.d_model, self.vocab
        hd = self.head_dim_
        n = V * D                              # embedding
        if not self.tie_embeddings:
            n += D * V                         # lm head
        for l in range(self.n_layers):
            n += 2 * D                         # norms
            if self.is_attn_layer(l) and self.n_heads:
                q = D * self.n_heads * hd
                kv = 2 * D * self.n_kv_heads * hd
                o = self.n_heads * hd * D
                n += q + kv + o
                if self.qkv_bias:
                    n += (self.n_heads + 2 * self.n_kv_heads) * hd
                if self.qk_norm:
                    n += 2 * hd
            elif self.mamba is not None:
                di, s = self.d_inner, self.mamba.d_state
                dtr = self.dt_rank_
                n += D * 2 * di                # in_proj
                n += self.mamba.d_conv * di + di   # conv + bias
                n += di * (dtr + 2 * s)        # x_proj
                n += dtr * di + di             # dt_proj + bias
                n += di * s + di               # A_log + D
                n += di * D                    # out_proj
            if self.is_moe_layer(l):
                m = self.moe
                n += D * m.n_routed            # router
                n += m.n_routed * 3 * D * m.d_ff_expert
                n += m.n_shared * 3 * D * m.d_ff_expert
            elif self.d_ff:
                n += 3 * D * self.d_ff         # swiglu mlp
        if self.frontend_dim:
            n += self.frontend_dim * D         # frontend projection stub
        return n

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        total = self.param_count()
        n_moe_layers = sum(self.is_moe_layer(l) for l in range(self.n_layers))
        inactive = n_moe_layers * (m.n_routed - m.top_k) * 3 * self.d_model * m.d_ff_expert
        return total - inactive
