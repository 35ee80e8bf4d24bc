"""Architecture configuration schema for the model zoo.

One dataclass covers all ten assigned architectures; family-specific
features (GQA geometry, qk-norm, QKV bias, MoE, Mamba, M-RoPE, encoder vs
decoder) are flags/sub-configs. Exact per-arch values live in
``src/repro/configs/<id>.py``.

The port's own settings beyond the reference's schema -- latent
attention (:class:`MLAConfig`), YaRN rope scaling (:class:`YaRNConfig`)
and raw top-k gates (``norm_topk_prob``) -- are fields of the subclasses
:class:`PortArchConfig` and :class:`PortMoEConfig` only. On the base
classes they are class attributes at their "off" values, so every config
built from the base classes has the reference's fields, field for field
(``dataclasses.asdict`` of a port config equals the reference's).
"""
from __future__ import annotations

import dataclasses
import math
from typing import ClassVar, Optional, Tuple


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
    # renormalise the top-k gates to sum to 1 (the reference always does);
    # a field of PortMoEConfig only
    norm_topk_prob: ClassVar[bool] = True


@dataclasses.dataclass(frozen=True)
class PortMoEConfig(MoEConfig):
    """A MoE config with the port's ``norm_topk_prob``: False keeps the
    top-k softmax probabilities as the gates, unrenormalised
    (DeepSeek-V2's ``norm_topk_prob: false``)."""
    norm_topk_prob: bool = True


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2): keys and values come
    from one ``kv_lora_rank``-wide latent per token (normed), and one
    ``qk_rope_head_dim``-wide rotary key shared by every head. A query
    head is ``qk_nope_head_dim + qk_rope_head_dim`` wide, a value head
    ``v_head_dim``. ``q_lora_rank`` None: the query is one projection
    (the only form the port has)."""
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    q_lora_rank: Optional[int] = None

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Values a token keeps per layer in the latent pool: the normed
        latent, then the rotated rope key."""
        return self.kv_lora_rank + self.qk_rope_head_dim


def yarn_mscale(scale: float, mscale: float) -> float:
    """YaRN's attention-temperature factor ``0.1 m ln s + 1`` (1 for
    ``s <= 1``), as hf ``modeling_deepseek.yarn_get_mscale``."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


@dataclasses.dataclass(frozen=True)
class YaRNConfig:
    """YaRN rope scaling (hf ``rope_scaling`` of type ``yarn``)."""
    factor: float
    original_max_position_embeddings: int
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 0.0

    @property
    def cos_sin_scale(self) -> float:
        """The factor on cos and sin: ``mscale(f, mscale) /
        mscale(f, mscale_all_dim)``."""
        return (yarn_mscale(self.factor, self.mscale)
                / yarn_mscale(self.factor, self.mscale_all_dim))


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
    # fields of PortArchConfig only
    mla: ClassVar[Optional[MLAConfig]] = None
    rope_scaling: ClassVar[Optional[YaRNConfig]] = None

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
        if self.mla is not None:
            assert self.mla.q_lora_rank is None, "MLA with a query LoRA"
            assert self.family in ("dense", "moe") and self.kv_pool_layout == "global"
            assert self.mla.qk_rope_head_dim % 2 == 0

    @property
    def rope_dim(self) -> int:
        """Width the rotary embedding turns: the rope key of MLA, else a
        whole head."""
        return self.mla.qk_rope_head_dim if self.mla is not None else self.head_dim_

    def softmax_scale(self) -> float:
        """Attention's score scale: ``1/sqrt(query head width)``, times
        YaRN's ``mscale(factor, mscale_all_dim)`` squared where the config
        has it (hf DeepseekV2Attention)."""
        width = self.mla.qk_head_dim if self.mla is not None else self.head_dim_
        scale = width ** -0.5
        y = self.rope_scaling
        if y is not None and y.mscale_all_dim:
            scale *= yarn_mscale(y.factor, y.mscale_all_dim) ** 2
        return scale

    # parameter count (for 6ND model-FLOPs in the roofline)
    def param_count(self) -> int:
        D, V = self.d_model, self.vocab
        hd = self.head_dim_
        n = V * D                              # embedding
        if not self.tie_embeddings:
            n += D * V                         # lm head
        for l in range(self.n_layers):
            n += 2 * D                         # norms
            if self.is_attn_layer(l) and self.mla is not None:
                a, H = self.mla, self.n_heads
                n += D * H * a.qk_head_dim                  # wq
                n += D * a.latent_dim + a.kv_lora_rank      # wkv_a, kv_norm
                n += a.kv_lora_rank * H * (a.qk_nope_head_dim + a.v_head_dim)
                n += H * a.v_head_dim * D                   # wo
            elif self.is_attn_layer(l) and self.n_heads:
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


@dataclasses.dataclass(frozen=True)
class PortArchConfig(ArchConfig):
    """An :class:`ArchConfig` with the port's own settings: ``mla``
    (latent attention in every attention layer, over a latent paged
    pool) and ``rope_scaling`` (YaRN). Its :meth:`param_count` is the
    published count, every parameter the model holds: the reference's
    leaves out ``final_norm``."""
    mla: Optional[MLAConfig] = None
    rope_scaling: Optional[YaRNConfig] = None

    def param_count(self) -> int:
        return super().param_count() + self.d_model
