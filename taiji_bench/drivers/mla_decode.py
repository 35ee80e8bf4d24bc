"""Greedy decode of a DeepSeek-V2 model (latent attention over a paged
latent pool, fine-grained MoE) through the program's serving step
(``repro_torch.train.steps.serve_step``), with no manager beside it.

It is ``decode.Decode`` with another architecture: the loop that steps
every sequence in lockstep, restarts a full sequence from its prompt and
takes each token to the host, the sample of sequences for the check and
the check's shape are ``Decode``'s. What differs:

* the program's model configuration is built from DeepSeek-V2's
  published keys (:func:`arch_config`), and the weights' names and
  shapes are its own (:func:`weight_shapes`): one normal draw on the card
  into one flat buffer in the serving dtype, each weight a view scaled
  to its initializer;
* a step's model FLOPs are ``bounds_mla.decode_step_flops``;
* in a traced run the serving step gets a ``SpanTracer``, and the window
  returns the window's span totals by stage and tag (``spans``): the
  ``decode_step`` spans and, inside eager ones, each layer's ``mla_attn``
  and ``moe_ffn`` (on the card the step replays as one CUDA graph, whose
  steps have none);
* the check runs ``reference/deepseek_v2.py`` and holds the widest gap
  to :data:`GAP_LIMIT`.
"""
from __future__ import annotations

import functools
import math
import time
from typing import List

import numpy as np

from .. import bounds_mla
from .. import workload as W
from ..bench import Check
from .decode import NORM_SD, Decode, program_model
from .taiji import delta, span_totals

# the widest gap a served token's float32 logit may lie below the
# reference's best (PERF.md gives the readings it was set from)
GAP_LIMIT = 0.5


def arch_config(config: dict):
    """The program's model configuration from the published keys; a key
    whose value the program does not implement raises."""
    from repro_torch.models.config import (MLAConfig, PortArchConfig,
                                           PortMoEConfig, YaRNConfig)
    unsupported = {"q_lora_rank": None, "hidden_act": "silu", "attention_bias": False,
                   "scoring_func": "softmax", "topk_method": "greedy", "n_group": 1,
                   "topk_group": 1, "moe_layer_freq": 1, "routed_scaling_factor": 1}
    for key, value in unsupported.items():
        if config[key] != value:
            raise ValueError(f"{key} = {config[key]!r}: the program has only {value!r}")
    rs, s = config["rope_scaling"], config["serving"]
    if rs["type"] != "yarn":
        raise ValueError(f"rope_scaling {rs['type']!r}: the program has YaRN only")
    return PortArchConfig(
        name=config["name"], family="moe", vocab=config["vocab_size"],
        d_model=config["hidden_size"], n_layers=config["num_hidden_layers"],
        n_heads=config["num_attention_heads"],
        n_kv_heads=config["num_key_value_heads"], head_dim=config["v_head_dim"],
        d_ff=config["intermediate_size"],
        moe=PortMoEConfig(n_routed=config["n_routed_experts"],
                          top_k=config["num_experts_per_tok"],
                          d_ff_expert=config["moe_intermediate_size"],
                          n_shared=config["n_shared_experts"],
                          first=config["first_k_dense_replace"],
                          norm_topk_prob=config["norm_topk_prob"]),
        tie_embeddings=config["tie_word_embeddings"],
        rope_theta=float(config["rope_theta"]), norm_eps=config["rms_norm_eps"],
        mla=MLAConfig(kv_lora_rank=config["kv_lora_rank"],
                      qk_nope_head_dim=config["qk_nope_head_dim"],
                      qk_rope_head_dim=config["qk_rope_head_dim"],
                      v_head_dim=config["v_head_dim"]),
        rope_scaling=YaRNConfig(
            factor=float(rs["factor"]),
            original_max_position_embeddings=rs["original_max_position_embeddings"],
            beta_fast=float(rs["beta_fast"]), beta_slow=float(rs["beta_slow"]),
            mscale=float(rs["mscale"]), mscale_all_dim=float(rs["mscale_all_dim"])),
        param_dtype=s["dtype"], compute_dtype=s["dtype"],
        kv_block_tokens=s["kv_block_tokens"])


def weight_shapes(config: dict) -> dict:
    """Every weight of the model under the program's names, ``name:
    (shape, init)``; init is a standard deviation, or "norm" for a norm
    weight. Layer 0 (dense) is ``layer0``, layer l > 0 ``layers.<l-1>``."""
    D, H, V = config["hidden_size"], config["num_attention_heads"], config["vocab_size"]
    R, rope = config["kv_lora_rank"], config["qk_rope_head_dim"]
    nope, dv = config["qk_nope_head_dim"], config["v_head_dim"]
    F, Fe, E = (config["intermediate_size"], config["moe_intermediate_size"],
                config["n_routed_experts"])
    Fs = config["n_shared_experts"] * Fe
    L = config["num_hidden_layers"]
    sd = config["initializer_range"]
    out_sd = sd / math.sqrt(2 * L)
    shapes = {"embed": ((V, D), sd), "final_norm": ((D,), "norm")}
    if not config["tie_word_embeddings"]:
        shapes["lm_head"] = ((D, V), sd)
    for l in range(L):
        p = "layer0." if l == 0 else f"layers.{l - 1}."
        shapes.update({
            p + "ln1": ((D,), "norm"), p + "ln2": ((D,), "norm"),
            p + "attn.wq": ((D, H * (nope + rope)), sd),
            p + "attn.wkv_a": ((D, R + rope), sd), p + "attn.kv_norm": ((R,), "norm"),
            p + "attn.wkv_b": ((R, H * (nope + dv)), sd),
            p + "attn.wo": ((H * dv, D), out_sd)})
        if l < config["first_k_dense_replace"]:
            shapes.update({p + "mlp.w_gate": ((D, F), sd), p + "mlp.w_up": ((D, F), sd),
                           p + "mlp.w_down": ((F, D), out_sd)})
        else:
            shapes.update({
                p + "moe.router": ((D, E), sd), p + "moe.w_gate": ((E, D, Fe), sd),
                p + "moe.w_up": ((E, D, Fe), sd), p + "moe.w_down": ((E, Fe, D), out_sd)})
            if Fs:
                shapes.update({p + "moe.shared_gate": ((D, Fs), sd),
                               p + "moe.shared_up": ((D, Fs), sd),
                               p + "moe.shared_down": ((Fs, D), out_sd)})
    return shapes


def make_weights(config: dict, seed: int, device: str) -> dict:
    """The weights from the seed: one normal draw on the device into one
    flat buffer in the serving dtype; each weight a view, scaled."""
    import torch
    dtype = getattr(torch, config["serving"]["dtype"])
    shapes = weight_shapes(config)
    total = sum(math.prod(s) for s, _ in shapes.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFFFFFFFFFF)
    flat = torch.empty(total, dtype=dtype, device=device)
    flat.normal_(0.0, 1.0, generator=gen)
    out, at = {}, 0
    with torch.no_grad():
        for name, (shape, init) in shapes.items():
            n = math.prod(shape)
            v = flat[at:at + n].view(shape)
            at += n
            if init == "norm":
                v.mul_(NORM_SD).add_(1.0)
            else:
                v.mul_(init)
            out[name] = v
    return out


class MLADecode(Decode):
    def setup(self) -> None:
        import torch
        from repro_torch.models import model as M
        from repro_torch.train.steps import serve_step
        run, t, config = self.run, self.t, self.run.config
        self.cfg = arch_config(config)     # first: a program without MLA fails here
        self.tracer = None
        self.serve_step = serve_step
        if run.trace:
            from repro_torch.obs.tracer import SpanTracer
            self.tracer = SpanTracer()
            self.serve_step = functools.partial(serve_step, tracer=self.tracer)
        self.B, self.P, self.max_seq = t["batch"], t["prompt_tokens"], t["max_seq"]
        self.weights = make_weights(config, run.seed, run.device)
        self.model = program_model(self.cfg, self.weights)
        self.cache = M.init_cache(self.cfg, self.B, self.max_seq,
                                  dtype=getattr(torch, config["serving"]["dtype"]),
                                  device=run.device)
        g = W.rng(run.seed, W.STREAM_PROMPTS)
        self.prompts = torch.from_numpy(g.integers(
            0, config["vocab_size"], (self.B, self.P))).to(run.device)
        self.requests: List[List[int]] = [[] for _ in range(self.B)]
        self.finished: List[List[List[int]]] = [[] for _ in range(self.B)]
        self.pos = 0
        self.tok = None
        while self.pos < self.P:            # the prompt, token by token
            self._step()
        if run.device != "cpu":
            torch.cuda.synchronize()

    def window(self, seconds: float) -> dict:
        steps_ms, kv_lens, served_at, tokens = [], [], [], 0
        sp0 = span_totals(self.tracer)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        now = t0
        while now < deadline:
            kv_lens.append((0 if self.pos == self.max_seq else self.pos) + 1)
            served_at.append(self._step())
            tokens += served_at[-1]
            t1 = time.perf_counter()
            steps_ms.append((t1 - now) * 1e3)
            now = t1
        dt = now - t0
        ends = np.cumsum(steps_ms) / 1e3
        served = np.asarray(served_at)
        series = [int(served[(ends >= i) & (ends < i + 1)].sum())
                  for i in range(int(math.ceil(dt)))]      # tokens, second by second
        self.run.attempted += len(steps_ms) * self.B
        return {"seconds": dt, "e2e": {"decode_tokens_per_s": tokens / dt},
                "series": series, "steps_ms": steps_ms, "kv_lens": kv_lens,
                "batch": self.B, "max_blocks": self.max_seq // self.cfg.kv_block_tokens,
                "flops": sum(bounds_mla.decode_step_flops(self.run.config, self.B,
                                                          [n] * self.B)
                             for n in kv_lens),
                "spans": delta(span_totals(self.tracer), sp0)}

    def gaps(self, control: bool = False):
        import torch
        from ..reference import deepseek_v2
        seqs = [torch.tensor(r, device=self.run.device) for r in self.sample()]
        return deepseek_v2.served_gaps(self.run.config, self.weights.__getitem__, seqs,
                                       [self.P] * len(seqs), control=control)

    def check(self) -> List[Check]:
        g = self.gaps()
        widest = (max(float(x.max()) for x in g if len(x)) if any(len(x) for x in g)
                  else float("nan"))
        return [Check("served_logit_gap", widest, GAP_LIMIT)]
