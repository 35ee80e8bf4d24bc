"""Greedy decode of a dense Qwen3 model through the program's serving step
(``repro_torch.train.steps.serve_step``), optionally beside a Taiji
manager whose work is stepped in after each decode step: a co-tenant
guest's accesses and hv_sched's background rounds (``cotenant`` in the
traffic file). With hv_sched's threads live instead, decode rates swung
by a third between runs of one seed (``PERF.md``).

Set-up makes the weights on the card from the seed, in bfloat16, the
type they are served in: one normal draw into one flat buffer, each
parameter a view of it scaled to its initializer (norm weights drawn
around 1 so that the comparison sees them). The program gets those
tensors as its parameters; the reference reads the same buffer. The
prompts are fed token by token through the serving step (the program
has no prefill into its paged cache), which also warms every shape.

Window: every sequence decodes greedily in lockstep, one token a step,
the token taken to the host each step as a server streams it. A
sequence that fills its ``max_seq`` positions restarts from its prompt;
those prompt steps count as time, not as tokens.

Check: once the window has closed, the peak memory read and the cache
freed, a sample of sequences drawn from the seed, the longest request
among them, goes through the float32 reference; the widest gap by which
a served token's logit lies below the reference's best is compared with
its limit.
"""
from __future__ import annotations

import math
import time
from typing import List

import numpy as np

from .. import workload as W
from ..bench import Check, Run
from ..bounds import decode_step_flops

# the widest gap a served token's float32 logit may lie below the
# reference's best (PERF.md gives the readings it was set from)
GAP_LIMIT = 0.8
NORM_SD = 0.1            # norm weights: 1 + this x N(0, 1)


def arch_config(config: dict):
    """The program's model configuration from the published keys."""
    from repro_torch.models.config import ArchConfig
    s = config["serving"]
    return ArchConfig(
        name=config["name"], family="dense", vocab=config["vocab_size"],
        d_model=config["hidden_size"], n_layers=config["num_hidden_layers"],
        n_heads=config["num_attention_heads"],
        n_kv_heads=config["num_key_value_heads"], head_dim=config["head_dim"],
        d_ff=config["intermediate_size"], qkv_bias=config["attention_bias"],
        qk_norm=True, tie_embeddings=config["tie_word_embeddings"],
        rope_theta=float(config["rope_theta"]), norm_eps=config["rms_norm_eps"],
        param_dtype=s["dtype"], compute_dtype=s["dtype"],
        kv_block_tokens=s["kv_block_tokens"])


def weight_shapes(config: dict) -> dict:
    """Every weight of the model, ``name: (shape, init)``; init is a
    standard deviation, or "norm" for a norm weight."""
    D, hd = config["hidden_size"], config["head_dim"]
    H, KV = config["num_attention_heads"], config["num_key_value_heads"]
    F, L, V = config["intermediate_size"], config["num_hidden_layers"], config["vocab_size"]
    sd = config["initializer_range"]
    out_sd = sd / math.sqrt(2 * L)
    shapes = {"embed": ((V, D), sd), "final_norm": ((D,), "norm")}
    if not config["tie_word_embeddings"]:
        shapes["lm_head"] = ((D, V), sd)
    for l in range(L):
        p = f"layers.{l}."
        shapes.update({
            p + "ln1": ((D,), "norm"), p + "ln2": ((D,), "norm"),
            p + "attn.wq": ((D, H * hd), sd), p + "attn.wk": ((D, KV * hd), sd),
            p + "attn.wv": ((D, KV * hd), sd), p + "attn.wo": ((H * hd, D), out_sd),
            p + "attn.q_norm": ((hd,), "norm"), p + "attn.k_norm": ((hd,), "norm"),
            p + "mlp.w_gate": ((D, F), sd), p + "mlp.w_up": ((D, F), sd),
            p + "mlp.w_down": ((F, D), out_sd)})
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


def program_model(cfg, weights: dict):
    """The program's model with the benchmark's tensors as its parameters."""
    import torch
    from repro_torch.models import model as M
    model = M.Model(cfg, torch.bfloat16, "meta")
    names = {n for n, _ in model.named_parameters()}
    if names != set(weights):
        raise ValueError(f"parameters differ: the program has "
                         f"{sorted(names - set(weights))[:4]}, the benchmark "
                         f"{sorted(set(weights) - names)[:4]}")
    for name in names:
        *path, leaf = name.split(".")
        mod = model
        for key in path:
            mod = getattr(mod, key) if not key.isdigit() else mod[int(key)]
        mod._parameters[leaf] = torch.nn.Parameter(weights[name], requires_grad=False)
    return model


class Decode:
    def __init__(self, run: Run) -> None:
        self.run, self.t = run, run.traffic
        self.cotenant = None

    def setup(self) -> None:
        import torch
        from repro_torch.models import model as M
        from repro_torch.train.steps import serve_step
        run, t, config = self.run, self.t, self.run.config
        self.serve_step = serve_step
        self.cfg = arch_config(config)
        self.B, self.P, self.max_seq = t["batch"], t["prompt_tokens"], t["max_seq"]
        self.weights = make_weights(config, run.seed, run.device)
        self.model = program_model(self.cfg, self.weights)
        self.cache = M.init_cache(self.cfg, self.B, self.max_seq,
                                  dtype=getattr(torch, config["serving"]["dtype"]),
                                  device=run.device)
        g = W.rng(run.seed, W.STREAM_PROMPTS)
        self.prompts = torch.from_numpy(g.integers(
            0, config["vocab_size"], (self.B, self.P))).to(run.device)
        if t.get("cotenant"):
            from .taiji import CoTenant
            ct = t["cotenant"]
            self.cotenant = CoTenant(run, run.manager, ct["write_share"],
                                     ct["warm_share"], ct["zipf_s"])
        self.requests: List[List[int]] = [[] for _ in range(self.B)]
        self.finished: List[List[List[int]]] = [[] for _ in range(self.B)]
        self.pos = 0
        self.tok = None
        while self.pos < self.P:            # the prompt, token by token
            self._step()
        if run.device != "cpu":
            torch.cuda.synchronize()

    def _step(self) -> int:
        """One decode step; returns the tokens it served (B or 0)."""
        pos = self.pos
        if pos == self.max_seq:            # full: restart from the prompt
            for b in range(self.B):
                self.finished[b].append(self.requests[b])
                self.requests[b] = []
            self.cache["kv_len"].zero_()
            pos = self.pos = 0
        inp = self.prompts[:, pos] if pos < self.P else self.tok
        logits, self.cache = self.serve_step(self.model, inp, self.cache, self.cfg)
        self.tok = logits.argmax(-1)
        host = self.tok.cpu().tolist()
        if pos == 0:
            for b in range(self.B):
                self.requests[b] = self.prompts[b].tolist()
        self.pos = pos + 1
        if pos >= self.P - 1:
            for b in range(self.B):
                self.requests[b].append(host[b])
            return self.B
        return 0

    def window(self, seconds: float) -> dict:
        ct, per_step = self.cotenant, self.t.get("cotenant", {}).get("accesses_per_step", 0)
        steps_ms, kv_lens, served_at, tokens, back_s = [], [], [], 0, 0.0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        now = t0
        while now < deadline:
            kv_lens.append((0 if self.pos == self.max_seq else self.pos) + 1)
            served_at.append(self._step())
            tokens += served_at[-1]
            if ct is not None:
                back_s += ct.step(per_step)
            t1 = time.perf_counter()
            steps_ms.append((t1 - now) * 1e3)
            now = t1
        dt = now - t0
        ends = np.cumsum(steps_ms) / 1e3
        served = np.asarray(served_at)
        series = [int(served[(ends >= i) & (ends < i + 1)].sum())
                  for i in range(int(math.ceil(dt)))]      # tokens, second by second
        obs = {"seconds": dt, "e2e": {"decode_tokens_per_s": tokens / dt},
               "series": series, "steps_ms": steps_ms, "kv_lens": kv_lens,
               "batch": self.B, "max_blocks": self.max_seq // self.cfg.kv_block_tokens,
               "flops": sum(decode_step_flops(self.run.config, self.B, [n] * self.B)
                            for n in kv_lens)}
        if ct is not None:
            obs["back_s"] = back_s
        self.run.attempted += len(steps_ms) * self.B
        return obs

    def release(self) -> None:
        import torch
        self.cache = None
        self.model = None
        if self.run.device != "cpu":
            torch.cuda.empty_cache()

    def sample(self) -> List[List[int]]:
        """Requests to compare: the longest a slot served, and those of
        slots drawn from the seed."""
        reqs = [max(self.finished[b] + [self.requests[b]], key=len)
                for b in range(self.B)]
        n = min(self.t["check_sequences"], self.B)
        longest = int(np.argmax([len(r) for r in reqs]))
        rest = [b for b in W.rng(self.run.seed, W.STREAM_SAMPLE).permutation(self.B)
                if b != longest][: n - 1]
        return [reqs[b] for b in [longest, *rest]]

    def gaps(self, control: bool = False):
        import torch
        from ..reference import qwen3
        seqs = [torch.tensor(r, device=self.run.device) for r in self.sample()]
        return qwen3.served_gaps(self.run.config, self.weights.__getitem__, seqs,
                                 [self.P] * len(seqs), control=control)

    def check(self) -> List[Check]:
        g = self.gaps()
        widest = max(float(x.max()) for x in g if len(x)) if any(len(x) for x in g) else float("nan")
        checks = [Check("served_logit_gap", widest, GAP_LIMIT)]
        if self.cotenant:
            checks += self.cotenant.checks()
        return checks

    def close(self) -> None:
        if self.cotenant:
            self.cotenant.close()
