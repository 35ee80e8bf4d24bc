"""The paged decode-attention kernel's share of its roofline, in percent:
the bounds of every launch in the profiled sub-window (one a layer a
step, each sequence's K/V over its positions; ``bounds.paged_attn_s``)
over the kernel's summed device time."""
from taiji_bench import bounds

KERNEL = "paged_attn_kernel"


def read(obs):
    t, p, c = obs.get("trace"), obs.get("profiled"), obs["config"]
    if not t or not p:
        return None
    spent = sum(s for n, s in t["kernels"].items() if KERNEL in n)
    if spent <= 0:
        return None
    B = p["batch"]
    bound = c["num_hidden_layers"] * sum(
        bounds.paged_attn_s(B, [n] * B, c["num_attention_heads"],
                            c["num_key_value_heads"], c["head_dim"], p["max_blocks"])
        for n in p["kv_lens"])
    return 100.0 * bound / spent
