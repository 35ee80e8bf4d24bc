"""The paged MLA kernel's share of its roofline, in percent: the bounds of
every launch in the profiled sub-window (one a layer a step, each
sequence's latent rows over its positions; ``bounds_mla.paged_mla_s``)
over the summed device time of the call's kernels (its split and merge
kernels, every name holding ``paged_mla``)."""
from taiji_bench import bounds_mla

KERNEL = "paged_mla"


def read(obs):
    t, p, c = obs.get("trace"), obs.get("profiled"), obs["config"]
    if not t or not p:
        return None
    spent = sum(s for n, s in t["kernels"].items() if KERNEL in n)
    if spent <= 0:
        return None
    B = p["batch"]
    bound = c["num_hidden_layers"] * sum(
        bounds_mla.paged_mla_s(c, B, [n] * B, p["max_blocks"]) for n in p["kv_lens"])
    return 100.0 * bound / spent
