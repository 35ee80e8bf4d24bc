"""Share of the decode steps' host time spent dispatching the MoE FFNs,
in percent: the window's ``moe_ffn`` spans over its ``decode_step``
spans (both the program's, recorded in traced runs). A step replayed
from a CUDA graph (tag 1; 2 the capture) dispatches no MoE FFN from the
host, so a window of such steps alone reads 0; eager steps (tag 0)
without a ``moe_ffn`` span are a program that does not record it, and
read nothing."""

EAGER = 0


def read(obs):
    sp = obs["window"].get("spans", {})
    steps = sp.get("decode_step", {})
    step = sum(steps.values())
    moe = sum(sp.get("moe_ffn", {}).values())
    if not step:
        return None
    if moe:
        return 100.0 * moe / step
    return None if steps.get(EAGER, 0) else 0.0
