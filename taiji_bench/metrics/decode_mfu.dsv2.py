"""The MLA decode steps' share of the card's bf16 peak, in percent: model
FLOPs of every step of the window (``bounds_mla.decode_step_flops``)
over the window's time, against 989 TFLOP/s."""
from taiji_bench import bounds


def read(obs):
    w = obs["window"]
    if "flops" not in w or w["seconds"] <= 0:
        return None
    return 100.0 * w["flops"] / w["seconds"] / bounds.BF16_FLOPS_PER_S
