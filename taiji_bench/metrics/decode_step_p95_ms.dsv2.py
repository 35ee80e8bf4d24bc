"""95th percentile of the window's MLA decode steps, host clock, in ms (a
step ends when its tokens are on the host)."""
import numpy as np


def read(obs):
    steps = obs["window"].get("steps_ms")
    if not steps:
        return None
    return float(np.percentile(steps, 95))
