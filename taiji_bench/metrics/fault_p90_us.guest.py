"""90th percentile of the window's guest faults, in microseconds: the
program's fault-latency samples (``Metrics.fault_latency``, reset at the
window's start), read with the program's percentile rule. The paper's
headline (O2) asks for under 10 us."""


def read(obs):
    ns = obs["window"].get("fault_ns")
    if ns is None or len(ns) == 0:
        return None
    s = sorted(ns.tolist())
    return s[min(len(s) - 1, int(0.9 * len(s)))] / 1e3
