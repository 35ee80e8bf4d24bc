"""Share of the window's guest faults that took under 10 us, in percent:
the paper's O2 share (93.57% cluster-wide in production)."""


def read(obs):
    ns = obs["window"].get("fault_ns")
    if ns is None or len(ns) == 0:
        return None
    return 100.0 * float((ns < 10_000).mean())
