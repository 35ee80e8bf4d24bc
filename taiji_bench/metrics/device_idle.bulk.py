"""Share of the profiled sub-window in which no operation ran on the
card, in percent (the union of the trace's device events against the
sub-window's length)."""


def read(obs):
    t = obs.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
