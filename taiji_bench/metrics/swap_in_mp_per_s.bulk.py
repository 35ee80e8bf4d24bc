"""MPs the swap engine brought back per second of its own swap-in time:
the ``mp_swapped_in`` counter over the ``swap_in`` spans' total."""


def read(obs):
    w = obs["window"]
    ns = sum(w.get("spans", {}).get("swap_in", {}).values())
    if not ns:
        return None
    return w["counters"]["mp_swapped_in"] / (ns / 1e9)
