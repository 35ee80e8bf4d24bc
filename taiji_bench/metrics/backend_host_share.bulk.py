"""Share of the swap engine's time spent in the backend's host codec, in
percent: the ``swap_compress`` and ``swap_decompress`` spans over the
``swap_out`` and ``swap_in`` spans."""


def read(obs):
    sp = obs["window"].get("spans", {})
    total = sum(sp.get("swap_out", {}).values()) + sum(sp.get("swap_in", {}).values())
    if not total:
        return None
    codec = (sum(sp.get("swap_compress", {}).values())
             + sum(sp.get("swap_decompress", {}).values()))
    return 100.0 * codec / total
