"""Host milliseconds of the manager's stepped background rounds (LRU
scans, reclaim) per second of the decode window, host clock around each
round."""


def read(obs):
    w = obs["window"]
    if "back_s" not in w or w["seconds"] <= 0:
        return None
    return 1e3 * w["back_s"] / w["seconds"]
