"""Host milliseconds of hv_sched's background rounds (LRU scans, reclaim)
per second of the window, host clock around each stepped round."""


def read(obs):
    w = obs["window"]
    if "back_s" not in w or w["seconds"] <= 0:
        return None
    return 1e3 * w["back_s"] / w["seconds"]
