"""Host milliseconds of hv_sched's LRU scans per second of the swap-bulk
window: the ``lru_scan`` spans (one per ``MultiLevelLRU.scan_shard``)
over the window's seconds (none where the program records no such
span)."""


def read(obs):
    w = obs["window"]
    scans = w.get("spans", {}).get("lru_scan")
    if not scans or w["seconds"] <= 0:
        return None
    return sum(scans.values()) / 1e6 / w["seconds"]
