"""Taiji elastic-memory core, ported to PyTorch with guest frames on a device.

Layering (bottom up), as in ``repro.core``:
  config/errors/metrics -> mpool -> virt (block table = EPT analogue;
  frames as a device tensor) -> ms/req (records + concurrency) -> backend
  -> lru -> watermark -> swap (engine) -> scheduler (hv_sched)
  -> system (facade) -> hotswitch / hotupgrade -> dma
  -> guest (GuestSpace: the one sanctioned guest-memory surface)
  -> elastic_kv (ElasticKVCache: Taiji under a serving node's KV cache)

Not ported yet: elastic_params.
"""
from .config import (ABI_VERSION, BackendConfig, LRUConfig, SchedulerConfig,
                     TaijiConfig, WatermarkConfig, small_test_config)
from .errors import (ABIMismatchError, CorruptionError, InvalidStateError,
                     MpoolExhaustedError, OutOfMemoryError, PinnedError,
                     TaijiError)
from .elastic_kv import ElasticKVCache, KVGeometry, make_kv_taiji_config
from .guest import GuestObserver, GuestSpace, MSView
from .system import TaijiSystem, import_images
from .hotswitch import PlainMemorySystem, hot_switch
from .hotupgrade import EngineModule, EngineModuleV2, EntryOps, hot_upgrade, install_module

__all__ = [
    "ABI_VERSION", "BackendConfig", "LRUConfig", "SchedulerConfig",
    "TaijiConfig", "WatermarkConfig", "small_test_config",
    "TaijiError", "OutOfMemoryError", "MpoolExhaustedError",
    "CorruptionError", "PinnedError", "ABIMismatchError", "InvalidStateError",
    "GuestObserver", "GuestSpace", "MSView",
    "TaijiSystem", "import_images", "PlainMemorySystem", "hot_switch",
    "EntryOps", "EngineModule", "EngineModuleV2", "install_module", "hot_upgrade",
    "ElasticKVCache", "KVGeometry", "make_kv_taiji_config",
]
