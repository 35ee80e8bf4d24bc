"""Taiji elastic-memory core, ported to PyTorch with guest frames on a device.

Layering (bottom up), as in ``repro.core``:
  config/errors/metrics -> mpool -> virt (block table = EPT analogue;
  frames as a device tensor) -> ms/req (records + concurrency) -> backend
  -> lru -> watermark -> swap (engine) -> scheduler (hv_sched)
  -> system (facade) -> dma
  -> guest (GuestSpace: the one sanctioned guest-memory surface)

Not ported yet: hotswitch / hotupgrade and the framework integrations
(elastic_kv / elastic_params).
"""
from .config import (ABI_VERSION, BackendConfig, LRUConfig, SchedulerConfig,
                     TaijiConfig, WatermarkConfig, small_test_config)
from .errors import (ABIMismatchError, CorruptionError, InvalidStateError,
                     MpoolExhaustedError, OutOfMemoryError, PinnedError,
                     TaijiError)
from .guest import GuestObserver, GuestSpace, MSView
from .system import TaijiSystem, import_images

__all__ = [
    "ABI_VERSION", "BackendConfig", "LRUConfig", "SchedulerConfig",
    "TaijiConfig", "WatermarkConfig", "small_test_config",
    "TaijiError", "OutOfMemoryError", "MpoolExhaustedError",
    "CorruptionError", "PinnedError", "ABIMismatchError", "InvalidStateError",
    "GuestObserver", "GuestSpace", "MSView",
    "TaijiSystem", "import_images",
]
