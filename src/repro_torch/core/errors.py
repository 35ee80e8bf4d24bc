"""Error types for the Taiji elastic-memory core."""
from __future__ import annotations


class TaijiError(Exception):
    """Base class for all Taiji errors."""


class OutOfMemoryError(TaijiError):
    """No physical MS available and reclaim could not free one."""


class MpoolExhaustedError(TaijiError):
    """The pinned metadata pool has no space left (paper reserves headroom)."""


class CorruptionError(TaijiError):
    """CRC mismatch on swap-in (paper §7.1 data-correctness guard)."""


class PinnedError(TaijiError):
    """Attempted to swap out a pinned (DMA / mpool) section."""


class ABIMismatchError(TaijiError):
    """Hot-upgrade metadata ABI incompatibility (paper §4.4)."""


class InvalidStateError(TaijiError):
    """An MS/MP state-machine transition was attempted out of order."""
