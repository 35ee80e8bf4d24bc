"""Memory Section (MS) / Memory Page (MP) records and state machines.

Paper §4.2.2: "Taiji manages swapping at memory section (MS, huge page)
granularity but operates at memory page (MP, small page) granularity. A
huge page is fully swapped only when all its small pages are swapped in or
out."

The persistent part of each record lives in the mpool arena (stable ABI,
reserved fields) so a hot upgrade inherits it byte-for-byte (§4.4):

    header  : int64[8]   = [abi, gfn, pfn, present_count, ms_state,
                            reserved x3]
    bm_out  : uint64[nw] = already-swapped-out bitmap   (Fig 8 (3))
    bm_in   : uint64[nw] = currently-swapping-in bitmap (Fig 8 (3.3))
    kinds   : uint8[mps] = backend kind per MP (0 none / 1 zero / 2 comp /
                           3 free / 4 disk)
    crc     : uint32[mps]= per-MP CRC32 (paper §7.1 / §5.3.3 "15 MB for CRC")

MS states (exactly-once transitions, Fig 8 (4.1)/(7)):

    RESIDENT --first MP out (split)--> PARTIAL --last MP out--> SWAPPED
    SWAPPED --first MP in (alloc)--> PARTIAL --last MP in (merge)--> RESIDENT
"""
from __future__ import annotations

import numpy as np

from .config import ABI_VERSION, TaijiConfig
from .errors import ABIMismatchError, InvalidStateError
from .mpool import Handle, Mpool

# MS states
MS_RESIDENT = 0
MS_PARTIAL = 1
MS_SWAPPED = 2

# backend kinds per MP
K_NONE = 0
K_ZERO = 1
K_COMPRESSED = 2
K_FREE = 3
K_DISK = 4

_H_ABI, _H_GFN, _H_PFN, _H_PRESENT, _H_STATE = 0, 1, 2, 3, 4
_HEADER_WORDS = 8

# public header-word indices: the O(1) fault-descriptor table reads the
# header straight out of the arena (int64 loads) without an MSRecord
H_ABI, H_GFN, H_PFN, H_PRESENT, H_STATE = (
    _H_ABI, _H_GFN, _H_PFN, _H_PRESENT, _H_STATE)

_BIT_COLUMN = np.arange(64, dtype=np.uint64)
_ONE = np.uint64(1)


# ------------------------------------------------------- bitmap helpers --
# Vectorized operations over uint64 word arrays (the persistent bm_in /
# bm_out arenas). The batched swap path derives MP index vectors from
# these instead of testing one bit per Python call.

def popcount_words(bm: np.ndarray) -> int:
    """Total set bits across all words."""
    return int(np.count_nonzero((bm[:, None] >> _BIT_COLUMN) & _ONE))


def bitmap_indices(bm: np.ndarray, n: int) -> np.ndarray:
    """Indices (int64, ascending) of set bits in ``[0, n)``.

    Expands word-by-word via shifts rather than byte views so the result
    is endianness-independent (the arena is shared across hot upgrades).
    """
    bits = ((bm[:, None] >> _BIT_COLUMN) & _ONE).reshape(-1)
    return np.flatnonzero(bits[:n])


def iter_set(bm: np.ndarray, n: int):
    """Yield set-bit indices in ``[0, n)`` (scalar convenience walker)."""
    for i in bitmap_indices(bm, n):
        yield int(i)


def set_bits(bm: np.ndarray, idxs: np.ndarray, value: bool) -> None:
    """Set/clear a vector of bit indices in one scatter."""
    if len(idxs) == 0:
        return
    idxs = np.asarray(idxs, dtype=np.int64)
    words = idxs >> 6
    masks = _ONE << (idxs & 63).astype(np.uint64)
    if value:
        np.bitwise_or.at(bm, words, masks)
    else:
        np.bitwise_and.at(bm, words, ~masks)


def record_nbytes(cfg: TaijiConfig) -> int:
    nw = (cfg.mps_per_ms + 63) // 64
    return 8 * _HEADER_WORDS + 8 * nw * 2 + cfg.mps_per_ms + 4 * cfg.mps_per_ms


def record_field_offsets(cfg: TaijiConfig) -> dict:
    """Byte offsets of each persistent field inside one MS record.

    The single source of truth for the record layout, shared by
    :class:`MSRecord` (which builds views) and the fault-descriptor table
    (which indexes the arena directly). Changing the layout is an ABI
    break (bump ``ABI_VERSION``).
    """
    nw = (cfg.mps_per_ms + 63) // 64
    header = 0
    bm_out = 8 * _HEADER_WORDS
    bm_in = bm_out + 8 * nw
    kinds = bm_in + 8 * nw
    crc = kinds + cfg.mps_per_ms
    return {"header": header, "bm_out": bm_out, "bm_in": bm_in,
            "kinds": kinds, "crc": crc}


class MSRecord:
    """Typed views over one persistent MS record in the mpool arena."""

    __slots__ = ("cfg", "handle", "header", "bm_out", "bm_in", "kinds", "crc")

    def __init__(self, cfg: TaijiConfig, handle: Handle, *, attach: bool = False) -> None:
        self.cfg = cfg
        self.handle = handle
        nw = (cfg.mps_per_ms + 63) // 64
        raw = handle.view(np.uint8)
        o = 0
        self.header = raw[o : o + 8 * _HEADER_WORDS].view(np.int64); o += 8 * _HEADER_WORDS
        self.bm_out = raw[o : o + 8 * nw].view(np.uint64); o += 8 * nw
        self.bm_in = raw[o : o + 8 * nw].view(np.uint64); o += 8 * nw
        self.kinds = raw[o : o + cfg.mps_per_ms]; o += cfg.mps_per_ms
        self.crc = raw[o : o + 4 * cfg.mps_per_ms].view(np.uint32)
        if attach:
            if int(self.header[_H_ABI]) != ABI_VERSION:
                raise ABIMismatchError(
                    f"MS record ABI {int(self.header[_H_ABI])} != {ABI_VERSION}")
        else:
            self.header[_H_ABI] = ABI_VERSION

    @classmethod
    def allocate(cls, cfg: TaijiConfig, mpool: Mpool, gfn: int, pfn: int) -> "MSRecord":
        rec = cls(cfg, mpool.slab_alloc(record_nbytes(cfg)))
        rec.header[_H_GFN] = gfn
        rec.header[_H_PFN] = pfn
        rec.header[_H_PRESENT] = cfg.mps_per_ms
        rec.header[_H_STATE] = MS_RESIDENT
        return rec

    # ------------------------------------------------------------ properties
    @property
    def gfn(self) -> int:
        return int(self.header[_H_GFN])

    @property
    def pfn(self) -> int:
        return int(self.header[_H_PFN])

    @pfn.setter
    def pfn(self, v: int) -> None:
        self.header[_H_PFN] = v

    @property
    def present_count(self) -> int:
        return int(self.header[_H_PRESENT])

    @present_count.setter
    def present_count(self, v: int) -> None:
        self.header[_H_PRESENT] = v

    @property
    def state(self) -> int:
        return int(self.header[_H_STATE])

    @state.setter
    def state(self, v: int) -> None:
        self.header[_H_STATE] = v

    # ---------------------------------------------------------------- bitmaps
    @staticmethod
    def _bit(bm: np.ndarray, i: int) -> bool:
        return bool((int(bm[i >> 6]) >> (i & 63)) & 1)

    @staticmethod
    def _set_bit(bm: np.ndarray, i: int, v: bool) -> None:
        w = int(bm[i >> 6])
        if v:
            w |= 1 << (i & 63)
        else:
            w &= ~(1 << (i & 63))
        bm[i >> 6] = np.uint64(w & 0xFFFFFFFFFFFFFFFF)

    def is_swapped_out(self, mp: int) -> bool:
        return self._bit(self.bm_out, mp)

    def set_swapped_out(self, mp: int, v: bool) -> None:
        self._set_bit(self.bm_out, mp, v)

    def is_swapping_in(self, mp: int) -> bool:
        return self._bit(self.bm_in, mp)

    def set_swapping_in(self, mp: int, v: bool) -> None:
        self._set_bit(self.bm_in, mp, v)

    def swapped_out_count(self) -> int:
        return popcount_words(self.bm_out)

    # ------------------------------------------------- batched bitmap views
    def resident_indices(self) -> np.ndarray:
        """MPs neither swapped out nor mid-IO: the swap-out batch input."""
        return bitmap_indices(~(self.bm_out | self.bm_in),
                              self.cfg.mps_per_ms)

    def swapped_out_indices(self) -> np.ndarray:
        """MPs swapped out and not mid-IO: the swap-in batch input."""
        inert = self.bm_out & ~self.bm_in
        return bitmap_indices(inert, self.cfg.mps_per_ms)

    def set_swapped_out_batch(self, idxs: np.ndarray, v: bool) -> None:
        set_bits(self.bm_out, idxs, v)

    def set_swapping_in_batch(self, idxs: np.ndarray, v: bool) -> None:
        set_bits(self.bm_in, idxs, v)

    # -------------------------------------------------------- state machine
    def on_first_swap_out(self) -> None:
        if self.state != MS_RESIDENT:
            raise InvalidStateError(f"split from state {self.state}")
        self.state = MS_PARTIAL

    def on_last_swap_out(self) -> None:
        if self.state != MS_PARTIAL or self.present_count != 0:
            raise InvalidStateError("reclaim before all MPs swapped out")
        self.state = MS_SWAPPED
        self.pfn = -1

    def on_first_swap_in(self, new_pfn: int) -> None:
        if self.state != MS_SWAPPED:
            raise InvalidStateError(f"alloc from state {self.state}")
        self.state = MS_PARTIAL
        self.pfn = new_pfn

    def on_last_swap_in(self) -> None:
        if self.state != MS_PARTIAL or self.present_count != self.cfg.mps_per_ms:
            raise InvalidStateError("merge before all MPs swapped in")
        self.state = MS_RESIDENT
