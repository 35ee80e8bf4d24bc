"""Plain reference of guest memory: what every guest-visible byte must be.

A live MS holds the image it was filled with, overwritten by every
guest write since, in program order of the one worker that owns the MS.
This is the guarantee the ``taiji-paper-2m`` configuration states: every
guest-visible byte exact, whatever was swapped out and back in between.
NumPy only; it imports nothing of the program.
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np


class MemoryModel:
    """``images``: (n_img, ms_bytes) uint8; ``payloads``: (n, nbytes)
    uint8, the bytes a write stores, by index."""

    def __init__(self, images: np.ndarray, payloads: np.ndarray) -> None:
        self.images = images
        self.payloads = payloads
        self.image_of: Dict[int, int] = {}
        self.written: Dict[int, Dict[int, int]] = {}   # gfn -> off -> payload

    def fill(self, gfn: int, image: int) -> None:
        self.image_of[gfn] = image
        self.written.pop(gfn, None)

    def write(self, gfn: int, off: int, payload: int) -> None:
        self.written.setdefault(gfn, {})[off] = payload

    def expect(self, gfn: int, off: int, nbytes: int) -> bytes:
        """The bytes a read of ``nbytes`` at ``off`` must return; writes are
        whole payload slots, so a slot is either written or the image's."""
        p = self.written.get(gfn, {}).get(off)
        if p is not None and nbytes == self.payloads.shape[1]:
            return self.payloads[p].tobytes()
        img = self.images[self.image_of[gfn]]
        return img[off:off + nbytes].tobytes()

    def ms_bytes(self, gfn: int) -> np.ndarray:
        """The whole MS as the guest must see it."""
        out = self.images[self.image_of[gfn]].copy()
        n = self.payloads.shape[1]
        for off, p in self.written.get(gfn, {}).items():
            out[off:off + n] = self.payloads[p]
        return out

    def replay(self, log: Iterable[tuple]) -> int:
        """Apply one worker's access log in its order and count the reads
        whose recorded answer differs from what the model says. A log
        entry is ``(gfn, off, payload)`` for a write and ``(gfn, off,
        data)`` with ``data`` the bytes read for a read."""
        bad = 0
        for gfn, off, what in log:
            if isinstance(what, (bytes, bytearray)):
                bad += what != self.expect(gfn, off, len(what))
            else:
                self.write(gfn, off, what)
        return bad


def lossy(data: bytes) -> bytes:
    """The control: a page store that keeps each byte to 7 bits, as a
    lossy codec in place of the lossless backend would."""
    return (np.frombuffer(data, dtype=np.uint8) & np.uint8(0xFE)).tobytes()
