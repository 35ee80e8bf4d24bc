"""Elastic paged KV cache -- Taiji applied to LLM serving.

Port: a copy of ``repro/core/elastic_kv.py`` over the port's
:class:`~.guest.GuestSpace`, so the KV blocks are MSs of guest frames on
the system's device (the card's HBM by default).

The DPU analogy (DESIGN.md §2): a serving node statically reserves KV
space for its *maximum* concurrent sequences, but most sequences are idle
between turns -- exactly the paper's "reserved for peak, cold in practice"
memory. Taiji makes that reservation elastic:

  * one MS per (sequence, KV block): ``block_tokens`` tokens x all layers
    x K+V, so swap decisions happen at the paper's huge-page granularity
    while faults resolve at MP granularity;
  * idle sequences cool down in the multi-level LRU and get swapped to the
    zero/compressed backend by the watermark-driven reclaim task;
  * scheduling a sequence for decode = the DMA-range contract: its blocks
    are swapped in *before* the step and pinned while the step (the
    "no-retry DMA device") is in flight;
  * the device-side data plane reads KV through the block table inside the
    paged-attention kernel (csrc/paged_attention.cu) -- the EPT walk on
    the I/O path.

All guest memory flows through one :class:`~.guest.GuestSpace` (the
sanctioned surface), so attaching a ``TraceRecorder`` to the space turns
a live serving workload into a replayable fleet trace with zero cache
changes.

Beyond-paper: ``prefetch_async`` overlaps the next batch's swap-ins with
the current step (double buffering), recorded in EXPERIMENTS.md §Perf.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..analysis.lock_order import named_lock
from .config import TaijiConfig, size_mpool_reserve
from .guest import GuestSpace
from .system import TaijiSystem
from .virt import F_SPLIT, NO_PFN


@dataclasses.dataclass(frozen=True)
class KVGeometry:
    n_layers: int
    kv_heads: int
    head_dim: int
    block_tokens: int = 16
    dtype_bytes: int = 2        # bf16 on device
    # a latent pool's values per token and layer (MLA: kv_lora_rank +
    # qk_rope_head_dim), in place of K and V; 0 for a K/V pool
    latent_dim: int = 0

    @classmethod
    def for_config(cls, cfg, dtype_bytes: int = 2) -> "KVGeometry":
        """The pool of a model configuration: its attention layers and
        block, and per token and layer K and V of its KV heads, or with
        ``cfg.mla`` the latent row."""
        from ..models.model import attn_layer_count
        return cls(n_layers=attn_layer_count(cfg), kv_heads=cfg.n_kv_heads,
                   head_dim=cfg.head_dim_, block_tokens=cfg.kv_block_tokens,
                   dtype_bytes=dtype_bytes,
                   latent_dim=0 if cfg.mla is None else cfg.mla.latent_dim)

    @property
    def token_shape(self) -> tuple:
        """One token's entry: ``(n_layers, latent_dim)`` for a latent
        pool, else ``(n_layers, 2, kv_heads, head_dim)``."""
        if self.latent_dim:
            return (self.n_layers, self.latent_dim)
        return (self.n_layers, 2, self.kv_heads, self.head_dim)

    @property
    def block_bytes(self) -> int:
        # every layer's entry for one block of tokens
        return (self.block_tokens * math.prod(self.token_shape)
                * self.dtype_bytes)

    @property
    def tokens_per_block(self) -> int:
        return self.block_tokens


def make_kv_taiji_config(geom: KVGeometry, n_phys_blocks: int,
                         overcommit: float = 0.5, **overrides) -> TaijiConfig:
    """Size a Taiji config so one MS == one KV block."""
    ms_bytes = geom.block_bytes
    mps = 8
    while ms_bytes // mps < 512 and mps > 1:
        mps //= 2
    reserve = size_mpool_reserve(ms_bytes, mps, n_phys_blocks, overcommit)
    base = dict(
        ms_bytes=ms_bytes,
        mps_per_ms=mps,
        n_phys_ms=n_phys_blocks + reserve,
        mpool_reserve_ms=reserve,
        overcommit_ratio=overcommit,
    )
    base.update(overrides)
    return TaijiConfig(**base)


class _PrefetchThread(threading.Thread):
    """Prefetch worker whose failures surface instead of dying silently:
    the exception is stored on the thread object and re-raised on
    ``join()`` (once the worker has actually finished)."""

    def __init__(self, **kw) -> None:
        super().__init__(**kw)
        self.exc: Optional[BaseException] = None

    def run(self) -> None:
        try:
            super().run()
        except BaseException as e:      # noqa: BLE001 - surfaced on join
            self.exc = e

    def join(self, timeout: Optional[float] = None) -> None:
        super().join(timeout)
        if self.exc is not None and not self.is_alive():
            raise self.exc


class ElasticKVCache:
    """Host-side elastic KV block store for a serving node.

    Accepts either a :class:`GuestSpace` or a :class:`TaijiSystem` (its
    canonical ``.guest`` space is used), so capture/policy observers
    attached to the space see every cache operation.
    """

    def __init__(self, geom: KVGeometry,
                 space: Union[GuestSpace, TaijiSystem]) -> None:
        self.geom = geom
        self.space = space.guest if isinstance(space, TaijiSystem) else space
        self.system = self.space.system      # telemetry / legacy accessors
        self._lock = named_lock("app")
        # seq_id -> list of gfns (one per block) and token count
        self._blocks: Dict[int, List[int]] = {}
        self._tokens: Dict[int, int] = {}

    # ------------------------------------------------------------ sequences
    def create_sequence(self, seq_id: int) -> None:
        with self._lock:
            if seq_id in self._blocks:
                raise ValueError(f"sequence {seq_id} exists")
            self._blocks[seq_id] = []
            self._tokens[seq_id] = 0

    def drop_sequence(self, seq_id: int) -> None:
        with self._lock:
            gfns = self._blocks.pop(seq_id, [])
            self._tokens.pop(seq_id, None)
        for gfn in gfns:
            self.space.free_ms(gfn)

    def seq_len(self, seq_id: int) -> int:
        return self._tokens[seq_id]

    def blocks_of(self, seq_id: int) -> List[int]:
        return list(self._blocks[seq_id])

    # --------------------------------------------------------------- writes
    def append_kv(self, seq_id: int, kv_token: np.ndarray) -> None:
        """Append one token's KV (shape: ``geom.token_shape``)."""
        g = self.geom
        expect = g.token_shape
        if kv_token.shape != expect:
            raise ValueError(f"kv shape {kv_token.shape} != {expect}")
        raw = kv_token.astype(np.float16 if g.dtype_bytes == 2 else np.float32)
        with self._lock:
            t = self._tokens[seq_id]
            blocks = self._blocks[seq_id]
        slot = t % g.block_tokens
        if slot == 0:                      # new block needed
            gfn = self.space.alloc_ms()
            with self._lock:
                blocks.append(gfn)
        gfn = blocks[t // g.block_tokens]
        self.space.write(gfn, raw.tobytes(), off=slot * raw.nbytes)
        with self._lock:
            self._tokens[seq_id] = t + 1

    # ---------------------------------------------------------------- reads
    def _block_dtype_shape(self):
        g = self.geom
        dt = np.float16 if g.dtype_bytes == 2 else np.float32
        return dt, (g.block_tokens, *g.token_shape)

    def read_block(self, seq_id: int, block_idx: int) -> np.ndarray:
        """Read one block back as ``[block_tokens, *geom.token_shape]``."""
        return self.read_blocks(seq_id, [block_idx])[0]

    def read_blocks(self, seq_id: int,
                    block_idxs: Optional[Sequence[int]] = None) -> np.ndarray:
        """Read several blocks of one sequence in a single batched gather
        (default: all of them): one residency probe, one observer
        dispatch, one ``[n_blocks, block_tokens, *geom.token_shape]``
        result.  This is the attention hot path -- per-block
        ``view().load()`` paid the full translate/bounds/observer stack
        per block."""
        with self._lock:
            blocks = self._blocks[seq_id]
            gfns = (list(blocks) if block_idxs is None
                    else [blocks[i] for i in block_idxs])
        dt, shape = self._block_dtype_shape()
        return self.space.gather(gfns, dt, shape)

    # ------------------------------------------------------------- stepping
    def prepare_step(self, seq_ids: Sequence[int]):
        """Swap in + pin all blocks of the scheduled batch.

        Returns the DMA pin context; use ``with cache.prepare_step(b): step()``.
        Missing blocks are faulted in (this is where fault latency is paid
        and measured); pinned blocks cannot be reclaimed mid-step.
        """
        gfns: List[int] = []
        with self._lock:
            for sid in seq_ids:
                gfns.extend(self._blocks[sid])
        return self.space.pin(gfns)

    def prefetch_async(self, seq_ids: Sequence[int]) -> threading.Thread:
        """Beyond-paper: overlap next batch's swap-ins with the current step.

        Returns the worker thread; a failure inside the worker is stored
        on it and re-raised by ``join()`` rather than vanishing with the
        daemon thread.
        """
        with self._lock:
            gfns = [g for sid in seq_ids for g in self._blocks.get(sid, [])]
        system = self.space.system

        def work() -> None:
            # one vectorized residency probe over the whole candidate set
            # (only swapped or split MSs can need a swap-in) instead of a
            # req lookup per block; the watermark guard stays per-MS so a
            # long prefetch still yields to the pinned in-flight step
            g = np.asarray(gfns, dtype=np.int64)
            if not g.size:
                return
            table = system.virt.table
            cand = ((table.pfn[g] == NO_PFN)
                    | ((table.flags[g] & F_SPLIT) != 0))
            for gfn in (int(x) for x in g[cand]):
                # opportunistic: never compete with the pinned in-flight
                # step for the last free slots
                if system.phys.free_count <= system.watermark.low_ms:
                    return
                req = system.reqs.lookup(gfn)
                if req is not None and req.record.swapped_out_count() > 0:
                    system.engine.swap_in_ms(gfn)

        th = _PrefetchThread(target=work, name="kv-prefetch", daemon=True)
        th.start()
        return th

    # ------------------------------------------------------------ telemetry
    def residency(self) -> Dict[str, int]:
        with self._lock:
            all_gfns = [g for bl in self._blocks.values() for g in bl]
        res = self.space.residency(all_gfns)
        return {"resident_blocks": res["resident"],
                "swapped_blocks": res["swapped"],
                "total_blocks": res["total"]}
