"""Deterministic synthetic data pipeline.

Produces shardable, reproducible batches for every arch family without
touching disk (this container is offline). The stream is keyed by
(seed, step) so checkpoint/restart resumes the exact cursor -- the
pipeline state is just an integer, which the checkpoint manager persists
(fault-tolerance requirement).

Token streams follow a Zipf-like distribution over the vocab (more
realistic router/embedding load than uniform); audio features are
band-limited noise; vision embeddings are unit-normal patches.

A copy of ``repro/data/pipeline.py``, numpy only: its batches are the
reference's byte for byte. ``train.steps.to_device`` moves one to a
device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass
class PipelineState:
    seed: int
    step: int = 0


class SyntheticPipeline:
    def __init__(self, cfg, batch: int, seq_len: int, seed: int = 0) -> None:
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.state = PipelineState(seed=seed)
        # Zipf weights over the vocab (clipped for tractability)
        v = min(cfg.vocab, 65536)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        w = 1.0 / ranks ** 1.1
        self._probs = (w / w.sum()).astype(np.float64)
        self._vocab_eff = v

    # ------------------------------------------------------------- batches
    def next_batch(self) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.state.seed << 20) ^ self.state.step)
        self.state.step += 1
        cfg, B, S = self.cfg, self.batch, self.seq_len
        batch: Dict[str, np.ndarray] = {}
        if cfg.family == "audio":
            t = np.arange(S)[None, :, None] / 16.0
            phase = rng.uniform(0, 2 * np.pi, (B, 1, cfg.frontend_dim))
            freq = rng.uniform(0.1, 4.0, (B, 1, cfg.frontend_dim))
            batch["features"] = (np.sin(freq * t + phase)
                                 + 0.1 * rng.standard_normal((B, S, cfg.frontend_dim))
                                 ).astype(np.float32)
            batch["labels"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
            return batch

        toks = rng.choice(self._vocab_eff, size=(B, S + 1),
                          p=self._probs).astype(np.int32)
        batch["tokens"] = toks[:, :-1]
        batch["labels"] = toks[:, 1:].astype(np.int32)
        if cfg.family == "vlm":
            nv = cfg.max_vision_tokens
            batch["vision_embeds"] = rng.standard_normal(
                (B, nv, cfg.d_model)).astype(np.float32)
            batch["mrope_pos"] = self._mrope_positions(nv, B, S)
            # don't train on the vision prefix
            mask = np.ones((B, S), np.float32)
            mask[:, :nv] = 0.0
            batch["loss_mask"] = mask
        return batch

    def _mrope_positions(self, nv: int, B: int, S: int) -> np.ndarray:
        """M-RoPE ids: vision prefix gets a (t,h,w) grid, text continues 1-D."""
        side = max(1, int(np.sqrt(nv)))
        pos = np.zeros((3, B, S), np.int32)
        idx = np.arange(nv)
        pos[0, :, :nv] = 0                       # one temporal frame
        pos[1, :, :nv] = (idx // side)[None, :]
        pos[2, :, :nv] = (idx % side)[None, :]
        text = np.arange(S - nv) + side          # text resumes after the grid
        for a in range(3):
            pos[a, :, nv:] = text[None, :]
        return pos

    # ---------------------------------------------------- fault tolerance
    def snapshot(self) -> Dict[str, int]:
        return {"seed": self.state.seed, "step": self.state.step}

    def restore(self, snap: Dict[str, int]) -> None:
        self.state = PipelineState(seed=snap["seed"], step=snap["step"])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.next_batch()
