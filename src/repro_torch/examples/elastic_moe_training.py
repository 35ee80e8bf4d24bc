"""Elastic MoE expert cache during training (reduced deepseek-moe).

    PYTHONPATH=src python -m repro_torch.examples.elastic_moe_training

Trains the reduced deepseek-moe config while mirroring its routed-expert
weights in a Taiji ElasticExpertCache sized for only a fraction of the
experts: the router's empirical distribution keeps hot experts resident
while cold ones live compressed, exactly the paper's "reserved for peak,
cold in practice" memory -- and at the end every expert, faulted back
where it was swapped out, is verified bit for bit against the training
state (CRC-guarded round trip).

Port of ``examples/elastic_moe_training.py``: the loop is :func:`run`,
which takes the model config, the steps, the batch and the device (the
card by default; ``--device cpu``) and returns what it measured, so that
a caller can drive it at full width. The guest frames and the training
state live on that device.
"""
from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import numpy as np
import torch

from ..configs.reduce import reduced_config
from ..core.config import LRUConfig
from ..core.elastic_params import ElasticExpertCache, make_expert_taiji_config
from ..core.system import TaijiSystem
from ..core.virt import resolve_device
from ..data.pipeline import SyntheticPipeline
from ..models.moe import router_topk
from ..optim import adamw
from ..train import steps as S


def expert_weights(model, eid: int) -> np.ndarray:
    """Routed expert ``eid`` of the first MoE layer as (3, D, F) float32:
    ``w_gate``, ``w_up``, ``w_down^T``."""
    moe = model.layers[0].moe
    with torch.no_grad():
        w = torch.stack([moe.w_gate[eid], moe.w_up[eid], moe.w_down[eid].T])
    return w.float().cpu().numpy()


def run(cfg, *, steps: int = 40, batch: int = 4, seq: int = 64,
        seed: int = 0, device=None, log_every: int = 10,
        **taiji_overrides) -> Dict[str, Any]:
    """Train ``cfg`` for ``steps`` steps with its first MoE layer's routed
    experts mirrored in an expert cache with room for half of them.
    ``taiji_overrides`` go to ``make_expert_taiji_config``. Returns the
    per-step ``loss`` and ``step_ms``, the seconds of the set-up (state,
    system, first puts: ``setup_s``) and of the final check
    (``verify_s``), the experts ``verified`` at the end, the system's
    swap and fault counters and the final ``residency``, and the
    training ``state``. Raises ``AssertionError``
    where an expert differs from the training state."""
    device = resolve_device(device)
    t_setup = time.perf_counter()
    m = cfg.moe
    opt_cfg = adamw.AdamWConfig(lr=1e-3, total_steps=40)
    state = S.init_train_state(cfg, opt_cfg, seed=seed, device=device)
    pipe = SyntheticPipeline(cfg, batch, seq, seed=seed)

    # expert cache: physical room for only 1/2 of the routed experts
    e_shape = (cfg.d_model, m.d_ff_expert)
    e_bytes = int(np.prod(e_shape)) * 4
    tcfg = make_expert_taiji_config(
        e_bytes * 3 + 64, m.n_routed // 2, m.n_routed,
        lru=LRUConfig(scan_interval_s=0.002, workers=1, stabilize_scans=1),
        **taiji_overrides)
    system = TaijiSystem(tcfg, device=device)
    out: Dict[str, Any] = {"loss": [], "step_ms": [], "active": []}
    try:
        # the GuestSpace is the sanctioned surface: every expert read/write
        # below goes through typed MS views on it
        cache = ElasticExpertCache(system.guest, m.n_routed,
                                   (3, *e_shape), dtype=np.float32)
        for eid in range(m.n_routed):
            cache.put_expert(eid, expert_weights(state.model, eid))
        out["setup_s"] = time.perf_counter() - t_setup

        for step in range(steps):
            t0 = time.perf_counter()
            batch_t = S.to_device(pipe.next_batch(), device)
            # which experts does the router activate for this batch?
            with torch.no_grad():
                x = state.model.embed[batch_t["tokens"]].reshape(-1, cfg.d_model)
                _, idx, _ = router_topk(x, state.model.layers[0].moe.router,
                                        m.top_k)
            active = sorted(set(idx.reshape(-1).tolist()))
            cache.note_routing(active)
            with cache.prepare_dispatch(active):     # swap in + pin for the step
                state, metrics = S.train_step(state, batch_t, cfg, opt_cfg)
            # push updated weights back to the elastic store
            for eid in active:
                cache.put_expert(eid, expert_weights(state.model, eid))
            for _ in range(2):
                system.lru.scan_shard(0, 1)
            system.engine.reclaim_round()
            loss = float(metrics["loss"])
            out["step_ms"].append((time.perf_counter() - t0) * 1e3)
            out["loss"].append(loss)
            out["active"].append(len(active))
            if (step + 1) % log_every == 0:
                res = cache.residency()
                print(f"step {step+1:3d} loss={loss:.4f} "
                      f"experts resident={res['resident_experts']} "
                      f"swapped={res['swapped_experts']}")

        # verify every expert (faulting cold ones back in) matches train state
        t_verify = time.perf_counter()
        for eid in range(m.n_routed):
            np.testing.assert_array_equal(
                cache.get_expert(eid).view(np.uint32),
                expert_weights(state.model, eid).view(np.uint32))
        out["verify_s"] = time.perf_counter() - t_verify
        print("all expert weights verified through the elastic store")
        st = system.stats()["metrics"]
        print(f"expert swaps: out={st['ms_swapped_out']} faults={st['faults']}")
        out.update(verified=m.n_routed, residency=cache.residency(),
                   state=state, **{k: st[k] for k in (
                       "ms_swapped_out", "ms_swapped_in", "mp_swapped_out",
                       "mp_swapped_in", "faults", "crc_failures")})
    finally:
        system.close()
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)
    run(reduced_config("deepseek-moe-16b"), device=args.device)


if __name__ == "__main__":
    main()
