"""Fleet control plane: trace-driven multi-node replay + chaos.

Two scenarios, both through the replay-equivalence harness
(``repro.fleet.harness``: run-twice-compare with a first-divergence
report):

  * **replay** -- a seeded >=2k-op trace through a 4-node fleet (two
    failure domains): FRONT fill past the fleet admission cap, BACK aging
    with staggered reclaim windows, a Zipf fault burst, churn, and one
    full rolling hot-upgrade. Reports fleet-wide swap-in (fault-path)
    latency percentiles against the paper's 10 us P90 claim.
  * **chaos** -- a seeded failure schedule layered on the same workload:
    live MS migrations under load, node kills (drained and hard),
    controller failure recovery, and node recoveries. The determinism
    contract must hold across chaos too; the CI canary gates on both
    ``fleet_replay_deterministic`` and ``fleet_chaos_deterministic``.
  * **capture** -- traces captured from the *real*
    elastic_kv serving loop and elastic_params expert churn through the
    instrumented GuestSpace surface, replayed twice on a 2-node fleet:
    the application's actual bytes are rewritten (``wdata``) and every
    read content-verified (``rdata``). CI gates on
    ``fleet_capture_deterministic == 1.0`` and
    ``capture_verify_failures == 0``.

Port: a copy of ``benchmarks/fleet.py`` over the port's fleet. Every
scenario takes ``device`` (``None``: the card; ``"cpu"`` for the parity
runs), the node's ``cfg`` and the trace's ``burst``, so one code path
drives the reference's small fleet on the CPU and a fleet of the paper's
2 MiB MSs in HBM; each result also carries the replays' wall time
(``replay_s``, host clock)::

    PYTHONPATH=src python -m repro_torch.benchmarks.fleet --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

from ..core.backend import modeled_policy_ns
from ..core.config import ObsConfig, small_test_config
from ..fleet import (REJECT_OVERCOMMIT, capture_expert_churn,
                     capture_kv_serving, chaos_trace, paper_trace)
from ..fleet.harness import build_fleet, replay_twice
from ..obs import export_chrome, stage_tree

# self-time attribution of the fleet fault path (fleet_swapin_stage_*
# rows): (row suffix, stage name). The eight stages partition fault_total
# exactly (fault_total's own self-time is the "other" bucket; fault_alloc
# is the first-in slot-allocation child carved out of fault_desc), so a
# naive sum over the rows reproduces the fleet's mean fault latency.
_FAULT_STAGES = (
    ("mutex", "fault_mutex"),
    ("desc", "fault_desc"),
    ("alloc", "fault_alloc"),
    ("copy", "fault_copy"),
    ("backend", "fault_backend"),
    ("readahead", "fault_readahead"),
    ("decode", "readahead_decode"),
    ("other", "fault_total"),
)


def run(smoke: bool = False, verbose: bool = True,
        trace_out: str = None, *, device=None, cfg=None,
        burst: int = None) -> dict:
    """The paper trace on 4 nodes: ``cfg`` is each node's config (default:
    the reference's small one), traced span by span; ``burst`` the fault
    burst's reads (default 600, or 2000 without ``smoke``)."""
    n_nodes = 4
    obs = ObsConfig(enabled=True)
    if cfg is not None:
        cfg = dataclasses.replace(cfg, obs=obs)
    else:
        cfg = small_test_config(obs=obs) if smoke else small_test_config(
            ms_bytes=64 * 1024, mps_per_ms=16, n_phys_ms=32, obs=obs)
    if burst is None:
        burst = 600 if smoke else 2000
    gen = paper_trace(7, cfg.ms_bytes, cfg.mps_per_ms,
                      fill_ms=int(n_nodes * (cfg.n_phys_ms
                                             - cfg.mpool_reserve_ms) * 1.35),
                      burst=burst,
                      churn_frees=20)

    # capture the fleets the harness builds: tracer aggregates are plain
    # numpy arrays, so they survive the harness's fleet.close()
    fleets = []

    def make_fleet():
        fleet = build_fleet(n_nodes, 2, cfg, device=device)
        fleets.append(fleet)
        return fleet

    t0 = time.perf_counter()
    eq = replay_twice(gen.lines(), make_fleet=make_fleet)
    replay_s = time.perf_counter() - t0
    det = eq.runs[0].deterministic
    lat = eq.runs[0].result["latency"]

    # stage attribution from the FIRST replay's tracers (the same run the
    # latency snapshot above describes)
    tracers = [tr for n in fleets[0].nodes
               if n.alive and (tr := n.system.metrics.tracer) is not None]
    if fleets[0].tracer is not None:
        tracers.append(fleets[0].tracer)
    tree = stage_tree(tracers)
    n_faults = max(1, int(lat["fault"]["count"]))
    stage_us = {}
    for suffix, stage in _FAULT_STAGES:
        node = tree.get(stage)
        stage_us[suffix] = (node["self_ns"] / 1e3 / n_faults
                            if node is not None else 0.0)
    fault_total_ns = (tree["fault_total"]["total_ns"]
                      if "fault_total" in tree else 0)
    trace_events = 0
    if trace_out:
        trace_events = export_chrome(trace_out, tracers)

    out = {
        "n_nodes": n_nodes,
        "trace_ops": gen.n_ops,
        "replay_s": replay_s,
        "deterministic": 1.0 if eq.identical else 0.0,
        "divergence": eq.divergence or "",
        "admitted": det["admitted"],
        "rejected_overcommit": det["rejections"][REJECT_OVERCOMMIT],
        "reclaimed_mps": det["reclaimed_mps"],
        "upgrade_batches_done": det["upgrade_batches_done"],
        "upgrade_aborted": det["upgrade_aborted"],
        "verify_failures": det["replay"]["verify_failures"],
        "faults": lat["fault"]["count"],
        "swap_in_p50_us": lat["fault"]["p50_us"],
        "swap_in_p90_us": lat["fault"]["p90_us"],
        "swap_in_p99_us": lat["fault"]["p99_us"],
        "frac_under_10us": lat["frac_fault_under_10us"],
        "stage_us": stage_us,
        "fault_mean_us": fault_total_ns / 1e3 / n_faults,
        "trace_events": trace_events,
    }
    if verbose:
        print(f"{n_nodes} nodes, {out['trace_ops']} trace ops: "
              f"admitted={out['admitted']} "
              f"rejected={out['rejected_overcommit']} "
              f"reclaimed={out['reclaimed_mps']} MPs, "
              f"upgrade batches={out['upgrade_batches_done']}")
        print(f"fleet swap-in P50={out['swap_in_p50_us']:.1f}us "
              f"P90={out['swap_in_p90_us']:.1f}us "
              f"(paper target: P90 < 10us on DPU hardware)  "
              f"deterministic={bool(out['deterministic'])}")
        budget = " ".join(f"{k}={v:.2f}us" for k, v in stage_us.items())
        print(f"fault-path budget (self-time/fault, "
              f"mean={out['fault_mean_us']:.2f}us): {budget}")
        if trace_out:
            print(f"wrote {trace_events} Chrome trace events to {trace_out}")
        if eq.divergence:
            print(f"DIVERGENCE: {eq.divergence}")
    return out


def run_chaos(smoke: bool = False, verbose: bool = True, *, device=None,
              cfg=None, burst: int = None, migrations: int = 3) -> dict:
    """Seeded chaos scenario: the determinism bit must survive kills,
    recoveries and live migrations (the failure schedule is part of the
    trace, so two replays see identical failures). ``cfg``: each node's
    config (default: the reference's small one); ``burst``: the trace's
    reads (default 400, or 1500 without ``smoke``)."""
    n_nodes = 4
    cfg = cfg or small_test_config()
    if burst is None:
        burst = 400 if smoke else 1500
    managed = n_nodes * (cfg.n_phys_ms - cfg.mpool_reserve_ms)
    gen = chaos_trace(13, cfg.ms_bytes, cfg.mps_per_ms, n_nodes,
                      fill_ms=int(managed * 1.1),
                      burst=burst,
                      kills=2, migrations=migrations)

    t0 = time.perf_counter()
    eq = replay_twice(gen.lines(), n_nodes=n_nodes, domains=2, cfg=cfg,
                      device=device)
    replay_s = time.perf_counter() - t0
    det = eq.runs[0].deterministic
    c = det["replay"]

    out = {
        "trace_ops": gen.n_ops,
        "replay_s": replay_s,
        "deterministic": 1.0 if eq.identical else 0.0,
        "divergence": eq.divergence or "",
        "kills": c["kills"],
        "recovers": c["recovers"],
        "migrations": det["migrations"],
        "migration_mps": det["migration_mps"],
        "ms_replaced": det["ms_replaced"],
        "ms_lost": det["ms_lost"],
        "verify_failures": c["verify_failures"],
        # remote-peer tier: lease lifecycle counters from the
        # controller snapshot -- these are inside the deterministic dict,
        # so the replay-twice equality above already pins them
        "remote_puts": det["remote_puts"],
        "remote_recovered": det["remote_recovered"],
        "remote_rereplicated": det["remote_rereplicated"],
        "remote_dropped": det["remote_dropped"],
        "remote_evicted": det["remote_evicted"],
        "remote_held": det["remote_held"],
        "remote_modeled_ns": det["remote_modeled_ns"],
    }
    if verbose:
        print(f"chaos: {out['trace_ops']} ops, kills={out['kills']} "
              f"recovers={out['recovers']} migrations={out['migrations']} "
              f"replaced={out['ms_replaced']} lost={out['ms_lost']} "
              f"deterministic={bool(out['deterministic'])}")
        print(f"remote tier: puts={out['remote_puts']} "
              f"recovered={out['remote_recovered']} "
              f"rereplicated={out['remote_rereplicated']} "
              f"dropped={out['remote_dropped']} "
              f"evicted={out['remote_evicted']} held={out['remote_held']}")
        if eq.divergence:
            print(f"DIVERGENCE: {eq.divergence}")
    return out


def run_capture(smoke: bool = False, verbose: bool = True, *,
                device=None) -> dict:
    """Capture real integration workloads, replay each twice on a 2-node
    fleet: both must be byte-identical with zero content-verify misses.
    Capture node and replay fleets hold their frames on ``device``."""
    out = {"deterministic": 1.0, "verify_failures": 0,
           "payload_writes": 0, "payload_reads": 0, "trace_ops": 0,
           "replay_s": 0.0}
    for cap in (capture_kv_serving(smoke=smoke, device=device),
                capture_expert_churn(smoke=smoke, device=device)):
        # pressure-matched replay nodes (see CapturedTrace.fleet_cfg): the
        # 2-node fleet is as overcommitted as the capture node was
        t0 = time.perf_counter()
        eq = replay_twice(cap.lines, n_nodes=2, domains=2, cfg=cap.fleet_cfg,
                          device=device)
        out["replay_s"] += time.perf_counter() - t0
        c = eq.runs[0].counters
        out[f"{cap.name}_ops"] = cap.n_ops
        out[f"{cap.name}_deterministic"] = 1.0 if eq.identical else 0.0
        out["trace_ops"] += cap.n_ops
        out["payload_writes"] += c["payload_writes"]
        out["payload_reads"] += c["payload_reads"]
        out["verify_failures"] += c["verify_failures"]
        if not eq.identical:
            out["deterministic"] = 0.0
            out["divergence"] = f"{cap.name}: {eq.divergence}"
        if verbose:
            print(f"capture {cap.name}: {cap.n_ops} ops "
                  f"(w={c['payload_writes']} r={c['payload_reads']}) "
                  f"deterministic={eq.identical} "
                  f"verify_failures={c['verify_failures']}")
    return out


def _policy_rows(ch: dict) -> list:
    """Fast/Slow/Smart placement rows over the chaos run's replicated
    population (``remote_puts`` MS images). Pure data-not-measurement
    (``modeled_policy_ns``): Fast pretends every image stayed in local
    compressed DRAM (cheap, zero durability), Slow pushes every load
    over the peer fabric, Smart is the deployed split -- only the
    ``remote_recovered`` images (dead-owner rebuilds) actually paid the
    peer-fetch RTT."""
    total = ch["remote_puts"]
    n_remote = ch["remote_recovered"]
    n_local = max(0, total - n_remote)
    return [
        (f"fleet_remote_policy_{policy}_us",
         modeled_policy_ns(*split, policy) / 1e3,
         f"images={total}_remote_reads={n_remote}")
        for policy, split in (("fast", (total, 0)),
                              ("slow", (0, total)),
                              ("smart", (n_local, n_remote)))]


def rows(smoke: bool = False, trace_out: str = None, device=None) -> list:
    r = run(smoke=smoke, verbose=False, trace_out=trace_out, device=device)
    ch = run_chaos(smoke=smoke, verbose=False, device=device)
    cap = run_capture(smoke=smoke, verbose=False, device=device)
    total_us = sum(r["stage_us"].values())
    stage_rows = [
        (f"fleet_swapin_stage_{suffix}_us", r["stage_us"][suffix],
         f"share={r['stage_us'][suffix] / max(1e-12, total_us):.3f}_"
         f"of_mean={r['fault_mean_us']:.2f}us")
        for suffix, _ in _FAULT_STAGES]
    return [
        ("fleet_trace_ops", r["trace_ops"], f"nodes={r['n_nodes']}"),
        ("fleet_replay_deterministic", r["deterministic"],
         "byte-identical_snapshots"),
        ("fleet_admission_rejects", r["rejected_overcommit"],
         f"admitted={r['admitted']}"),
        ("fleet_reclaimed_mps", r["reclaimed_mps"], "staggered_windows"),
        ("fleet_upgrade_batches", r["upgrade_batches_done"],
         f"aborted={r['upgrade_aborted']}"),
        ("fleet_swap_in_p50_us", r["swap_in_p50_us"],
         f"faults={r['faults']}"),
        ("fleet_swap_in_p90_us", r["swap_in_p90_us"],
         f"under10us={r['frac_under_10us']:.4f}"),
        # stage-attributed fault-path budget (repro_torch.obs): per-fault
        # self-time of each stage; the seven rows partition the fleet's
        # mean fault latency exactly, so their naive sum == the mean
        *stage_rows,
        ("fleet_fault_mean_us", r["fault_mean_us"],
         f"stage_sum={total_us:.2f}us"),
        ("fleet_verify_failures", r["verify_failures"], "target=0"),
        ("fleet_chaos_deterministic", ch["deterministic"],
         f"kills={ch['kills']}_migrations={ch['migrations']}"),
        ("fleet_chaos_kills", ch["kills"],
         f"recovers={ch['recovers']}"),
        ("fleet_chaos_migrations", ch["migrations"],
         f"replaced={ch['ms_replaced']}_lost={ch['ms_lost']}"),
        # lost MSs leave the read-verify written-set (a lost token has
        # nothing left to verify), so verify_failures alone cannot see
        # data loss: the loss count is its own gated row
        ("fleet_chaos_ms_lost", ch["ms_lost"],
         f"replaced={ch['ms_replaced']}"),
        ("fleet_chaos_verify_failures", ch["verify_failures"], "target=0"),
        # remote-peer swap tier: lease-brokered replication of
        # fully-swapped MSs onto peers. `recovered` is the payoff row --
        # dead-owner MSs rebuilt byte-identical from peer replicas
        # instead of being counted lost
        ("fleet_remote_puts", ch["remote_puts"],
         f"dropped={ch['remote_dropped']}_evicted={ch['remote_evicted']}"),
        ("fleet_remote_recovered", ch["remote_recovered"],
         f"rereplicated={ch['remote_rereplicated']}_"
         f"held={ch['remote_held']}"),
        ("fleet_remote_modeled_ms", ch["remote_modeled_ns"] / 1e6,
         "declared_tier_latency_accrual"),
        # modeled placement-policy comparison (flatmem's Fast/Slow/Smart
        # trio over declared tier latencies): one sweep of the chaos
        # run's replicated population under each policy. Smart charges
        # remote RTT only to the MSs that actually needed a peer fetch.
        *_policy_rows(ch),
        # captured serving workloads: real elastic_kv /
        # elastic_params traffic recorded at the GuestSpace layer and
        # replayed on a 2-node fleet with content verification
        ("fleet_capture_trace_ops", cap["trace_ops"],
         f"kv={cap['kv_serving_ops']}_expert={cap['expert_churn_ops']}"),
        ("fleet_capture_deterministic", cap["deterministic"],
         "kv+expert_byte-identical"),
        ("fleet_capture_payload_ops",
         cap["payload_writes"] + cap["payload_reads"],
         f"writes={cap['payload_writes']}_reads={cap['payload_reads']}"),
        ("capture_verify_failures", cap["verify_failures"], "target=0"),
    ]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="where every node's frames live: cuda (the "
                         "default) or cpu")
    ap.add_argument("--smoke", action="store_true",
                    help="the short traces of the CI canary")
    args = ap.parse_args()
    run(smoke=args.smoke, device=args.device)
    run_chaos(smoke=args.smoke, device=args.device)
    run_capture(smoke=args.smoke, device=args.device)


if __name__ == "__main__":
    main()
