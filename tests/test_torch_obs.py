"""The port's stage-attributed tracing (repro_torch.obs), frames on the CPU
device: the span tracer's ring and flush, the stage tree, the Chrome-trace
schema, Prometheus, and deterministic snapshots equal traced and untraced
(single system, fleet replay, chaos) -- as tests/test_obs.py holds the
reference's -- and what the port adds: the spans of hv_sched's LRU scan
and reclaim round, hv_sched tasks tagged by kind, the decode step's span,
the per-stage counts of copies across PCIe, and the ``taiji::<stage>``
ranges in torch.profiler's timeline, with nothing built when obs is off.
"""
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test worker: see test_torch_hygiene.py

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import repro_torch.obs.tracer as OT  # noqa: E402
from repro_torch.core.config import ObsConfig, small_test_config  # noqa: E402
from repro_torch.core.metrics import (FK_COMPRESSED, FK_NAMES, FK_ZERO,  # noqa: E402
                                      Metrics)
from repro_torch.core.scheduler import TASK_LRU_SCAN, TASK_RECLAIM  # noqa: E402
from repro_torch.core.system import TaijiSystem  # noqa: E402
from repro_torch.fleet import chaos_trace, paper_trace  # noqa: E402
from repro_torch.fleet.harness import build_fleet, replay_twice  # noqa: E402
from repro_torch.obs import (STAGE_NAMES, STAGES, SpanTracer,  # noqa: E402
                             export_chrome, render_prom, stage_tree)
from repro_torch.obs.tracer import (MIRRORED, ST_FAULT_MUTEX,  # noqa: E402
                                    ST_FAULT_TOTAL, ST_GUEST_ACCESS,
                                    ST_GUEST_COPY, ST_LRU_SCAN, TAG_READ)


def system(cfg=None):
    return TaijiSystem(cfg or traced_cfg(), device="cpu")


def traced_cfg(**overrides):
    return small_test_config(obs=ObsConfig(enabled=True), **overrides)


def zero_fault_workload(s):
    """Alloc one MS, swap every (zero) MP out, fault each back with one
    read. Returns (gfn, n_reads)."""
    cfg = s.cfg
    space = s.guest
    g = space.alloc_ms()
    assert s.engine.swap_out_ms(g) == cfg.mps_per_ms
    for mp in range(cfg.mps_per_ms):
        assert space.read(g, 16, off=mp * cfg.mp_bytes) == bytes(16)
    return g, cfg.mps_per_ms


def filled_ms(s, seed: int = 0):
    """One MS whose every MP holds compressible, non-zero bytes."""
    g = s.guest.alloc_ms()
    rng = np.random.default_rng(seed)
    for mp in range(s.cfg.mps_per_ms):
        row = np.repeat(rng.integers(1, 255, s.cfg.mp_bytes // 64, dtype=np.uint8), 64)
        s.guest.write(g, row.tobytes(), off=mp * s.cfg.mp_bytes)
    return g


# ---------------------------------------------------------- tracer unit
def test_push_flush_aggregates():
    tr = SpanTracer(cap=64)
    for i in range(10):
        tr.push(ST_FAULT_TOTAL, 1000 + i, 100 + i, FK_ZERO)
    tr.flush()
    t = tr.totals()["fault_total"]
    assert t["count"] == 10
    assert t["total_ns"] == sum(100 + i for i in range(10))
    assert t["max_ns"] == 109
    assert t["by_tag"][FK_ZERO]["count"] == 10


def test_ring_overflow_auto_flushes():
    tr = SpanTracer(cap=8)
    for i in range(100):
        tr.push(ST_GUEST_ACCESS, i, 5, TAG_READ)
    assert tr.span_count == 100          # nothing lost: push flushes at cap


def test_max_spans_bounds_retained_not_aggregates():
    tr = SpanTracer(cap=64, max_spans=5)
    for i in range(12):
        tr.push(ST_GUEST_ACCESS, i, 7)
    tr.flush()
    assert tr.span_count == 12           # aggregates never drop
    assert len(list(tr.spans())) == 5    # retained store is bounded


def test_zero_duration_span_survives_flush():
    # enc uses dur+1 so a 0ns span is not mistaken for an empty slot
    tr = SpanTracer(cap=8)
    tr.push(ST_FAULT_MUTEX, 123, 0)
    tr.flush()
    t = tr.totals()["fault_mutex"]
    assert t["count"] == 1 and t["total_ns"] == 0


def test_end_records_the_span_begin_started():
    tr = SpanTracer(cap=8)
    t0 = tr.begin(ST_LRU_SCAN)
    tr.end(ST_LRU_SCAN, t0, 1)
    tr.end(ST_LRU_SCAN, t0, 1, dur_ns=50)
    t = tr.totals()["lru_scan"]
    assert t["count"] == 2 and t["by_tag"][1]["count"] == 2
    assert [sp[1] for sp in tr.spans()] == [t0, t0]
    assert list(tr.spans())[1][2] == 50


# ------------------------------------------------------------ stage tree
def test_the_stage_tree_names_each_stage_once_parents_first():
    seen = set()
    for name, parent in STAGES:
        assert name not in seen and (parent is None or parent in seen)
        seen.add(name)
    assert len(STAGES) <= 256                    # 8 stage bits
    parents = dict(STAGES)
    assert parents["guest_copy"] == "guest_access"
    for root in ("lru_scan", "reclaim_round", "decode_step", "swap_out",
                 "sched_task"):
        assert parents[root] is None
    assert MIRRORED <= set(STAGE_NAMES)


def test_stage_tree_self_time_rollup():
    tr = SpanTracer(cap=64)
    tr.push(ST_FAULT_TOTAL, 0, 100_000)
    tr.push(ST_FAULT_MUTEX, 0, 30_000)
    tree = stage_tree([tr])
    assert tree["fault_total"]["self_ns"] == 70_000
    assert tree["fault_mutex"]["self_ns"] == 30_000
    assert tree["fault_mutex"]["parent"] == "fault_total"


def test_stage_tree_self_time_clamps_at_zero():
    tr = SpanTracer(cap=64)
    tr.push(ST_FAULT_TOTAL, 0, 10_000)
    tr.push(ST_FAULT_MUTEX, 0, 40_000)   # child exceeds parent (fan-out)
    assert stage_tree([tr])["fault_total"]["self_ns"] == 0


def test_stage_tree_aggregates_across_tracers():
    a, b = SpanTracer(cap=8), SpanTracer(cap=8)
    a.push(ST_FAULT_TOTAL, 0, 100)
    b.push(ST_FAULT_TOTAL, 0, 300)
    t = stage_tree([a, b])["fault_total"]
    assert t["count"] == 2 and t["total_ns"] == 400 and t["max_ns"] == 300


# ----------------------------------------------------- system integration
def test_no_tracer_is_built_when_obs_is_off(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a SpanTracer was built with obs off")

    monkeypatch.setattr(OT.SpanTracer, "__init__", refuse)
    s = system(small_test_config())
    try:
        zero_fault_workload(s)
        s.step_background()
        assert s.tracer is None and s.metrics.tracer is None
        assert s.lru._tr is None and s.virt._tr is None
        assert s.scheduler._tr is None and s.engine._tr is None
    finally:
        s.close()


def test_span_counts_match_call_counts():
    s = system()
    try:
        _, n_reads = zero_fault_workload(s)
        tr = s.tracer
        # every read is one guest_access span; every swapped MP is one
        # fault_total span with the same interval the fault ring records
        assert tr.stage_count("guest_access") == n_reads
        assert tr.stage_count("fault_total") == n_reads
        assert s.metrics.faults == n_reads
        assert tr.stage_count("swap_out") == 1
        # one frame copy per read, on the slow path after the fault
        assert tr.stage_count("guest_copy") == n_reads
    finally:
        s.close()


def test_fault_subtree_telescopes_to_fault_total():
    """The fault_total span shares the fault ring's interval, so the
    fault subtree's self-times sum exactly to fault_total's total."""
    s = system()
    try:
        g = filled_ms(s)
        s.engine.swap_out_ms(g)
        for mp in range(s.cfg.mps_per_ms):
            s.guest.read(g, 16, off=mp * s.cfg.mp_bytes)
        tree = stage_tree([s.tracer])
        subtree = ("fault_total", "fault_mutex", "fault_desc", "fault_alloc",
                   "fault_copy", "fault_backend", "fault_readahead",
                   "readahead_decode")
        self_sum = sum(tree[n]["self_ns"] for n in subtree if n in tree)
        assert self_sum == tree["fault_total"]["total_ns"]
    finally:
        s.close()


def test_a_guest_copy_lies_inside_its_access_and_beside_its_faults():
    s = system()
    try:
        g = filled_ms(s)
        s.engine.swap_out_ms(g)
        for mp in range(s.cfg.mps_per_ms):
            s.guest.read(g, 64, off=mp * s.cfg.mp_bytes + 64)
        s.guest.read_many([(g, mp * s.cfg.mp_bytes, 32) for mp in range(4)])
        spans = list(s.tracer.spans())
        access = [(t0, t0 + d) for st, t0, d, _, _ in spans if st == ST_GUEST_ACCESS]
        faults = [(t0, t0 + d) for st, t0, d, _, _ in spans if st == ST_FAULT_TOTAL]
        copies = [(t0, t0 + d) for st, t0, d, _, _ in spans if st == ST_GUEST_COPY]
        assert copies and faults
        for a, b in copies:
            assert any(x <= a and b <= y for x, y in access)
            assert not any(x < b and a < y for x, y in faults)
    finally:
        s.close()


def test_one_lru_scan_and_one_reclaim_round_span_per_call():
    s = system()
    try:
        for _ in range(10):
            filled_ms(s)
        n = s.cfg.lru.workers
        scans0 = s.lru.scan_rounds
        calls = [0]
        reclaim = s.engine.reclaim_round

        def counted(*a, **k):
            calls[0] += 1
            return reclaim(*a, **k)

        s.engine.reclaim_round = counted
        for _ in range(5):
            s.step_background()
        tr = s.tracer
        assert tr.stage_count("lru_scan") == s.lru.scan_rounds - scans0 == 5 * n
        assert set(tr.totals()["lru_scan"]["by_tag"]) == set(range(n))
        assert tr.stage_count("reclaim_round") == calls[0] == 5
        s.step_background(reclaim=False)
        assert tr.stage_count("reclaim_round") == 5
    finally:
        s.close()


def test_sched_task_spans_are_tagged_by_task_kind_under_live_hv_sched():
    s = system()
    try:
        for _ in range(6):
            filled_ms(s)
        s.start_background()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            time.sleep(0.05)
            t = s.tracer.totals().get("sched_task", {"by_tag": {}})["by_tag"]
            if {TASK_LRU_SCAN, TASK_RECLAIM} <= set(t):
                break
        s.stop_background()
        tags = set(s.tracer.totals()["sched_task"]["by_tag"])
        assert tags == {TASK_LRU_SCAN, TASK_RECLAIM}
        # the scan tasks' work is the lru_scan spans inside them
        assert s.tracer.stage_count("lru_scan") > 0
    finally:
        s.close()


def test_one_decode_step_span_per_serve_step_given_a_tracer():
    from repro_torch.configs.reduce import reduced_config
    from repro_torch.models import model as M
    from repro_torch.train.steps import serve_step
    cfg = reduced_config("qwen3-4b")
    model = M.init_params(cfg, seed=0, device="cpu")
    cache = M.init_cache(cfg, 2, 2 * cfg.kv_block_tokens, device="cpu")
    tok = torch.zeros((2,), dtype=torch.int32)
    tr = SpanTracer()
    for _ in range(3):
        logits, cache = serve_step(model, tok, cache, cfg, tracer=tr)
    assert tr.stage_count("decode_step") == 3
    plain, _ = serve_step(model, tok, cache, cfg)      # no tracer: no span
    assert tr.stage_count("decode_step") == 3 and tr.span_count == 3
    assert plain.shape == logits.shape


# ------------------------------------------------------- copies per stage
def test_copy_counters_equal_the_bytes_moved():
    s = system()
    try:
        tr = s.tracer
        g = filled_ms(s)
        c0 = tr.copies()["guest_copy"]["h2d"]
        assert c0 == {"count": s.cfg.mps_per_ms, "bytes": s.cfg.ms_bytes}
        s.guest.read(g, 64, off=128)                    # resident: the fast path
        assert tr.copies()["guest_copy"]["d2h"] == {"count": 1, "bytes": 64}
        s.guest.write(g, bytes(64), off=0)
        assert tr.copies()["guest_copy"]["h2d"]["bytes"] == s.cfg.ms_bytes + 64

        # the swap-out: the flags and count, then the non-zero rows and
        # their tags, to the host
        k = s.cfg.mps_per_ms
        chunks = -(-k // s.cfg.swap.batch_mps)
        assert s.engine.swap_out_ms(g) == k
        out = tr.copies()["backend_store"]["d2h"]
        assert out["bytes"] == 4 * chunks + k + k * s.cfg.mp_bytes + 4 * k

        # a readahead fault fills its extent's rows in one upload
        m = s.metrics
        ra0 = m.fault_readahead_mps
        s.guest.read(g, 64, off=0)
        rows = m.fault_readahead_mps - ra0 + 1
        assert rows > 1
        assert tr.copies()["fault_readahead"]["h2d"] == {
            "count": 1, "bytes": rows * s.cfg.mp_bytes}

        # the swap-in uploads what it stages and reads a 4-byte verdict
        g2 = filled_ms(s, seed=1)
        s.engine.swap_out_ms(g2)
        assert s.engine.swap_in_ms(g2) == k
        load = tr.copies()["backend_load"]
        assert load["h2d"]["bytes"] >= k * s.cfg.mp_bytes
        assert load["d2h"] == {"count": load["h2d"]["count"],
                               "bytes": 4 * load["h2d"]["count"]}
    finally:
        s.close()


def test_copies_stay_out_of_the_deterministic_snapshot():
    snaps = []
    for cfg in (small_test_config(), traced_cfg()):
        s = system(cfg)
        try:
            g = filled_ms(s)
            s.engine.swap_out_ms(g)
            s.guest.read(g, 64, off=0)
            snaps.append(json.dumps(s.metrics.deterministic_snapshot(),
                                    sort_keys=True))
        finally:
            s.close()
    assert snaps[0] == snaps[1]


# ------------------------------------------------------ profiler ranges
def _host_events(prof):
    return [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()]


def test_a_mirrored_span_is_a_profiler_range_on_the_spans_clock():
    s = system()
    try:
        for _ in range(4):
            filled_ms(s)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            s.step_background()
        tr = s.tracer
        scans = [(t0, d) for st, t0, d, _, _ in tr.spans() if st == ST_LRU_SCAN]
        ranges = sorted((st, d) for n, st, d in _host_events(prof)
                        if n == "taiji::lru_scan")
        assert len(ranges) == len(scans) == s.cfg.lru.workers
        for (t0, d), (start, dur) in zip(sorted(scans), ranges):
            assert abs(start - tr.wall_ns(t0)) < 200_000
            assert abs(dur - d) < 200_000
        names = {n for n, _, _ in _host_events(prof)}
        assert "taiji::reclaim_round" in names
        # after the profiler: spans, and no range left open
        s.step_background()
        assert tr.stage_count("lru_scan") == 2 * s.cfg.lru.workers
        assert not getattr(tr._ranges, "stack", [])
    finally:
        s.close()


def test_nested_ranges_close_in_order():
    s = system()
    try:
        g = filled_ms(s)
        s.engine.swap_out_ms(g)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            s.guest.read(g, 64, off=0)
        ev = {n: (st, st + d) for n, st, d in _host_events(prof)
              if n.startswith("taiji::")}
        assert {"taiji::guest_access", "taiji::fault_total",
                "taiji::fault_readahead", "taiji::guest_copy"} <= set(ev)
        a = ev["taiji::guest_access"]
        for inner in ("taiji::fault_total", "taiji::guest_copy"):
            assert a[0] <= ev[inner][0] and ev[inner][1] <= a[1]
        assert not getattr(s.tracer._ranges, "stack", [])
    finally:
        s.close()


def test_no_range_when_obs_is_off():
    s = system(small_test_config())
    try:
        g = filled_ms(s)
        s.engine.swap_out_ms(g)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            s.guest.read(g, 64, off=0)
            s.step_background()
        assert not [n for n, _, _ in _host_events(prof) if n.startswith("taiji::")]
    finally:
        s.close()


# --------------------------------------------------------- chrome export
def test_chrome_export_schema(tmp_path):
    s = system()
    try:
        zero_fault_workload(s)
        path = tmp_path / "trace.json"
        n = export_chrome(str(path), [s.tracer])
        assert n > 0
        doc = json.loads(path.read_text())
        assert doc["displayTimeUnit"] == "ns"
        events = doc["traceEvents"]
        assert len(events) == n
        last_ts = 0.0
        for ev in events:
            assert set(ev) >= {"name", "cat", "ph", "ts", "dur",
                               "pid", "tid"}
            assert ev["ph"] == "X"
            assert ev["name"] in STAGE_NAMES
            assert ev["ts"] >= 0 and ev["dur"] >= 0
            assert ev["ts"] >= last_ts   # sorted by timestamp
            last_ts = ev["ts"]
            assert isinstance(ev["pid"], int) and isinstance(ev["tid"], int)
    finally:
        s.close()


def test_chrome_export_merges_tracers_with_pids(tmp_path):
    a, b = SpanTracer(cap=8, pid=0), SpanTracer(cap=8, pid=3)
    a.push(ST_FAULT_TOTAL, 100, 10)
    b.push(ST_FAULT_TOTAL, 200, 10)
    path = tmp_path / "t.json"
    assert export_chrome(str(path), [a, b]) == 2
    pids = {ev["pid"] for ev in json.loads(path.read_text())["traceEvents"]}
    assert pids == {0, 3}


def test_chrome_export_on_the_profilers_clock(tmp_path):
    tr = SpanTracer(cap=8)
    t0 = tr.begin(ST_LRU_SCAN)
    tr.end(ST_LRU_SCAN, t0, 0, dur_ns=5_000)
    base = tr.wall_ns(t0) - 7_000_000
    path = tmp_path / "t.json"
    assert export_chrome(str(path), [tr], profiler_base_ns=base) == 1
    doc = json.loads(path.read_text())
    assert doc["baseTimeNanoseconds"] == base
    ev = doc["traceEvents"][0]
    assert ev["ts"] == pytest.approx(7_000.0) and ev["dur"] == pytest.approx(5.0)


# ------------------------------------------------------------ prometheus
def test_render_prom_counters_histograms_and_copies():
    s = system()
    try:
        zero_fault_workload(s)
        text = s.metrics.render_prom()
        assert text.endswith("\n")
        assert f"taiji_faults_total {s.metrics.faults}" in text
        assert "taiji_fault_latency_seconds_count" in text
        assert 'le="+Inf"' in text
        assert "taiji_compression_ratio" in text
        # tracer stages render when tracing is on
        assert 'taiji_stage_spans_total{stage="fault_total"}' in text
        # per-kind labeled series
        assert 'kind="zero"' in text
        c = s.tracer.copies()["guest_copy"]["d2h"]
        assert (f'taiji_stage_copy_bytes_total{{stage="guest_copy",dir="d2h"}} '
                f'{c["bytes"]}') in text
        assert (f'taiji_stage_copies_total{{stage="guest_copy",dir="d2h"}} '
                f'{c["count"]}') in text
    finally:
        s.close()


def test_render_prom_without_tracer():
    m = Metrics()
    m.faults = 3
    text = render_prom(m)
    assert "taiji_faults_total 3" in text
    assert "stage_spans_total" not in text and "copy_bytes" not in text


# ---------------------------------------------- per-kind histogram identity
def test_fault_kind_histograms_distinct_after_flush():
    m = Metrics()
    m.fault_ring.push(1000, FK_ZERO)
    m.fault_ring.push(5000, FK_COMPRESSED)
    m.sync()
    kinds = m.fault_latency_by_kind
    objs = [kinds[name] for name in FK_NAMES]
    assert len({id(h) for h in objs}) == len(objs)
    assert id(m.fault_latency) not in {id(h) for h in objs}
    assert kinds["zero"].count == 1 and kinds["compressed"].count == 1
    assert kinds["zero"].total_ns == 1000
    assert kinds["compressed"].total_ns == 5000
    # reset rebuilds fresh objects; captured references keep their samples
    captured = dict(kinds)
    m.reset_fault_latency()
    fresh = m.fault_latency_by_kind
    for name in FK_NAMES:
        assert fresh[name] is not captured[name]
        assert fresh[name].count == 0
    assert captured["zero"].count == 1   # window-frozen, not cleared


# ----------------------------------------------------------- determinism
def test_deterministic_snapshot_identical_traced_vs_untraced():
    snaps = []
    for cfg in (small_test_config(), traced_cfg()):
        s = system(cfg)
        try:
            zero_fault_workload(s)
            s.step_background()
            snaps.append(json.dumps(s.metrics.deterministic_snapshot(),
                                    sort_keys=True))
        finally:
            s.close()
    assert snaps[0] == snaps[1]


def test_fleet_replay_deterministic_with_tracing():
    cfg = traced_cfg()
    gen = paper_trace(7, cfg.ms_bytes, cfg.mps_per_ms, fill_ms=40,
                      burst=120, churn_frees=6)
    fleets = []

    def make_fleet():
        fleet = build_fleet(4, 2, cfg, device="cpu")
        fleets.append(fleet)
        return fleet

    eq = replay_twice(gen.lines(), make_fleet=make_fleet)
    assert eq.identical, eq.report()
    # tracers recorded real spans and survive the harness's fleet.close()
    tracers = [n.system.metrics.tracer for n in fleets[0].nodes]
    assert all(tr is not None for tr in tracers)
    assert sum(tr.span_count for tr in tracers) > 0
    assert sum(tr.stage_count("lru_scan") for tr in tracers) > 0
    assert fleets[0].tracer is not None
    assert fleets[0].tracer.stage_count("fleet_tick") > 0


def test_fleet_traced_bytes_equal_untraced_bytes():
    """Tracing must not leak into the deterministic snapshot: the same
    seeded trace replayed traced and untraced serializes identically."""
    runs = {}
    for name, cfg in (("off", small_test_config()), ("on", traced_cfg())):
        gen = paper_trace(7, cfg.ms_bytes, cfg.mps_per_ms, fill_ms=30,
                          burst=80, churn_frees=4)
        eq = replay_twice(gen.lines(), n_nodes=2, domains=2, cfg=cfg,
                          device="cpu")
        assert eq.identical, eq.report()
        runs[name] = eq.runs[0].bytes
    assert runs["on"] == runs["off"]


def test_fleet_chaos_deterministic_with_tracing():
    runs = {}
    for name, cfg in (("off", small_test_config()), ("on", traced_cfg())):
        managed = 4 * (cfg.n_phys_ms - cfg.mpool_reserve_ms)
        gen = chaos_trace(13, cfg.ms_bytes, cfg.mps_per_ms, 4,
                          fill_ms=int(managed * 1.1), burst=200,
                          kills=2, migrations=3)
        eq = replay_twice(gen.lines(), n_nodes=4, domains=2, cfg=cfg,
                          device="cpu")
        assert eq.identical, eq.report()
        runs[name] = eq.runs[0].bytes
    assert runs["on"] == runs["off"]
