"""The port's fleet control plane (repro_torch.fleet) and its benchmark
(repro_torch.benchmarks.fleet), frames on the CPU device, held against
the reference's ``repro.fleet``.

Traces are the reference's byte for byte and parse in either package;
the reference's seeded paper and chaos traces (remote-peer tier off and
on) and both captured workloads replay on the port to the reference's
``deterministic_bytes``; a drained kill with migration and a rolling
upgrade aborted by a failed health probe leave the same snapshot; a
killed node's frames leave its device. The ``cuda`` test replays one
trace on the card and on the CPU to equal bytes (``python -m pytest -m
cuda tests/test_torch_fleet.py``).
"""
import dataclasses
import gc
import importlib.util
import weakref
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test worker: see test_torch_hygiene.py

import repro.core.config as RC  # noqa: E402
import repro.core.errors as RE  # noqa: E402
import repro.core.hotupgrade as RH  # noqa: E402
import repro.core.system as RS  # noqa: E402
import repro.fleet as RF  # noqa: E402
import repro.fleet.harness as RFH  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.core.config as TC  # noqa: E402
import repro_torch.fleet as TF  # noqa: E402
import repro_torch.fleet.harness as TFH  # noqa: E402
from repro.fleet.harness import first_divergence  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# one side of every comparison: the reference's package, or the port's on
# the CPU
REF = dict(fleet=RF, harness=RFH, config=RC, errors=RE, hotupgrade=RH,
           system=lambda cfg: RS.TaijiSystem(cfg), dev={})
PORT = dict(fleet=TF, harness=TFH, config=TC, errors=T, hotupgrade=T,
            system=lambda cfg: T.TaijiSystem(cfg, device="cpu"),
            dev={"device": "cpu"})


def _small(pkg, **overrides):
    return pkg["config"].small_test_config(**overrides)


def _gen(fleet, kind, cfg):
    """The seeded traces of tests/test_fleet.py, test_fleet_chaos.py and
    test_remote_tier.py, from ``fleet``'s generators."""
    if kind == "phases":
        gen = fleet.TraceGen(11, cfg.ms_bytes, cfg.mps_per_ms, 0.4, 0.3)
        gen.front_fill(6, write_frac=0.5)
        gen.back_phase(2)
        gen.fault_burst(40, tick_every=7)
        gen.churn(2, 3)
        gen.migrate_sample(2)
        gen.kill_node(1, drain=True)
        gen.recover_node(1)
        gen.rolling_upgrade(drain_rounds=1)
        return gen
    if kind == "paper":
        return fleet.paper_trace(7, cfg.ms_bytes, cfg.mps_per_ms, fill_ms=120,
                                 burst=600, churn_frees=20)
    if kind == "chaos":
        return fleet.chaos_trace(21, cfg.ms_bytes, cfg.mps_per_ms, 4, fill_ms=60,
                                 burst=240, kills=2, migrations=3)
    if kind == "chaos_no_recover":
        return fleet.chaos_trace(22, cfg.ms_bytes, cfg.mps_per_ms, 3, fill_ms=24,
                                 burst=120, kills=1, migrations=1,
                                 drain_frac=0.0, recover=False)
    managed = 4 * (cfg.n_phys_ms - cfg.mpool_reserve_ms)   # remote tier's
    return fleet.chaos_trace(13, cfg.ms_bytes, cfg.mps_per_ms, 4,
                             fill_ms=int(managed * 1.1), burst=200, kills=2,
                             migrations=3)


# ------------------------------------------------------------ trace format
@pytest.mark.parametrize("kind", ["phases", "paper", "chaos"])
def test_trace_lines_match_reference(kind):
    ref = _gen(RF, kind, _small(REF))
    port = _gen(TF, kind, _small(PORT))
    assert port.lines() == ref.lines()
    assert port.n_ops == ref.n_ops


def test_traces_and_payloads_cross_parse(tmp_path):
    """A trace written by either package parses in the other, header and
    lines; page payloads, wdata blobs and rdata checks are equal."""
    cfg = _small(REF)
    rgen = _gen(RF, "phases", cfg)
    rgen.write(str(tmp_path / "ref.tsv"))
    _gen(TF, "phases", cfg).write(str(tmp_path / "port.tsv"))
    assert (tmp_path / "ref.tsv").read_bytes() == (tmp_path / "port.tsv").read_bytes()
    lines = (tmp_path / "ref.tsv").read_text().splitlines()
    for a, b in ((RF, TF), (TF, RF)):
        hdr = a.TraceHeader.parse(lines[0])
        assert b.TraceHeader.parse(hdr.line()).line() == lines[0]
        assert [b.parse_line(ln) for ln in lines[1:]] == [
            a.parse_line(ln) for ln in lines[1:]]
    for seed, token, mp in ((5, 0, 3), (7, 12, 0), (9, 3, 7), (11, 40, 5)):
        for mp_bytes in (512, 4096):
            assert TF.page_bytes(seed, token, mp, mp_bytes, 0.4, 0.3) == \
                RF.page_bytes(seed, token, mp, mp_bytes, 0.4, 0.3)
    rng = np.random.default_rng(0)
    for data in (b"", bytes(300), rng.integers(0, 256, 777).astype(np.uint8).tobytes()):
        blob = TF.encode_payload(data)
        assert blob == RF.encode_payload(data)
        assert RF.decode_payload(blob) == TF.decode_payload(blob) == data
        line = TF.trace.format_line(3, "rdata", 0x80, 0,
                                    TF.trace.encode_read_check(data))
        assert line == RF.trace.format_line(3, "rdata", 0x80, 0,
                                            RF.trace.encode_read_check(data))
        assert RF.parse_line(line) == TF.parse_line(line)


# --------------------------------------------------------- seeded replays
@pytest.mark.parametrize("kind,n_nodes,domains", [
    ("paper", 4, 2), ("chaos", 4, 2), ("chaos_no_recover", 3, 3)])
def test_seeded_replay_matches_reference(kind, n_nodes, domains):
    """The reference's seeded traces replay on the port to the
    reference's deterministic bytes."""
    lines = _gen(RF, kind, _small(REF)).lines()
    ref = RFH.replay(lines, n_nodes=n_nodes, domains=domains, cfg=_small(REF))
    port = TFH.replay(lines, n_nodes=n_nodes, domains=domains, cfg=_small(PORT),
                      device="cpu")
    assert first_divergence(ref.bytes, port.bytes) is None
    assert port.counters["verify_failures"] == 0
    if kind == "paper":
        assert port.deterministic["upgrade_batches_done"] == 2
    else:
        assert port.counters["kills"] >= 1


@pytest.mark.parametrize("remote_tier", [0, 1])
def test_remote_tier_chaos_matches_reference(remote_tier):
    """tests/test_remote_tier.py's chaos trace with the tier off and on:
    equal loss, lease, replica and verify counters, equal bytes."""
    def cfg(pkg):
        base = _small(pkg)
        return dataclasses.replace(base, swap=dataclasses.replace(
            base.swap, hot_path=dataclasses.replace(
                base.swap.hot_path, remote_tier=remote_tier)))

    lines = _gen(RF, "remote", cfg(REF)).lines()
    ref = RFH.replay(lines, n_nodes=4, domains=2, cfg=cfg(REF))
    port = TFH.replay(lines, n_nodes=4, domains=2, cfg=cfg(PORT), device="cpu")
    assert first_divergence(ref.bytes, port.bytes) is None
    keys = ("ms_lost", "ms_replaced", "migrations", "remote_leases",
            "remote_puts", "remote_recovered", "remote_rereplicated",
            "remote_dropped", "remote_evicted", "remote_held")
    assert {k: port.deterministic[k] for k in keys} == \
        {k: ref.deterministic[k] for k in keys}
    assert port.counters["verify_failures"] == ref.counters["verify_failures"] == 0
    assert (port.deterministic["remote_puts"] > 0) == bool(remote_tier)


# ---------------------------------------------------------------- capture
@pytest.mark.parametrize("name", ["kv_serving", "expert_churn"])
def test_capture_matches_reference(name):
    """The same seed captures the reference's trace on the port; the
    reference's capture replays on the port to the reference's bytes,
    with no verify failure."""
    attr = "capture_" + name
    ref = getattr(RF, attr)(smoke=True)
    port = getattr(TF, attr)(smoke=True, device="cpu")
    assert port.lines == ref.lines
    assert dataclasses.asdict(port.fleet_cfg) == dataclasses.asdict(ref.fleet_cfg)
    want = RFH.replay(ref.lines, n_nodes=2, domains=2, cfg=ref.fleet_cfg)
    eq = TFH.replay_twice(ref.lines, n_nodes=2, domains=2, cfg=port.fleet_cfg,
                          device="cpu")
    assert eq.identical, eq.report()
    assert first_divergence(want.bytes, eq.runs[0].bytes) is None
    assert eq.runs[0].counters["verify_failures"] == 0
    assert eq.runs[0].counters["payload_reads"] == ref.payload_reads > 0


def test_partial_capture_records_as_the_reference():
    """tests/test_capture_replay.py's partial capture: a recorder attached
    after the data was written re-establishes it with wdata ops, in both
    packages alike, and the port replays it with no verify failure."""
    def record(pkg):
        cfg = pkg["fleet"].capture_kv_serving(smoke=True, **pkg["dev"]).cfg
        system = pkg["system"](cfg)
        space = system.guest
        rng = np.random.default_rng(5)
        pre = [space.alloc_ms() for _ in range(4)]
        for g in pre:
            space.write(g, rng.integers(0, 256, cfg.ms_bytes, dtype=np.int64)
                        .astype(np.uint8).tobytes())
        rec = space.attach(pkg["fleet"].TraceRecorder.for_space(space))
        for g in pre:
            space.read(g)
        space.step_background()
        for g in pre:
            space.read(g, 128, off=256)
        system.close()
        return rec.lines()

    lines = record(PORT)
    assert lines == record(REF)
    cap = TF.capture_kv_serving(smoke=True, device="cpu")
    run = TFH.replay(lines, n_nodes=2, domains=2, cfg=cap.fleet_cfg, device="cpu")
    assert run.counters["payload_reads"] == 8
    assert run.counters["verify_failures"] == 0


def test_elastic_serving_capture_replays(tmp_path):
    """The port's elastic-serving flow with ``capture``: its trace replays
    on a port fleet, twice to equal bytes, with no verify failure."""
    from repro_torch.configs.reduce import reduced_config
    from repro_torch.examples.elastic_serving import run

    path = tmp_path / "serving.tsv"
    stats = run(reduced_config("qwen3-4b"), phys_blocks=48, device="cpu",
                turns=4, capture=str(path))
    lines = path.read_text().splitlines()
    assert stats["captured_ops"] == len(lines) - 1 > 0
    cfg = TF.TraceHeader.parse(lines[0])
    node = TC.small_test_config(ms_bytes=cfg.ms_bytes, mps_per_ms=cfg.mps_per_ms,
                                n_phys_ms=40, mpool_reserve_ms=4)
    eq = TFH.replay_twice(lines, n_nodes=2, domains=2, cfg=node, device="cpu")
    assert eq.identical, eq.report()
    assert eq.runs[0].counters["payload_writes"] > 0
    assert eq.runs[0].counters["verify_failures"] == 0


# ----------------------------------------------- chaos and upgrade, whole
def _drained_kill(pkg):
    fleet = pkg["harness"].build_fleet(3, 3, _small(pkg), **pkg["dev"])
    remaps = []
    fleet.remap_listener = lambda src, g, dst, ng, kept: remaps.append(
        (src.node_id, g, None if dst is None else dst.node_id, ng, kept))
    try:
        cfg = fleet.nodes[0].cfg
        placed = [fleet.admit_alloc()[:2] for _ in range(9)]
        for i, (node, gfn) in enumerate(placed):
            for mp in range(0, cfg.mps_per_ms, 3):
                node.write_mp(gfn, mp, bytes([i + 1, mp]) * (cfg.mp_bytes // 2))
        node, gfn = placed[1]
        node.system.engine.swap_out_ms(gfn)      # a swapped MS moves too
        dst, new_gfn, reason = fleet.migrate_ms(*placed[0])
        assert reason == "ok"
        placed[0] = (dst, new_gfn)
        fleet.tick()
        victim = placed[1][0].node_id
        fleet.kill_node(victim, drain=True)
        fleet.tick()
        where = {(s, g): (d, ng) for s, g, d, ng, _kept in remaps}
        reads = []
        for node, gfn in placed:
            d, ng = where.get((node.node_id, gfn), (node.node_id, gfn))
            reads.append(fleet.node_by_id(d).read_mp(ng, 0, 64))
        return fleet.deterministic_bytes(), remaps, reads
    finally:
        fleet.close()


def test_drained_kill_with_migration_matches_reference():
    ref, port = _drained_kill(REF), _drained_kill(PORT)
    assert first_divergence(ref[0], port[0]) is None
    assert port[1:] == ref[1:]
    assert any(kept for *_x, kept in port[1])


def _aborted_upgrade(pkg):
    """A module whose swap-out the health probe finds refused: the first
    failure-domain batch aborts the rollout, the second never drains."""
    V2, TaijiError = pkg["hotupgrade"].EngineModuleV2, pkg["errors"].TaijiError

    class RefusingModule(V2):
        def ops(self):
            def refuse(gfn):
                raise TaijiError("swap-out refused")
            return {**super().ops(), "swap_out_ms": refuse}

    fleet = pkg["harness"].build_fleet(4, 2, _small(pkg), **pkg["dev"])
    try:
        for _ in range(6):
            node, gfn, _ok = fleet.admit_alloc()
            node.write_mp(gfn, 1, b"\x5A" * 64)
        fleet.start_rolling_upgrade(RefusingModule, drain_rounds=1)
        for _ in range(10):
            if not fleet.upgrade_in_progress:
                break
            fleet.tick()
        return fleet.deterministic_bytes(), fleet.upgrade_abort_reason
    finally:
        fleet.close()


def test_rolling_upgrade_aborted_by_health_probe_matches_reference():
    ref, port = _aborted_upgrade(REF), _aborted_upgrade(PORT)
    assert "health probe failed" in port[1]
    assert port[1] == ref[1]
    assert first_divergence(ref[0], port[0]) is None


def test_killed_node_frees_its_frames():
    """The port drops a killed node's system: its frame tensor is gone at
    the kill, what the reference exposes of a dead node stays (allocated
    set, snapshot, close), and recovery boots fresh frames."""
    fleet = TFH.build_fleet(3, 3, _small(PORT), device="cpu")
    try:
        n1 = fleet.nodes[1]
        gfn = n1.alloc_ms()
        frames = weakref.ref(n1.system.phys.frames)
        fleet.kill_node(1)
        gc.collect()
        assert frames() is None and n1.system is None
        assert n1.allocated == {gfn}
        with pytest.raises(TF.NodeDeadError):
            n1.read_mp(gfn, 0, 8)
        det = fleet.snapshot()["deterministic"]
        assert det["alive_nodes"] == 2 and det["nodes"][1]["alive"] is False
        fleet.recover_node(1)
        assert n1.alive and n1.system.phys.frames.device.type == "cpu"
        assert n1.allocated == set() and n1.recoveries == 1
    finally:
        fleet.close()
        fleet.close()


# ------------------------------------------------------------- benchmark
def test_fleet_benchmark_rows_match_reference():
    """``repro_torch.benchmarks.fleet.rows`` on the CPU gives the reference
    benchmark's rows wherever they do not time anything."""
    spec = importlib.util.spec_from_file_location(
        "reference_bench_fleet", ROOT / "benchmarks" / "fleet.py")
    ref_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_bench)
    from repro_torch.benchmarks import fleet as port_bench

    def counted(rows):
        return [r for r in rows if not r[0].endswith("_us")]

    ref = counted(ref_bench.rows(smoke=True))
    port = counted(port_bench.rows(smoke=True, device="cpu"))
    assert port == ref
    assert dict((r[0], r[1]) for r in port)["fleet_replay_deterministic"] == 1.0


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only there)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_replay_equals_cpu(cuda_device):
    """One seeded chaos trace through fleets on the card (kernels) and on
    the CPU (plain versions): equal deterministic bytes."""
    cfg = _small(PORT)
    lines = _gen(TF, "remote", cfg).lines()
    on_cpu = TFH.replay(lines, cfg=cfg, device="cpu")
    on_card = TFH.replay(lines, cfg=cfg, device=cuda_device)
    assert first_divergence(on_cpu.bytes, on_card.bytes) is None
    assert on_card.counters["verify_failures"] == 0
