"""The port's elastic KV cache (repro_torch.core.elastic_kv) and serving
driver (repro_torch.launch.serve), frames on the CPU device.

The reference's KV round trip under pressure, pinning and dropping are
run on the port; then one seeded create / append / prepare_step /
drop_sequence sequence, stepped without background threads, goes through
the reference's cache and the port's: ``repro.fleet.harness.
snapshot_diff`` finds no difference in the deterministic snapshot or the
backend's stats, and every sequence reads back the same bytes.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test worker: see test_torch_hygiene.py

import repro.core.config as RC  # noqa: E402
import repro.core.elastic_kv as RK  # noqa: E402
import repro.core.system as RS  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.core.config as TC  # noqa: E402
from repro.fleet.harness import snapshot_diff  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.reduce import reduced_config  # noqa: E402
from repro_torch.launch.serve import run_serving  # noqa: E402

GEOM = T.KVGeometry(n_layers=2, kv_heads=2, head_dim=16, block_tokens=4,
                    dtype_bytes=2)
TOKEN = (2, 2, 2, 16)


def make_cache(phys_blocks=8, overcommit=2.0):
    cfg = T.make_kv_taiji_config(GEOM, phys_blocks, overcommit=overcommit,
                                 lru=TC.LRUConfig(scan_interval_s=0.001,
                                                  stabilize_scans=1, workers=1))
    system = T.TaijiSystem(cfg, device="cpu")
    return T.ElasticKVCache(GEOM, system), system


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2-0.5b", "granite-20b"])
@pytest.mark.parametrize("phys", [6, 48])
def test_kv_config_is_the_references(arch, phys):
    """One MS per KV block, sized as the reference sizes it (qwen3-4b:
    64 tokens x 36 layers x K+V x 8 heads x 128 x 2 bytes = 9 MiB)."""
    cfg = get_config(arch)
    kw = dict(n_layers=cfg.n_layers, kv_heads=cfg.n_kv_heads,
              head_dim=cfg.head_dim_, block_tokens=cfg.kv_block_tokens)
    port = T.make_kv_taiji_config(T.KVGeometry(**kw), phys, overcommit=1.5)
    ref = RK.make_kv_taiji_config(RK.KVGeometry(**kw), phys, overcommit=1.5)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    if arch == "qwen3-4b":
        assert port.ms_bytes == 9 * 2**20 and port.mps_per_ms == 8


def test_kv_roundtrip_exact_under_pressure():
    cache, system = make_cache(phys_blocks=6)
    try:
        rng = np.random.default_rng(0)
        mirror = {}
        n_seqs, toks = 6, 12              # 6 seqs x 3 blocks = 18 > 6 phys
        for sid in range(n_seqs):
            cache.create_sequence(sid)
            mirror[sid] = []
            for _ in range(toks):
                kv = rng.standard_normal(TOKEN).astype(np.float16)
                cache.append_kv(sid, kv)
                mirror[sid].append(kv)
        res = cache.residency()
        assert res["total_blocks"] == n_seqs * (toks // GEOM.block_tokens)
        assert res["swapped_blocks"] > 0  # pressure forced swaps
        for sid in range(n_seqs):
            for b in range(toks // GEOM.block_tokens):
                want = np.stack(mirror[sid][b * 4:(b + 1) * 4])
                np.testing.assert_array_equal(cache.read_block(sid, b), want)
        assert system.metrics.crc_failures == 0
    finally:
        system.close()


def test_prepare_step_pins_and_faults_in():
    cache, system = make_cache(phys_blocks=6)
    try:
        rng = np.random.default_rng(1)
        for sid in range(6):
            cache.create_sequence(sid)
            for _ in range(8):
                cache.append_kv(sid, rng.standard_normal(TOKEN).astype(np.float16))
        for g in cache.blocks_of(0):
            system.engine.swap_out_ms(g)
        with cache.prepare_step([0]):
            for g in cache.blocks_of(0):
                assert system.virt.table.is_pinned(g)
                assert int(system.virt.table.pfn[g]) != -1
        for g in cache.blocks_of(0):
            assert not system.virt.table.is_pinned(g)
    finally:
        system.close()


def test_prefetch_async_swaps_a_sequence_back_in():
    cache, system = make_cache(phys_blocks=8)
    try:
        rng = np.random.default_rng(2)
        cache.create_sequence(0)
        for _ in range(8):
            cache.append_kv(0, rng.standard_normal(TOKEN).astype(np.float16))
        for g in cache.blocks_of(0):
            system.engine.swap_out_ms(g)
        assert cache.residency()["swapped_blocks"] == 2
        th = cache.prefetch_async([0])
        th.join(timeout=30)
        assert not th.is_alive()
        assert cache.residency()["resident_blocks"] == 2
    finally:
        system.close()


def test_drop_sequence_frees_memory():
    cache, system = make_cache(phys_blocks=6)
    try:
        rng = np.random.default_rng(2)
        cache.create_sequence(0)
        for _ in range(8):
            cache.append_kv(0, rng.standard_normal(TOKEN).astype(np.float16))
        free_before = system.phys.free_count
        cache.drop_sequence(0)
        assert system.phys.free_count > free_before
    finally:
        system.close()


def _kv_traffic(kv_mod, sys_mod, cfg_mod, seed, **kw):
    """Seeded serving traffic, stepped without background threads:
    sequences appended past physical capacity, scheduled pairs pinned and
    extended, one sequence dropped and replaced mid-run. Returns the
    deterministic snapshot, backend stats and every sequence's KV."""
    geom = kv_mod.KVGeometry(n_layers=2, kv_heads=2, head_dim=16,
                             block_tokens=4, dtype_bytes=2)
    cfg = kv_mod.make_kv_taiji_config(
        geom, 12, overcommit=2.0,
        lru=cfg_mod.LRUConfig(scan_interval_s=0.001, stabilize_scans=1,
                              workers=1))
    system = sys_mod.TaijiSystem(cfg, **kw)
    try:
        cache = kv_mod.ElasticKVCache(geom, system)
        rng = np.random.default_rng(seed)
        live = list(range(6))
        for sid in live:
            cache.create_sequence(sid)
            for _ in range(6):
                cache.append_kv(sid, rng.standard_normal(TOKEN).astype(np.float16))
            system.step_background()
        for turn in range(8):
            batch = [live[i] for i in rng.choice(len(live), 2, replace=False)]
            with cache.prepare_step(batch):
                for _ in range(3):
                    for sid in batch:
                        cache.append_kv(sid, rng.standard_normal(TOKEN)
                                        .astype(np.float16))
            system.step_background()
            if turn == 3:
                gone = live.pop(int(rng.integers(len(live))))
                cache.drop_sequence(gone)
                cache.create_sequence(100 + turn)
                live.append(100 + turn)
        kv = {sid: cache.read_blocks(sid) for sid in live}
        return (system.snapshot()["deterministic"], system.backend.stats(),
                kv, cache.residency())
    finally:
        system.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kv_traffic_matches_reference(seed):
    ref = _kv_traffic(RK, RS, RC, seed)
    port = _kv_traffic(T, T, TC, seed, device="cpu")
    assert snapshot_diff(ref[0], port[0]) == []
    assert snapshot_diff(ref[1], port[1]) == []
    assert ref[2].keys() == port[2].keys()
    for sid in ref[2]:
        np.testing.assert_array_equal(port[2][sid], ref[2][sid])
    assert port[3] == ref[3]
    m = port[0]["metrics"]
    assert m["ms_swapped_out"] > 0 and m["mp_swapped_in"] > 0
    assert m["crc_failures"] == 0


def test_run_serving_reduced_on_the_cpu(capsys):
    """A few turns of the serving driver on the reduced qwen3-4b: blocks
    swap out under pressure, the metrics print. (Its ``verify`` read-back
    is not asserted here: under hv_sched it meets the reference's
    lost-write race on blocks that are not pinned -- ROADMAP.md, Queue C;
    the stepped traffic above holds the round trip exactly.)"""
    stats = run_serving(reduced_config("qwen3-4b"), n_seqs=8, phys_blocks=12,
                        turns=6, batch=2, prompt_len=16, gen_len=4,
                        device="cpu")
    m = stats["metrics"]
    assert m["ms_swapped_out"] > 0 and m["crc_failures"] == 0
    assert stats["residency"]["total_blocks"] >= 8 * 2
    out = capsys.readouterr().out
    assert "turn   6" in out and "swapped out MS:" in out


def test_run_serving_verify_reads_every_block_back(capsys):
    """With physical room for every block nothing is reclaimed, and the
    read-back finds each sequence as it was appended."""
    stats = run_serving(reduced_config("qwen2-0.5b"), n_seqs=4, phys_blocks=64,
                        turns=4, batch=2, prompt_len=12, gen_len=5,
                        device="cpu", verify=True, verbose=False)
    assert stats["metrics"]["ms_swapped_out"] == 0
    assert stats["verified_blocks"] == stats["residency"]["total_blocks"] > 4
    assert capsys.readouterr().out == ""


def test_verify_names_a_sequence_that_differs():
    from repro_torch.launch import serve
    cache, system = make_cache(phys_blocks=8)
    try:
        rng = np.random.default_rng(3)
        toks = [rng.standard_normal(TOKEN).astype(np.float16) for _ in range(6)]
        cache.create_sequence(5)
        for kv in toks:
            cache.append_kv(5, kv)
        assert serve._verify(cache, {5: toks}) == 2
        toks[4] = toks[4] + np.float16(1)
        with pytest.raises(RuntimeError, match="sequence 5"):
            serve._verify(cache, {5: toks})
    finally:
        system.close()


def test_run_serving_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_serving(reduced_config("qwen3-4b"), n_seqs=2, phys_blocks=4,
                    turns=1, batch=1, prompt_len=2, gen_len=1, verbose=False)
