"""The port's elastic expert cache (repro_torch.core.elastic_params),
frames on the CPU device, held against the reference's.

``make_expert_taiji_config`` sizes the same system; the reference's
expert-cache scenario (tests/test_elastic_integrations.py) and a seeded
expert churn, both stepped without background threads, go through both
packages on the same numpy weights: every read is equal, the residency is
equal, and ``repro.fleet.harness.snapshot_diff`` finds no difference in
the systems' deterministic snapshots.
"""
import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test worker: see test_torch_hygiene.py

import repro.core.config as RC  # noqa: E402
import repro.core.elastic_params as RP  # noqa: E402
import repro.core.system as RS  # noqa: E402
import repro_torch.core as T  # noqa: E402
import repro_torch.core.config as TC  # noqa: E402
from repro.fleet.harness import snapshot_diff  # noqa: E402


def _pair(shape, n_hot, n_experts, **lru):
    """The reference's and the port's system and cache, sized alike."""
    nbytes = int(np.prod(shape)) * 4
    ref_cfg = RP.make_expert_taiji_config(nbytes, n_hot, n_experts,
                                          lru=RC.LRUConfig(**lru))
    port_cfg = T.make_expert_taiji_config(nbytes, n_hot, n_experts,
                                          lru=TC.LRUConfig(**lru))
    ref = RS.TaijiSystem(ref_cfg)
    port = T.TaijiSystem(port_cfg, device="cpu")
    return (ref, RP.ElasticExpertCache(ref, n_experts, shape)), \
        (port, T.ElasticExpertCache(port, n_experts, shape))


def _same_state(ref, port):
    """Equal deterministic snapshots and backend stats, and the same block
    table: frame of every MS and its flags (accessed, pinned, split)."""
    a, b = ref.snapshot()["deterministic"], port.snapshot()["deterministic"]
    assert snapshot_diff(a, b) == []
    assert snapshot_diff(ref.backend.stats(), port.backend.stats()) == []
    np.testing.assert_array_equal(port.virt.table.pfn, ref.virt.table.pfn)
    np.testing.assert_array_equal(port.virt.table.flags, ref.virt.table.flags)


@pytest.mark.parametrize("nbytes,n_hot,n_experts", [
    (24 * 16 * 4, 4, 10),                       # the expert capture's
    (64 * 32 * 4 * 3 + 64, 32, 64),             # the MoE example's, reduced
    (3 * 2048 * 1408 * 4, 128, 256),            # deepseek-moe-16b, 4 layers
    (1000, 3, 8),                               # MPs under 1 KiB, unaligned
])
def test_expert_config_is_the_references(nbytes, n_hot, n_experts):
    port = T.make_expert_taiji_config(nbytes, n_hot, n_experts)
    ref = RP.make_expert_taiji_config(nbytes, n_hot, n_experts)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    if nbytes == 3 * 2048 * 1408 * 4:
        assert port.mps_per_ms == 16 and port.mp_bytes == 2_162_688


def test_expert_cache_residency_follows_routing_as_the_reference():
    """tests/test_elastic_integrations.py's scenario in both packages."""
    n_experts, shape = 8, (64, 32)
    lru = dict(scan_interval_s=0.001, stabilize_scans=1, workers=1)
    (ref, rc), (port, pc) = _pair(shape, 3, n_experts, **lru)
    try:
        rng = np.random.default_rng(3)
        weights = {e: rng.standard_normal(shape).astype(np.float32)
                   for e in range(n_experts)}
        for e, w in weights.items():
            rc.put_expert(e, w)
            pc.put_expert(e, w)
        for _ in range(10):                     # the router loves 0..2
            for system, cache in ((ref, rc), (port, pc)):
                cache.note_routing([0, 1, 2])
                for _ in range(3):
                    system.lru.scan_shard(0, 1)
                system.engine.reclaim_round()
        assert pc.residency() == rc.residency()
        assert pc.residency()["swapped_experts"] > 0
        _same_state(ref, port)
        for e, w in weights.items():            # swapped ones fault back in
            got = pc.get_expert(e)
            np.testing.assert_array_equal(got, w)
            np.testing.assert_array_equal(got, rc.get_expert(e))
        with rc.prepare_dispatch([5]), pc.prepare_dispatch([5]):
            assert port.virt.table.is_pinned(pc._view[5].gfn)
        np.testing.assert_array_equal(pc.get_experts([7, 5, 0]),
                                      rc.get_experts([7, 5, 0]))
        np.testing.assert_array_equal(pc.route_counts, rc.route_counts)
        _same_state(ref, port)
    finally:
        ref.close()
        port.close()


def test_seeded_expert_churn_matches_reference():
    """The capture loop's churn (skewed routing, dispatch pins, weight
    updates, a read of a random expert, stepped background rounds) on
    the same seeded weights: equal reads every round, equal residency
    and deterministic snapshots at the end."""
    n_experts, n_hot, shape = 10, 4, (24, 16)
    lru = dict(scan_interval_s=0.001, workers=1, stabilize_scans=1)
    (ref, rc), (port, pc) = _pair(shape, n_hot, n_experts, **lru)
    try:
        pyrng, nprng = random.Random(13), np.random.default_rng(13)
        weights = {e: nprng.standard_normal(shape).astype(np.float32)
                   for e in range(n_experts)}
        for e, w in weights.items():
            rc.put_expert(e, w)
            pc.put_expert(e, w)
        for _ in range(12):
            active = sorted(set(pyrng.sample(range(n_hot), 2)
                                + [pyrng.randrange(n_experts)]))
            for cache in (rc, pc):
                cache.note_routing(active)
            with rc.prepare_dispatch(active), pc.prepare_dispatch(active):
                got = pc.get_experts(active)
                np.testing.assert_array_equal(got, rc.get_experts(active))
                for i, e in enumerate(active):
                    np.testing.assert_array_equal(got[i], weights[e])
            for e in active:
                weights[e] = weights[e] + nprng.standard_normal(
                    shape).astype(np.float32) * 0.01
                rc.put_expert(e, weights[e])
                pc.put_expert(e, weights[e])
            e = pyrng.randrange(n_experts)
            np.testing.assert_array_equal(pc.get_expert(e), weights[e])
            rc.get_expert(e)
            assert port.guest.step_background(2) == ref.guest.step_background(2)
        for cache in (rc, pc):                  # routing alone marks them all
            cache.note_routing(range(n_experts))
        assert pc.residency() == rc.residency()
        assert port.metrics.ms_swapped_out > 0 and port.metrics.crc_failures == 0
        _same_state(ref, port)
    finally:
        ref.close()
        port.close()


@pytest.mark.parametrize("surface", ["system", "space"])
def test_expert_cache_errors_as_the_reference(surface):
    """Either surface is accepted; a wrong shape, an expert larger than
    the MS and an unknown expert raise as in the reference."""
    shape = (24, 16)
    cfg = T.make_expert_taiji_config(24 * 16 * 4, 2, 4)
    system = T.TaijiSystem(cfg, device="cpu")
    try:
        host = system if surface == "system" else system.guest
        cache = T.ElasticExpertCache(host, 4, shape)
        assert cache.space is system.guest and cache.system is system
        with pytest.raises(ValueError, match="bad expert shape"):
            cache.put_expert(0, np.zeros((16, 24), np.float32))
        with pytest.raises(KeyError):
            cache.get_expert(3)
        with pytest.raises(ValueError, match="exceeds MS"):
            T.ElasticExpertCache(host, 4, (25, 16))
        cache.note_routing([1, 3])              # not put yet: counted only
        assert cache.route_counts.tolist() == [0, 1, 0, 1]
        assert cache.residency() == {"resident_experts": 0,
                                     "swapped_experts": 0}
    finally:
        system.close()
