"""Hot-switch (paper §4.1.2) and hot-upgrade (§4.4) in the port
(repro_torch.core.hotswitch / hotupgrade), frames on the CPU device.

The four scenarios of tests/test_hotswitch_upgrade.py run against the
port: a transparent switch under running services, an upgrade under load
that carries v1's swapped-out metadata, the ABI refusal, and the entry
table's drain. Then one seeded, thread-free sequence -- alloc, write,
hot_switch, install_module, swap_out_ms, hot_upgrade, reclaim_round,
reads -- goes through the reference and the port: ``repro.fleet.harness.
snapshot_diff`` finds no difference in the deterministic snapshot or the
backend's stats, and every read returns the same bytes. Last, the port's
elastic-serving flow (``repro_torch.examples.elastic_serving.run``) at
the reduced qwen3-4b geometry ends at module v2 with MSs swapped out.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test worker: see test_torch_hygiene.py

import repro.core as R  # noqa: E402
import repro_torch.core as T  # noqa: E402
from repro.fleet.harness import snapshot_diff  # noqa: E402
from repro_torch.configs.reduce import reduced_config  # noqa: E402
from repro_torch.core.errors import ABIMismatchError  # noqa: E402
from repro_torch.examples.elastic_serving import run  # noqa: E402


def _plain():
    return T.PlainMemorySystem(T.small_test_config(), device="cpu")


class Service(threading.Thread):
    """A running workload: continuous read/write through the accessor."""

    def __init__(self, plain, pcpu, pfns):
        super().__init__(daemon=True)
        self.plain = plain
        self.pcpu = pcpu
        self.pfns = pfns
        self.ops = 0
        self.errors = []
        self.stop_flag = threading.Event()

    def run(self):
        ms = self.plain.cfg.ms_bytes
        off = 64 + 32 * self.pcpu         # disjoint region per service
        i = 0
        while not self.stop_flag.is_set():
            p = self.pfns[i % len(self.pfns)]
            payload = (self.ops % 251).to_bytes(1, "little") * 16
            try:
                self.plain.write(self.pcpu, p * ms + off, payload)
                got = self.plain.read(self.pcpu, p * ms + off, 16)
                assert got == payload, (got, payload)
                self.ops += 1
            except Exception as e:      # pragma: no cover
                self.errors.append(e)
                break
            i += 1


def _stop(services):
    for sv in services:
        sv.stop_flag.set()
    for sv in services:
        sv.join(2)
        assert not sv.is_alive()


def test_hot_switch_is_transparent_to_running_services():
    plain = _plain()
    assert plain.phys.frames.device.type == "cpu"
    pfns = [plain.alloc_ms() for _ in range(6)]
    for i, p in enumerate(pfns):
        plain.write(0, p * plain.cfg.ms_bytes, bytes([i + 1]) * 128)

    services = [Service(plain, pcpu, pfns) for pcpu in range(2)]
    for sv in services:
        sv.start()
    time.sleep(0.05)

    stages = []
    system = T.hot_switch(plain, on_stage=lambda c, s: stages.append((c, s)))
    time.sleep(0.1)
    _stop(services)

    assert all(not sv.errors for sv in services)
    assert all(sv.ops > 0 for sv in services)
    # two-stage switch ran per PCPU
    assert stages.count((0, "stage1")) == 1 and stages.count((0, "stage2")) == 1
    # the same frames, no copy
    assert system.phys is plain.phys
    # original contents preserved (services overwrote offset 64 only)
    for i, p in enumerate(pfns):
        assert plain.read(0, p * plain.cfg.ms_bytes, 16) == bytes([i + 1]) * 16
    # and the memory is now swappable -- the point of the switch
    assert system.engine.swap_out_ms(pfns[0]) == system.cfg.mps_per_ms
    assert plain.read(0, pfns[0] * plain.cfg.ms_bytes, 16) == bytes([1]) * 16
    system.close()


def test_hot_upgrade_under_load_carries_state():
    plain = _plain()
    pfns = [plain.alloc_ms() for _ in range(6)]
    system = T.hot_switch(plain)
    entry = T.EntryOps()
    T.install_module(system, entry, T.EngineModule(system))
    assert entry.call("version") == 1

    # swap some memory out under v1 so there is real metadata to inherit
    data = bytes(range(256)) * (system.cfg.ms_bytes // 256)
    system.guest.write(pfns[1], data)
    entry.call("swap_out_ms", pfns[1])

    sv = Service(plain, 0, pfns[2:])
    sv.start()
    time.sleep(0.02)

    T.hot_upgrade(system, entry, T.EngineModuleV2(system))

    _stop([sv])
    assert not sv.errors and sv.ops > 0
    assert entry.call("version") == 2
    assert system.module_version == 2
    # v1's swapped-out metadata is directly usable by v2 (no conversion)
    assert system.guest.read(pfns[1], len(data)) == data
    system.close()


def test_incompatible_abi_refused():
    plain = _plain()
    system = T.hot_switch(plain)
    entry = T.EntryOps()
    T.install_module(system, entry, T.EngineModule(system))

    class BadModule(T.EngineModule):
        VERSION = 99
        ABI = 999                      # incompatible metadata layout

    with pytest.raises(ABIMismatchError):
        T.hot_upgrade(system, entry, BadModule(system))
    assert entry.call("version") == 1  # old module still serving
    system.close()


def test_entry_ops_drain_before_swap():
    entry = T.EntryOps()
    release = threading.Event()
    entered = threading.Event()

    def slow_op():
        entered.set()
        release.wait(2)
        return "old"

    entry.register("op", slow_op)
    results = []
    t = threading.Thread(target=lambda: results.append(entry.call("op")))
    t.start()
    assert entered.wait(2)

    swapped = threading.Event()

    def do_swap():
        entry.swap_all({"op": lambda: "new"})
        swapped.set()

    t2 = threading.Thread(target=do_swap)
    t2.start()
    time.sleep(0.05)
    assert not swapped.is_set()        # waits for the in-flight call
    release.set()
    t.join(2)
    t2.join(2)
    assert not t.is_alive() and not t2.is_alive()
    assert results == ["old"]
    assert entry.call("op") == "new"


def test_plain_system_needs_a_device(monkeypatch):
    """Without ``device=`` the frames go to the card, and with no card
    construction raises instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.PlainMemorySystem(T.small_test_config())


# --------------------------------------------------- parity with the reference
def _image(rng, cfg):
    """One MS of the paper's page mix: zero MPs, one-byte MPs, random MPs."""
    rows = np.zeros((cfg.mps_per_ms, cfg.mp_bytes), np.uint8)
    kind = rng.integers(0, 3, cfg.mps_per_ms)
    rows[kind == 1] = rng.integers(1, 256, (int((kind == 1).sum()), 1),
                                   dtype=np.uint8)
    rows[kind == 2] = rng.integers(0, 256, (int((kind == 2).sum()), cfg.mp_bytes),
                                   dtype=np.uint8)
    return rows.tobytes()


def _switch_sequence(pkg, seed, **kw):
    cfg = pkg.small_test_config()
    plain = pkg.PlainMemorySystem(cfg, **kw)
    rng = np.random.default_rng(seed)
    ms = cfg.ms_bytes
    pfns = [plain.alloc_ms() for _ in range(cfg.n_phys_ms - cfg.mpool_reserve_ms)]
    images = {p: _image(rng, cfg) for p in pfns}
    for p in pfns:
        plain.write(int(rng.integers(2)), p * ms, images[p])
    reads = [plain.read(0, p * ms + 100, 64) for p in pfns[::3]]

    system = pkg.hot_switch(plain)
    try:
        entry = pkg.EntryOps()
        pkg.install_module(system, entry, pkg.EngineModule(system))
        out = [entry.call("swap_out_ms", p)
               for p in rng.choice(pfns, 1, replace=False).tolist()]
        pkg.hot_upgrade(system, entry, pkg.EngineModuleV2(system))
        for _ in range(3):                   # age the switched MSs to cold
            system.step_background(reclaim=False)
        reclaimed = entry.call("reclaim_round")
        for p in rng.choice(pfns, 6, replace=False).tolist():
            off = int(rng.integers(ms - 512))
            reads.append(plain.read(1, p * ms + off, 512))
        reads += [system.guest.read(p) for p in pfns]
        assert reads[-len(pfns):] == [images[p] for p in pfns]
        return (out, reclaimed, entry.call("version"), reads,
                system.snapshot()["deterministic"], system.backend.stats())
    finally:
        system.close()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_switch_and_upgrade_match_reference(seed):
    ref = _switch_sequence(R, seed)
    port = _switch_sequence(T, seed, device="cpu")
    assert snapshot_diff(ref[4], port[4]) == []
    assert snapshot_diff(ref[5], port[5]) == []
    assert port[:4] == ref[:4]
    out, reclaimed, version = port[:3]
    assert version == 2 and port[4]["module_version"] == 2
    assert sum(out) > 0 and reclaimed > 0
    assert port[4]["metrics"]["crc_failures"] == 0


# ---------------------------------------------------------- elastic serving
def test_elastic_serving_upgrades_under_load():
    stats = run(reduced_config("qwen3-4b"), phys_blocks=48, device="cpu",
                turns=6)
    m = stats["metrics"]
    assert stats["entry_version"] == 2 and stats["module_version"] == 2
    assert stats["upgrade_turn"] == 3
    assert m["ms_swapped_out"] > 0 and m["crc_failures"] == 0
    assert stats["residency"]["swapped_blocks"] > 0
