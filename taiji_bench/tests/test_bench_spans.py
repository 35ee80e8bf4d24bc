"""The per-layer metric read from the program's ``lru_scan`` spans: on tiny
traced runs on the CPU it gives a number in swap-bulk and is left out
elsewhere; an untraced window records no spans; and where the program
records no ``lru_scan`` span the reader returns nothing."""
import pytest

from taiji_bench import bench
from taiji_bench.tests.tiny import execute, tiny_run

NEW = ["lru_scan_ms_per_s.bulk"]
SPEC = {m["name"]: m for m in bench.spec()["per_layer"]}
CELLS = [w["name"] for w in bench.spec()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_each_new_metric_reads_a_number_in_its_cells_only(cell):
    run, e2e, per_layer = tiny_run(cell, seconds=1.0, trace=True)
    r = execute(run, e2e, per_layer)
    assert r["correct"], r["checks"]
    for name in NEW:
        assert (name in r["metrics"]) == (cell in SPEC[name]["workloads"]), name
        if name in r["metrics"]:
            assert r["metrics"][name]["value"] > 0, name


def test_the_scan_time_is_the_windows_lru_scan_spans():
    run, _, _ = tiny_run("paper2m.swap-bulk", seconds=1.0, trace=True)
    driver = bench.driver_class(run.traffic["driver"])(run)
    try:
        driver.setup()
        tracer = driver.mem.system.tracer
        before = tracer.totals().get("lru_scan", {}).get("count", 0)
        w = driver.window(1.0)
        scans = tracer.totals()["lru_scan"]["count"] - before
    finally:
        driver.close()
    assert scans >= 2 * w["rounds"]         # both shards every stepped round
    v = bench.reader("lru_scan_ms_per_s.bulk")({"window": w})
    assert v == pytest.approx(sum(w["spans"]["lru_scan"].values()) / 1e6 / w["seconds"])
    assert 0 < v < 1e3


def test_an_untraced_window_records_no_spans():
    run, _, _ = tiny_run("paper2m.swap-bulk", seconds=0.5)
    driver = bench.driver_class(run.traffic["driver"])(run)
    try:
        driver.setup()
        assert driver.mem.system.tracer is None
        w = driver.window(0.5)
    finally:
        driver.close()
    assert w["spans"] == {}
    assert bench.reader("lru_scan_ms_per_s.bulk")({"window": w}) is None


@pytest.mark.parametrize("name", NEW)
def test_a_reader_finds_nothing_where_the_program_records_nothing(name):
    window = {"seconds": 20.0, "spans": {"swap_out": {0: 5_000}, "swap_in": {0: 5_000}},
              "counters": {"mp_swapped_out": 10, "mp_swapped_in": 10}}
    assert bench.reader(name)({"window": window}) is None
