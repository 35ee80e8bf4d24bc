"""``BENCHMARK.json`` holds to the benchmark's contract, and every cell
finds its configuration, traffic mix, driver and metric readers by name."""
import ast
import json
import re

import pytest

from taiji_bench import bench
from taiji_bench.tests.tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SPEC = bench.spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) for p in SPEC["paths"])
    assert len(SPEC["command"]) <= 32
    for word in SPEC["command"]:
        assert not word.startswith("/") and ".." not in word
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
        names.append(c["name"])
        for key in c["reduced"]:
            assert NAME.match(key)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= {"bound"} if m in SPEC["end_to_end"] else {"layer", "moves"}
        assert set(m) <= allowed and allowed - set(m) <= {"workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for n in names:
        assert NAME.match(n), n
    for text in [c["why"] for c in SPEC["configs"] + SPEC["workloads"]] + \
            [c["source"] for c in SPEC["configs"]] + [m["layer"] for m in SPEC["per_layer"]]:
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text
    assert len(set(n for n in names)) == len(names)


def test_metrics_sources_bounds_and_moves():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert set(e2e) == {"guest_ops_per_s", "swap_mp_per_s", "decode_tokens_per_s",
                        "setup_s"}
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
        for cell in m.get("workloads", CELLS):
            assert cell in e2e[m["moves"]].get("workloads", CELLS), (m["name"], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves_every_piece_by_name(cell):
    w, config, traffic, e2e, per_layer = bench.resolve(cell)
    assert any(c["name"] == w["config"] for c in SPEC["configs"])
    assert callable(bench.driver_class(traffic["driver"]))
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert per_layer
    for m in per_layer:
        assert callable(bench.reader(m["name"]))
    entry = next(c for c in SPEC["configs"] if c["name"] == w["config"])
    assert entry["file"].startswith(SPEC["paths"][0] + "/")
    for key in entry["reduced"]:
        assert key in config
    if "manager" in config:
        bench.config_file(config["manager"])


def test_every_config_is_used_and_files_are_its_own():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for f in files:
        json.loads((ROOT / f).read_text())


def test_at_most_a_quarter_of_cells_on_four_chips():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_every_metric_file_has_a_reader():
    for path in (ROOT / "taiji_bench" / "metrics").glob("*.py"):
        tree = ast.parse(path.read_text())
        assert any(isinstance(n, ast.FunctionDef) and n.name == "read" for n in tree.body)


def test_the_mix_files_zipf_exponent_reaches_the_draws():
    """A guest mix's ``zipf_s`` is what its draws follow: at 0 every MS is
    as popular as any other, at 1.2 the first takes most."""
    from taiji_bench import workload as W
    flat = W.guest_ops(5, 0, 20000, 100, 64, 0.2, 16, 0.0)["rank"]
    skew = W.guest_ops(5, 0, 20000, 100, 64, 0.2, 16, 1.2)["rank"]
    assert abs((flat == 0).mean() - 0.01) < 0.005
    assert (skew == 0).mean() > 0.15
