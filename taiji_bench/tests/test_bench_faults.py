"""A run with the timed path broken underneath comes out not correct, for
each fault a cell can have (a step that leaves its state unchanged; an
answer or a token altered where it is produced), and the controls fail
the comparisons. Tiny sizes on the CPU, the look for a card skipped.
Half a batch left out and a missing exchange between chips are faults
of training and of sharded cells; these cells have neither."""
import pytest
import torch

from taiji_bench import control
from taiji_bench.tests.tiny import execute, tiny_run

SWAP_CELLS = ["paper2m.fault-zipf", "paper2m.swap-bulk"]
DECODE_CELLS = ["qwen3-4b.decode-b32-taiji", "qwen3-4b.decode-b32-native"]


def _load_unchanged(monkeypatch):
    """The backend's loads and the fault path's extent fill report success
    and leave the frame as it was."""
    from repro_torch.core.backend import BackendStore
    for name in ("load", "load_batch", "write_rows"):
        monkeypatch.setattr(BackendStore, name, lambda self, *a, **k: None)


def _answer_altered(monkeypatch):
    """Every guest read and every swap-in's rows come back with a byte
    flipped."""
    from repro_torch.core.backend import BackendStore
    from repro_torch.core.guest import GuestSpace
    read, load_batch = GuestSpace.read, BackendStore.load_batch

    def bad_read(self, *a, **k):
        data = bytearray(read(self, *a, **k))
        if data:
            data[0] ^= 0x40
        return bytes(data)

    def bad_load(self, gfn, mps, kinds, crcs, out, *, rows=None):
        load_batch(self, gfn, mps, kinds, crcs, out, rows=rows)
        r = int(rows[0]) if rows is not None else 0
        out[r, 0] ^= 0x40

    monkeypatch.setattr(GuestSpace, "read", bad_read)
    monkeypatch.setattr(BackendStore, "load_batch", bad_load)


def _kv_unchanged(monkeypatch):
    """Each decode step leaves the KV cache as it was."""
    from repro_torch.models import model as M
    monkeypatch.setattr(M, "_paged_kv_write", lambda *a, **k: None)


def _token_altered(monkeypatch):
    """Every fifth step serves another token than the step's best."""
    from repro_torch.train import steps
    serve = steps.serve_step
    n = [0]

    def bad(model, tokens, cache, cfg, *a, **k):
        logits, cache = serve(model, tokens, cache, cfg, *a, **k)
        n[0] += 1
        if n[0] % 5 == 0:
            logits = logits.clone()
            logits[:, 1] = logits.max() + 1.0
        return logits, cache

    monkeypatch.setattr(steps, "serve_step", bad)


@pytest.mark.parametrize("fault", [_load_unchanged, _answer_altered])
@pytest.mark.parametrize("cell", SWAP_CELLS)
def test_a_broken_swap_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    run, e2e, per_layer = tiny_run(cell, seconds=1.0)
    r = execute(run, e2e, per_layer)
    assert r is not None and not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", [_kv_unchanged, _token_altered])
@pytest.mark.parametrize("cell", DECODE_CELLS)
def test_a_broken_decode_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    run, e2e, per_layer = tiny_run(cell, seconds=1.0)
    r = execute(run, e2e, per_layer)
    assert r is not None and not r["correct"], r["checks"]
    assert r["checks"]["served_logit_gap"]["value"] > r["checks"]["served_logit_gap"]["limit"]


def _quiet(*a, **k):
    pass


@pytest.mark.parametrize("cell", SWAP_CELLS)
def test_the_lossy_control_fails_the_swap_checks(cell):
    """The lossy codec planted in the program's backend, run through the
    harness: not correct; the program's codec is back afterwards."""
    import zlib

    from repro_torch.core import backend
    run, e2e, per_layer = tiny_run(cell, seconds=1.0)
    r = control.control_result(run, e2e, per_layer, log=_quiet)
    assert r is not None and not r["correct"], r["checks"]
    assert backend.zlib is zlib


def test_the_float8_control_reads_above_the_program():
    from taiji_bench.drivers.decode import GAP_LIMIT
    run, e2e, per_layer = tiny_run("qwen3-4b.decode-b32-native", seconds=2.0)
    r = execute(run, e2e, per_layer)
    assert r["correct"] and r["checks"]["served_logit_gap"]["value"] <= GAP_LIMIT
    run, e2e, per_layer = tiny_run("qwen3-4b.decode-b32-native", seconds=2.0)
    r = control.control_result(run, e2e, per_layer, log=_quiet)
    assert not r["correct"], r["checks"]
    assert r["checks"]["served_logit_gap"]["value"] > GAP_LIMIT


def test_a_forbidden_module_is_found_by_its_whole_top_level_name(monkeypatch):
    import sys

    from taiji_bench import bench
    assert "repro" not in bench.forbidden_modules()       # repro_torch is loaded
    monkeypatch.setitem(sys.modules, "repro", torch)
    assert bench.forbidden_modules() == ["repro"]
