"""Boundaries of the PyTorch/CUDA port: it imports neither JAX nor the
reference package, passes the reference's concurrency lint, builds every
lock from a declared class, and its chip smoke refuses to run without a
card."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
# One intra-op thread in every test worker. The suite runs in parallel
# workers, and torch's default of one OpenMP thread per core in each of
# them oversubscribes the host's cores, which starves the wall-clock
# share tests of the reference scheduler (tests/test_scheduler.py). Every
# test_torch_* file sets it at import.
torch.set_num_threads(1)

from repro.analysis.lint import lint_paths  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    bad = [(line, mod) for line, mod in _imported_modules(path)
           if mod.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path}: {bad}"


def test_importing_the_port_loads_no_jax_or_reference():
    code = ("import sys, repro_torch.core.system, repro_torch.kernels.ops, "
            "repro_torch.models.model, repro_torch.launch.serve, "
            "repro_torch.core.elastic_kv, repro_torch.train.steps, "
            "repro_torch.core.hotswitch, repro_torch.core.hotupgrade, "
            "repro_torch.examples.elastic_serving, "
            "repro_torch.core.elastic_params, repro_torch.fleet, "
            "repro_torch.fleet.trace, repro_torch.fleet.node, "
            "repro_torch.fleet.controller, repro_torch.fleet.harness, "
            "repro_torch.fleet.capture, repro_torch.benchmarks.fleet; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_passes_the_concurrency_lint():
    findings = lint_paths([str(PORT)])
    assert not findings, "\n".join(str(f) for f in findings)


def test_every_named_lock_has_a_declared_class():
    from repro_torch.analysis.lock_order import LOCK_CLASSES
    used = set()
    for path in PORT.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", None) == "named_lock"
                    and node.args and isinstance(node.args[0], ast.Constant)):
                used.add(node.args[0].value)
    assert used and used <= set(LOCK_CLASSES), used - set(LOCK_CLASSES)


def test_no_module_import_builds_or_launches():
    """The kernels build at first launch, never at import: the library
    handle stays unset after importing every module of the port."""
    code = ("import importlib, pathlib, sys; "
            "root = pathlib.Path(sys.argv[1]); "
            "[importlib.import_module('.'.join(p.relative_to(root.parent)"
            ".with_suffix('').parts).replace('.__init__', '')) "
            "for p in sorted(root.rglob('*.py'))]; "
            "from repro_torch.kernels import _build; "
            "sys.exit(_build._lib is not None)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code, str(PORT)], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_refuses_without_card_or_checkout(alone, tmp_path):
    """No result and a non-zero exit without a card; and on a card, a
    copy of the script with nothing else of the repo beside it fails too."""
    script = ROOT / "chip_smoke.py"
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_port_swap_path_under_the_witness():
    """The port's own lock-order witness sees no inversion while hv_sched
    reclaims (kernels' wrappers called from scheduler threads) under guest
    reads and writes of a pinned working set."""
    import numpy as np

    from repro_torch.analysis import lock_order, witness
    from repro_torch.core import TaijiSystem, small_test_config

    prev = lock_order.STATE.on
    lock_order.STATE.on = True
    witness.clear_violations()
    try:
        s = TaijiSystem(small_test_config(), device="cpu")
        try:
            rng = np.random.default_rng(7)
            cfg = s.cfg
            gfns = []
            for _ in range(int((cfg.n_phys_ms - cfg.mpool_reserve_ms) * 1.3)):
                g = s.guest.alloc_ms()
                s.guest.write(g, rng.integers(0, 4, cfg.ms_bytes,
                                              dtype=np.uint8).tobytes())
                gfns.append(g)
            hot = gfns[:3]
            with s.guest.pin(hot):
                s.start_background()
                try:
                    for i in range(300):
                        g = hot[i % 3]
                        s.guest.write(g, bytes([i % 251]) * 64, off=128)
                        assert s.guest.read(g, 64, off=128) == bytes([i % 251]) * 64
                finally:
                    s.stop_background()
            assert s.metrics.mp_swapped_out > 0
        finally:
            s.close()
        assert witness.clear_violations() == []
    finally:
        lock_order.STATE.on = prev
