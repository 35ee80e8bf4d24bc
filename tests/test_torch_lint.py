"""The port's concurrency lint (repro_torch.analysis.lint) against the
reference's: the reference's findings on the bad fixture, its exit
codes (0 on the port, which tests/test_torch_hygiene.py lints too), and a rank inversion among the lock classes only the port
declares (``guard`` at 72 over ``metrics`` at 70) that the reference's
lint, which reads the reference's hierarchy, cannot see."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test worker: see test_torch_hygiene.py

from repro.analysis import lint as ref_lint  # noqa: E402
from repro_torch.analysis import lint  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
BAD = ROOT / "tests" / "fixtures" / "lockdep_bad"

PLANTED = '''\
class AccessGuard:
    def bump(self, counts):
        with self._cond:
            with counts:   # lock: metrics
                pass
'''


def _key(f):
    # the port's TJL003 names the port's named_lock
    return (f.line, f.col, f.code, f.message.replace("repro_torch.", "repro."))


def test_port_lint_gives_the_references_findings_on_the_bad_fixture():
    got = lint.lint_paths([str(BAD)])
    want = ref_lint.lint_paths([str(BAD)])
    assert {f.code for f in got} == {"TJL001", "TJL002", "TJL003", "TJL004"}
    assert [_key(f) for f in got] == [_key(f) for f in want]


def test_planted_guard_over_metrics_is_flagged_by_the_port_lint_only(tmp_path):
    path = tmp_path / "planted.py"
    path.write_text(PLANTED)
    got = lint.lint_paths([str(path)])
    assert [(f.line, f.code) for f in got] == [(4, "TJL001")]
    assert "acquiring 'metrics' (rank 70) while holding 'guard' (rank 72)" \
        in got[0].message
    assert ref_lint.lint_paths([str(path)]) == []


@pytest.mark.parametrize("which,want", [("clean", 0), ("bad", 1), ("none", 2)])
def test_lint_cli_exit_codes(which, want, tmp_path):
    args = {"clean": [str(PORT)], "bad": [str(BAD)], "none": []}[which]
    assert lint.main(args) == want


def test_lint_runs_as_a_module(tmp_path):
    (tmp_path / "planted.py").write_text(PLANTED)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for path, rc in ((PORT / "analysis", 0), (tmp_path, 1)):
        proc = subprocess.run([sys.executable, "-m", "repro_torch.analysis.lint",
                               str(path)], env=env, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == rc, proc.stdout + proc.stderr
