"""Each cell's run at a tiny size on the CPU: the result line's keys, the
end-to-end or per-layer metrics it reports, and `correct` true, i.e.
the program agrees with the plain references (the NumPy memory model;
the float32 qwen3 forward)."""
import json
import subprocess
import sys

import pytest
import torch

from taiji_bench import bench
from taiji_bench.reference import qwen3
from taiji_bench.drivers import decode
from taiji_bench.tests.tiny import ROOT, execute, tiny_qwen, tiny_run

CELLS = [w["name"] for w in bench.spec()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_a_tiny_run_is_correct_and_reports_its_metrics(cell, trace):
    run, e2e, per_layer = tiny_run(cell, seconds=1.0, trace=trace)
    r = execute(run, e2e, per_layer)
    assert list(r) == KEYS + ["checks"]          # breakdown only from a card trace
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    want = {m["name"] for m in (per_layer if trace else e2e)}
    # the device readers find nothing to read on the CPU, and say nothing
    device = {m["name"] for m in per_layer if m["source"] == "device_trace"}
    assert set(r["metrics"]) == want - (device if trace else set())
    for m in r["metrics"].values():
        assert m["value"] == m["value"] and m["unit"]
    json.dumps(r)


def test_the_reference_forward_agrees_with_the_programs_decode():
    """float32 weights: the program's token-by-token decode through its
    paged cache and the plain forward give the same logits."""
    from repro_torch.models import model as M
    from repro_torch.train.steps import serve_step
    config = tiny_qwen("float32")
    cfg = decode.arch_config(config)
    w = decode.make_weights(config, 7, "cpu")
    model = decode.program_model(cfg, w)
    cache = M.init_cache(cfg, 2, 32, dtype=torch.float32, device="cpu")
    toks = torch.randint(0, config["vocab_size"], (2, 20), generator=torch.Generator().manual_seed(3))
    got = []
    for t in range(20):
        logits, cache = serve_step(model, toks[:, t], cache, cfg)
        got.append(logits)
    got = torch.stack(got, 1)
    ref = qwen3.Forward(config, w.__getitem__)
    for b in range(2):
        h = ref.hidden([toks[b]])[0]
        want = ref.logits(h)
        assert torch.allclose(got[b], want, atol=1e-4, rtol=1e-4), \
            (got[b] - want).abs().max()


def test_run_py_without_a_card_exits_nonzero_and_prints_no_result():
    p = subprocess.run([sys.executable, str(ROOT / "taiji_bench" / "run.py"),
                        "--workload", "paper2m.swap-bulk", "--seed", "5",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and not p.stdout.strip()


def test_a_checkout_without_the_program_prints_no_result(tmp_path):
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "taiji_bench", tmp_path / "taiji_bench")
    p = subprocess.run([sys.executable, "taiji_bench/run.py", "--workload",
                        "paper2m.swap-bulk", "--seed", "5", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, cwd=tmp_path)
    assert p.returncode != 0 and not p.stdout.strip()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card_is_correct(cell, card):
    p = subprocess.run([sys.executable, "taiji_bench/run.py", "--workload", cell,
                        "--seed", str(2**31 + 3), "--seconds", "2", "--trace", "0"],
                       capture_output=True, text=True, cwd=ROOT, timeout=1200)
    assert p.returncode == 0, p.stderr[-2000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu" and r["device"]["kind"] == card
