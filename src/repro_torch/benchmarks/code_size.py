"""Module code size -- paper Table 2.

Paper LOC: MOD 2567 / Mpool 2492 / MS 3273 / VMX 9557 / Attr 3158 /
LRU 4202 / Sched 2755 / Swap 4101 / API 3063 (vs KVM 77k, Linux mm 151k).

Port: a copy of ``benchmarks/code_size.py`` that counts the port's own
files: ``core/*`` as the reference, and for Kernels the wrappers, their
plain versions, the build and the CUDA sources, where ``//`` comment
lines are skipped as ``#`` lines are. ``run(src=..., modules=...)``
counts any tree (the reference's gives the reference's numbers).
"""
from __future__ import annotations

from pathlib import Path

SRC = Path(__file__).resolve().parents[1]

MODULES = {
    "Mpool": ["core/mpool.py"],
    "MS": ["core/ms.py", "core/req.py", "core/rbtree.py"],
    "VMX": ["core/virt.py", "core/hotswitch.py"],
    "LRU": ["core/lru.py"],
    "Sched": ["core/scheduler.py"],
    "Swap": ["core/swap.py", "core/backend.py", "core/watermark.py"],
    "Upgrade": ["core/hotupgrade.py"],
    "API": ["core/system.py", "core/dma.py", "core/elastic_kv.py",
            "core/elastic_params.py", "core/metrics.py", "core/config.py"],
    "Kernels": ["kernels/ops.py", "kernels/ref.py", "kernels/_build.py",
                "csrc/swap_kernels.cu", "csrc/paged_attention.cu",
                "csrc/quantize.cu"],
}


def loc(path: Path) -> int:
    comment = "//" if path.suffix == ".cu" else "#"
    return sum(1 for line in path.read_text().splitlines()
               if line.strip() and not line.strip().startswith(comment))


def run(verbose: bool = True, src: Path = SRC, modules: dict = None) -> dict:
    out = {}
    for mod, files in (modules or MODULES).items():
        out[mod] = sum(loc(Path(src) / f) for f in files)
    total = sum(out.values())
    if verbose:
        print("module LOC (paper Table 2 analogue):")
        for mod, n in out.items():
            print(f"  {mod:8s} {n}")
        print(f"  total    {total}")
    out["total"] = total
    return out


def rows() -> list:
    r = run(verbose=False)
    return [("code_size_total_loc", r["total"],
             ",".join(f"{k}={v}" for k, v in r.items() if k != "total"))]


if __name__ == "__main__":
    run()
