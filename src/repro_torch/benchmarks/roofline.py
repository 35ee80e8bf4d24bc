"""Roofline table from the dry-run artifacts.

As ``benchmarks/roofline.py``: per (arch x shape x mesh) the three terms
in seconds, the dominant term, MODEL_FLOPS = 6*N*D (dense) /
6*N_active*D (MoE) for training and 2*N*D otherwise against the counted
FLOPs, and the per-cell bottleneck note. Reads the port's dry-run
artifacts (``python -m repro_torch.launch.dryrun --all``,
``build/repro_torch/dryrun/*.json``); the terms are those of one H100
running the whole step (989 TFLOP/s bf16, 3.35 TB/s; ``memory_s`` is
the eager byte count, an upper bound; no collective on one device).

Usage: ``PYTHONPATH=src python -m repro_torch.benchmarks.roofline``
"""
from __future__ import annotations

import glob
import json
from pathlib import Path

from ..configs import SHAPES, all_cells
from ..launch.dryrun import ART_DIR
from ..launch.op_count import HBM_BW, PEAK_FLOPS

_NOTES = {
    "compute_s": "raise arithmetic intensity / remove replicated compute",
    "memory_s": "fuse elementwise chains; cut activation traffic (kernels)",
    "collective_s": "re-shard to localize gathers; batch/overlap collectives",
}


def model_flops(rec: dict, shape_name: str) -> float:
    sh = SHAPES[shape_name]
    if sh.kind == "decode":
        tokens = sh.global_batch                 # one token per sequence
    else:
        tokens = sh.global_batch * sh.seq_len
    n = rec["active_params"]
    mult = 6.0 if sh.kind == "train" else 2.0
    return mult * n * tokens


def rows_for_mesh(mesh: str, art: Path = ART_DIR):
    out = []
    for f in sorted(glob.glob(str(art / f"*__{mesh}.json"))):
        d = json.load(open(f))
        la, r = d["loop_aware"], d["roofline"]
        mf = model_flops(d, d["shape"])
        total = la["flops_per_device"] * d["n_devices"]
        out.append({
            "arch": d["arch"], "shape": d["shape"], "mesh": mesh,
            "compute_s": r["compute_s"], "memory_s": r["memory_s"],
            "collective_s": r["collective_s"],
            "dominant": r["dominant"],
            "roofline_fraction": r["roofline_fraction"],
            "model_flops": mf,
            "useful_ratio": mf / total if total else 0.0,
            "memory_gb": d["memory_h100"]["total"] / 1e9,
            "note": _NOTES[r["dominant"]],
        })
    return out


_HILLCLIMB = [
    ("qwen3-4b", "decode_32k", "perseq"),
    ("qwen3-moe-235b-a22b", "train_4k", "groupedmoe"),
    ("qwen2.5-32b", "train_4k", "mesh32x8"),
]


def hillclimb_rows(art: Path = ART_DIR):
    """Before/after for the reference's three §Perf cells, where the dry
    run wrote both (``--variant``)."""
    out = []
    for arch, shape, variant in _HILLCLIMB:
        base = art / f"{arch}__{shape}__pod16x16.json"
        opt = art / f"{arch}__{shape}__pod16x16__{variant}.json"
        if not (base.exists() and opt.exists()):
            continue
        b = json.load(open(base))["roofline"]
        o = json.load(open(opt))["roofline"]
        out.append((arch, shape, variant, b, o))
    return out


def run(verbose: bool = True, art: Path = ART_DIR):
    table = rows_for_mesh("pod16x16", art)
    if verbose:
        print(f"# one H100: {PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16, "
              f"{HBM_BW / 1e12:.2f} TB/s; memory_s = eager bytes (upper bound)")
        hdr = (f"{'arch':22s} {'shape':12s} {'comp_s':>9s} {'mem_s':>9s} "
               f"{'coll_s':>7s} {'dominant':>10s} {'frac':>6s} {'useful':>7s} "
               f"{'mem_GB':>9s}")
        print(hdr)
        print("-" * len(hdr))
        for r in table:
            print(f"{r['arch']:22s} {r['shape']:12s} {r['compute_s']:9.4f} "
                  f"{r['memory_s']:9.4f} {r['collective_s']:7.3f} "
                  f"{r['dominant']:>10s} {r['roofline_fraction']:6.3f} "
                  f"{r['useful_ratio']:7.3f} {r['memory_gb']:9.1f}")
        skipped = [(a, s, why) for a, s, why in all_cells() if why]
        print(f"\nskipped cells ({len(skipped)}):")
        for a, s, why in skipped:
            print(f"  {a} x {s}: {why}")
        hc = hillclimb_rows(art)
        if hc:
            print("\n§Perf hillclimb cells (baseline -> variant, seconds):")
            for arch, shape, variant, b, o in hc:
                print(f"  {arch} x {shape} [{variant}]")
                for term in ("compute_s", "memory_s", "collective_s"):
                    print(f"    {term:13s} {b[term]:9.3f} -> {o[term]:9.3f}")
                print(f"    fraction      {b['roofline_fraction']:9.3f} -> "
                      f"{o['roofline_fraction']:9.3f}")
    return table


def rows(art: Path = ART_DIR) -> list:
    table = rows_for_mesh("pod16x16", art)
    return [(f"roofline_{r['arch']}_{r['shape']}", r["roofline_fraction"],
             f"dom={r['dominant']},useful={r['useful_ratio']:.3f}")
            for r in table]


if __name__ == "__main__":
    run()
