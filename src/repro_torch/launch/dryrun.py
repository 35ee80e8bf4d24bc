"""Dry run: size and count every (arch x shape) cell on the meta device.

As ``repro/launch/dryrun.py``, which lowers and compiles each runnable
cell's step on 512 fake host devices. The port runs on one device and
has no compiler to ask, so for each runnable cell this builds the real
step function (``train_step`` / ``prefill_step`` / ``serve_step``) at
full width and shape on the ``meta`` device -- shapes and dtypes only,
nothing executes, no card is needed -- and records:

  * FLOPs and bytes of every operator the step runs
    (:mod:`.op_count`), traced at two depths and extrapolated to the
    config's depth, and their roofline terms on one H100;
  * memory: parameters, gradients, AdamW moments, batch, decode cache
    and the activations saved for the backward (``saved_tensors_hooks``
    on the meta trace: those saved outside the per-layer checkpoints,
    plus one layer's recompute), against one H100's 80 GB; and per
    device on the reference's mesh, from the :class:`ShardingRules`
    specs' local shards (activations split over the batch axes only).

Artifacts land in ``build/repro_torch/dryrun/<arch>__<shape>__<mesh>.json``;
``repro_torch.benchmarks.roofline`` reads them.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from ..configs import SHAPES, ShapeSpec, all_cells, cell_skip_reason, get_config
from ..models import model as M
from ..models.config import ArchConfig
from ..train import steps
from . import op_count as OC
from . import specs as SP
from .mesh import AbstractMesh, make_production_mesh
from .sharding import ShardingRules, local_shape

ART_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch" / "dryrun"
H100_BYTES = 80e9


# §Perf hillclimb variants: config/mesh transforms applied on top of the
# baseline, as the reference's
def _v_per_seq_pool(cfg: ArchConfig) -> ArchConfig:
    return dataclasses.replace(cfg, kv_pool_layout="per_seq")


def _v_grouped_moe(cfg: ArchConfig) -> ArchConfig:
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, grouped_dispatch=True))


VARIANTS = {
    # cell A: paged-gather locality for elastic decode
    "perseq": (_v_per_seq_pool, None),
    # cell B: grouped MoE dispatch (shard-local sorts)
    "groupedmoe": (_v_grouped_moe, None),
    # cell C: same 256 chips, (32 data x 8 model) logical view so 40-head
    # attention shards (heads 40%8==0, kv 8%8==0, batch 256%32==0)
    "mesh32x8": (None, (32, 8)),
    "groupedmoe_mesh32x8": (_v_grouped_moe, (32, 8)),
}


def depths(cfg: ArchConfig) -> Tuple[int, int]:
    """Two depths a cell is traced at, in layers: one and two hybrid
    groups; two and three layers for a MoE config whose first layer is
    dense; else one and two."""
    if cfg.family == "hybrid":
        return cfg.hybrid_group, 2 * cfg.hybrid_group
    if M.first_dense(cfg):
        return 2, 3
    return 1, 2


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _SavedBytes:
    """Bytes of the tensors autograd saves for the backward (parameters
    left out: they are counted as parameters). Each tensor is held for
    the length of the trace, so its id is not given to a later one, and
    a tensor saved by two operators counts once.

    The hooks see no save made inside a non-reentrant checkpoint (the
    model's per-layer checkpoints, the SSM scan's per-chunk ones): the
    checkpoint installs its own hooks there, keeps nothing and recomputes
    those saves in the backward, where :func:`measure` counts one layer's
    of them. Nor do they see the backward's transients (the gradients in
    flight, the f32 logits' gradient), which the measured peak holds."""

    def __init__(self) -> None:
        self.saved: Dict[int, torch.Tensor] = {}

    def _pack(self, t: torch.Tensor) -> torch.Tensor:
        if not isinstance(t, torch.nn.Parameter):
            self.saved.setdefault(id(t), t)
        return t

    def hooks(self):
        return torch.autograd.graph.saved_tensors_hooks(self._pack, lambda t: t)

    @property
    def total(self) -> int:
        return sum(_nbytes(t) for t in self.saved.values())


def _trace(cfg: ArchConfig, shape: ShapeSpec) -> Tuple[OC.Cost, int]:
    """One meta trace of the cell's step at ``cfg``'s depth: its cost and
    the bytes autograd saved outside the checkpoints."""
    batch = SP.input_specs(cfg, shape)
    saved = _SavedBytes()
    if shape.kind == "train":
        state = SP.state_specs(cfg)
        with saved.hooks():
            _, cost = OC.count(steps.train_step, state, batch, cfg,
                               SP.opt_config(cfg))
        return cost, saved.total
    model = M.init_params(cfg, seed=0, device=SP.META)
    if shape.kind == "prefill":
        _, cost = OC.count(steps.prefill_step, model, batch, cfg)
    else:
        cache = SP.cache_specs(cfg, shape.global_batch, shape.seq_len)
        _, cost = OC.count(steps.serve_step, model, batch["tokens"], cache,
                           cfg, mrope_pos=batch.get("mrope_pos"))
    return cost, 0


def _saved_no_remat(cfg: ArchConfig, shape: ShapeSpec) -> int:
    """Bytes the forward saves without checkpoints (what a layer's
    recompute holds during its backward, per layer)."""
    model = M.init_params(cfg, seed=0, device=SP.META)
    saved = _SavedBytes()
    with saved.hooks():
        M.forward(model, cfg, SP.input_specs(cfg, shape), remat=False)
    return saved.total


def measure(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """The mesh-independent part of a cell: its cost at the config's
    depth from two traced depths, and the tensors and saved bytes that
    :func:`memory_bytes` sizes."""
    d1, d2 = depths(cfg)
    n = cfg.n_layers
    t0 = time.time()
    (c1, s1), (c2, s2) = (_trace(dataclasses.replace(cfg, n_layers=d), shape)
                          for d in (d1, d2))
    cost = OC.extrapolate(c1, d1, c2, d2, n)
    saved = s1 + (s2 - s1) * (n - d1) / (d2 - d1)
    unit = 0
    if shape.kind == "train":
        # the block a checkpoint recomputes: a layer, a hybrid group
        f1, f2 = (_saved_no_remat(dataclasses.replace(cfg, n_layers=d), shape)
                  for d in (d1, d2))
        unit = f2 - f1
    trace_s = time.time() - t0

    model = M.Model(cfg, M.DTYPES[cfg.param_dtype], SP.META)
    params = dict(model.named_parameters())
    batch = SP.input_specs(cfg, shape)
    cache = ({} if shape.kind != "decode" else
             SP.cache_specs(cfg, shape.global_batch, shape.seq_len))
    return {"cost": cost, "trace_s": trace_s, "depths": [d1, d2],
            "params": params, "batch": batch, "cache": cache,
            "saved_bytes": saved, "recompute_bytes": unit}


def memory_bytes(cfg: ArchConfig, shape: ShapeSpec, m: dict,
                 rules: Optional[ShardingRules]) -> dict:
    """Bytes of the cell's state, whole (``rules`` None: one device) or
    one device's shards on ``rules``' mesh."""
    def size(t, spec):
        if rules is None:
            return _nbytes(t)
        return (torch.Size(local_shape(t.shape, spec, rules.mesh)).numel()
                * t.element_size())

    pspec = bspec = cspec = {}
    act_split = 1
    if rules is not None:
        pspec = rules.param_pspecs(m["params"])
        bspec = rules.batch_pspecs(m["batch"])
        cspec = rules.cache_pspecs(m["cache"], shape.global_batch)
        b_ax = rules._fit(shape.global_batch, rules.batch_axes)
        for a in (b_ax if isinstance(b_ax, tuple) else (b_ax,)):
            act_split *= rules.mesh.shape.get(a, 1) if a else 1
    params = sum(size(p, pspec.get(k)) for k, p in m["params"].items())
    out = {"params": params}
    if shape.kind == "train":
        sdt = M.DTYPES[cfg.opt_dtype].itemsize / M.DTYPES[cfg.param_dtype].itemsize
        out["grads"] = params
        out["opt_moments"] = int(2 * params * sdt)
        out["activations_saved"] = int((m["saved_bytes"] + m["recompute_bytes"])
                                       / act_split)
    out["batch"] = sum(size(t, bspec.get(k)) for k, t in m["batch"].items())
    out["cache"] = sum(size(t, cspec.get(k)) for k, t in m["cache"].items())
    out["total"] = sum(out.values())
    out["fits_h100"] = out["total"] <= H100_BYTES
    return out


def mesh_name(multi_pod: bool, variant: str = "") -> str:
    name = "pod2x16x16" if multi_pod else "pod16x16"
    return f"{name}__{variant}" if variant else name


def cell_config(arch: str, multi_pod: bool, variant: str = ""
                ) -> Tuple[ArchConfig, AbstractMesh]:
    cfg = get_config(arch)
    mesh_shape = None
    if variant:
        fn, mesh_shape = VARIANTS[variant]
        if fn is not None:
            cfg = fn(cfg)
    if mesh_shape is not None:
        if multi_pod:
            raise ValueError("variant meshes are single-pod")
        return cfg, AbstractMesh(mesh_shape, ("data", "model"))
    return cfg, make_production_mesh(multi_pod=multi_pod)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             print_analysis: bool = True, variant: str = "",
             measured: Optional[dict] = None, art_dir: Path = ART_DIR) -> dict:
    """Count and size one cell, write its artifact; ``measured`` (from
    :func:`measure` on the same config and shape) skips the traces."""
    cfg, mesh = cell_config(arch, multi_pod, variant)
    shape = SHAPES[shape_name]
    m = measured if measured is not None else measure(cfg, shape)
    rules = ShardingRules(cfg, mesh, pod_axis="pod" if multi_pod else None)
    cost, n_dev = m["cost"], mesh.size
    terms = OC.roofline_terms(cost)
    result = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_name(multi_pod, variant),
        "n_devices": n_dev,
        "device": "meta",
        "depths_traced": m["depths"],
        "n_layers": cfg.n_layers,
        "trace_s": round(m["trace_s"], 2),
        "flops": cost.flops,
        "hbm_bytes": cost.hbm_bytes,
        # the whole step split evenly over the mesh (no collective)
        "loop_aware": {
            "flops_per_device": cost.flops / n_dev,
            "hbm_bytes_per_device": cost.hbm_bytes / n_dev,
            "collective_bytes_per_device": 0.0,
        },
        "roofline": terms,
        "top_ops_by_bytes": [[k, *v] for k, v in cost.top(10)],
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "memory_h100": memory_bytes(cfg, shape, m, None),
        "memory_per_device": memory_bytes(cfg, shape, m, rules),
    }
    if print_analysis:
        mem = result["memory_h100"]
        print(f"[{arch} x {shape_name} x {result['mesh']}] traced depths "
              f"{m['depths']} in {m['trace_s']:.1f}s")
        print("  flops=%.3e bytes=%.3e (whole step); memory one H100 %.2f GB "
              "(fits: %s), per device %.2f GB"
              % (cost.flops, cost.hbm_bytes, mem["total"] / 1e9,
                 mem["fits_h100"], result["memory_per_device"]["total"] / 1e9))
        print("  roofline (one H100): compute=%.3fs memory=%.3fs "
              "dominant=%s fraction=%.3f"
              % (terms["compute_s"], terms["memory_s"], terms["dominant"],
                 terms["roofline_fraction"]))
    art_dir.mkdir(parents=True, exist_ok=True)
    out = art_dir / f"{arch}__{shape_name}__{result['mesh']}.json"
    out.write_text(json.dumps(result, indent=2))
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", default="", choices=[""] + list(VARIANTS))
    args = ap.parse_args(argv)

    cells = []
    if args.all:
        for a, s, skip in all_cells():
            if skip:
                print(f"SKIP {a} x {s}: {skip}")
                continue
            cells.append((a, s))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        skip = cell_skip_reason(args.arch, args.shape)
        if skip:
            print(f"SKIP {args.arch} x {args.shape}: {skip}")
            return
        cells.append((args.arch, args.shape))

    meshes = [args.multi_pod] if not args.both_meshes else [False, True]
    failures = []
    t0 = time.time()
    for arch, shape in cells:
        measured = None             # the counts do not depend on the mesh
        for mp in meshes:
            name = mesh_name(mp, args.variant)
            if args.skip_existing and (
                    ART_DIR / f"{arch}__{shape}__{name}.json").exists():
                print(f"EXISTS {arch} x {shape} x {name}")
                continue
            try:
                if measured is None:
                    cfg, _ = cell_config(arch, mp, args.variant)
                    measured = measure(cfg, SHAPES[shape])
                run_cell(arch, shape, mp, variant=args.variant,
                         measured=measured)
            except Exception as e:  # record failures, keep going
                failures.append((arch, shape, name, repr(e)))
                print(f"FAIL {arch} x {shape} x {name}: {e}")
                traceback.print_exc()
    print(f"\n{len(cells)} cells in {time.time() - t0:.1f}s")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print("\nDRY-RUN OK")


if __name__ == "__main__":
    main()
