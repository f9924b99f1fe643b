"""Multi-pod dry-run: run every (arch x shape x mesh) cell's step, sharded,
on ``meta`` tensors over a fake process group, and count it.

A port of ``repro.launch.dryrun``. Where the reference lowers and compiles
each cell's jitted step on 512 XLA placeholder devices, the port opens a
fake process group of 256 or 512 ranks in this one process
(:func:`repro_torch.launch.mesh.fake_process_group`), builds the production
mesh over it and runs the step once over DTensors whose local shards are
``meta`` tensors: nothing is allocated, computed or sent, but every
operation and every collective DTensor issues happens. That the whole
sharded step runs is the per-cell proof, the counterpart of the reference's
lower-and-compile.

For every cell:
  * build abstract params / optimizer state / caches / batch (``meta``),
  * lay them out by ``repro_torch.sharding`` (params by
    ``make_param_specs``, AdamW moments by ``zero1_specs`` with
    ``cfg.zero1``, batch and caches by ``batch_specs`` / ``cache_specs``),
  * run the train / prefill / serve step under a :class:`StepCounter`,
  * record its FLOPs, bytes and collective bytes -> roofline terms
    (``launch/roofline.py``), and the per-device argument bytes,
  * append the row to a JSON artifact (``artifacts/dryrun_torch.json``)
    that ``launch/render_experiments.py`` renders into ``ROOFLINE_TORCH.md``.

The port walks the layer groups in a Python loop (``scan_layers`` is a
no-op), so the counter sees every layer of the full depth and ``run_cell``
needs no extrapolation in depth. The reference's 1-group / 2-group
extrapolation (which exists because ``lax.scan`` hides the body's cost from
XLA's cost analysis) is kept as :func:`extrapolated_costs`: on a
depth-homogeneous stack it equals the full-depth count. In time, the
sLSTM's 4,096-32,768 steps are not walked through DTensor: a step whose
model has an sLSTM layer is counted at walks of 4 and 8 time steps and
extrapolated (:func:`count_step`), which equals the full walk.

On the multi-pod mesh the batch spans two mesh axes; there the models run
the attention core on local shards and their einsums, MoE layers and sLSTM
layers on the mesh's view with the batch axes merged
(``repro_torch.sharding.placement``), so DTensor never plans through a
strided shard.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun                      # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral_8x7b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --multi-pod-only
  PYTHONPATH=src python -m repro_torch.launch.dryrun --merge parts/*.json  # rows of cells run apart
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Dict, Iterator, Optional

import torch

from ..configs import ARCH_IDS, get_config
from ..configs.shapes import SHAPE_DEFS, SHAPE_NAMES, input_specs, shape_applicable
from ..models import abstract_params
from ..models.recurrent import slstm_walk
from ..serve.serve_step import make_prefill_step, make_serve_step
from ..sharding import batch_specs, cache_specs, distribute_tree, make_param_specs, sharded_region
from ..train import AdamWConfig, adamw_init, make_train_step, place_train_state
from .mesh import PRODUCTION_MESHES, fake_process_group, make_mesh, mesh_chips
from .roofline import (
    Roofline,
    StepCounter,
    analytic_bytes_for,
    cost_analysis_of,
    local_bytes,
    memory_analysis_of,
    model_flops_for,
)

ARTIFACT = os.path.join(os.path.dirname(__file__), "..", "..", "..", "artifacts")


@contextlib.contextmanager
def meta_equal() -> Iterator[None]:
    """``torch.equal`` on ``meta`` tensors answers True while active. It has
    no meta kernel, and DTensor's vocab-sharded embedding checks its mask
    with it in backward; on ``meta`` there is no data to differ."""
    lib = torch.library.Library("aten", "IMPL")
    lib.impl("equal", lambda a, b: True, "Meta")
    try:
        yield
    finally:
        lib._destroy()


def build_cell(arch: str, shape_name: str, mesh, opt_overrides: Optional[Dict] = None):
    """Returns (cfg, step, args) for one cell: ``step(*args)`` runs it over
    DTensors on ``mesh`` whose shards are ``meta`` tensors."""
    cfg = get_config(arch)
    if opt_overrides:
        cfg = dataclasses.replace(cfg, **opt_overrides)
    spec = input_specs(cfg, shape_name)
    params = abstract_params(cfg)
    batch = distribute_tree(spec["batch"], batch_specs(cfg, spec["batch"], mesh), mesh)

    if spec["step"] == "train":
        params, opt_state = place_train_state(cfg, params, adamw_init(params), mesh)
        return cfg, make_train_step(cfg, AdamWConfig()), (params, opt_state, batch)
    params = distribute_tree(params, make_param_specs(cfg, params, mesh), mesh)
    if spec["step"] == "prefill":
        return cfg, make_prefill_step(cfg), (params, batch)
    caches = distribute_tree(spec["caches"], cache_specs(cfg, spec["caches"], mesh), mesh)
    return cfg, make_serve_step(cfg), (params, caches, batch)


# the two sLSTM walk lengths a long step is counted at (see count_step)
SLSTM_WALKS = (4, 8)


def walked_steps(cfg, shape_name: str) -> Optional[int]:
    """The time steps each sLSTM layer of the cell walks, where its count
    is extrapolated in time (a train or prefill step of a model with an
    sLSTM layer, longer than the walks); else None."""
    d = SHAPE_DEFS[shape_name]
    if "S" not in cfg.block_pattern or d["step"] == "decode" or d["seq"] <= SLSTM_WALKS[-1]:
        return None
    return d["seq"]


def count_step(step, args, steps: Optional[int] = None) -> StepCounter:
    """Run ``step(*args)`` once under a :class:`StepCounter`.

    With ``steps`` (:func:`walked_steps`), the whole step runs once at each
    of ``SLSTM_WALKS``, its sLSTM layers walking that many time steps
    (``slstm_walk``), and each count is extrapolated linearly to ``steps``:
    the time counterpart of :func:`extrapolated_costs`. A count that is not
    linear in the walk raises."""
    if steps is None:
        with meta_equal(), sharded_region(True), StepCounter() as counter:
            step(*args)
        return counter
    counts = []
    for n in SLSTM_WALKS:
        with slstm_walk(n), meta_equal(), sharded_region(True), StepCounter() as counter:
            step(*args)
        counts.append(counter)
    return _in_time(counts, steps)


def _in_time(counts, steps: int) -> StepCounter:
    """The counts at ``SLSTM_WALKS``, extrapolated to ``steps`` walked."""
    (n1, n2), (c1, c2) = SLSTM_WALKS, counts

    def lin(a: int, b: int, what: str) -> int:
        slope, rest = divmod(b - a, n2 - n1)
        if rest:
            raise RuntimeError(f"the sLSTM walk's {what} is not linear in its length: {a} at {n1}, {b} at {n2}")
        return a + slope * (steps - n1)

    out = StepCounter()
    out.flops = lin(c1.flops, c2.flops, "FLOPs")
    out.bytes = lin(c1.bytes, c2.bytes, "bytes")
    out.ops = lin(c1.ops, c2.ops, "operations")
    for field in ("bytes_by_kind", "count_by_kind"):
        one, two = getattr(c1.collectives, field), getattr(c2.collectives, field)
        setattr(out.collectives, field,
                {k: lin(one.get(k, 0), two.get(k, 0), f"{k} {field}") for k in sorted(set(one) | set(two))})
    return out


def _measure(arch, shape_name, mesh, n_layers, opt_overrides) -> Dict:
    """The counted costs of the cell cut to ``n_layers`` layers."""
    ov = dict(opt_overrides or {})
    ov["n_layers"] = n_layers
    cfg, step, args = build_cell(arch, shape_name, mesh, ov)
    counter = count_step(step, args, walked_steps(cfg, shape_name))
    ca = cost_analysis_of(counter)
    coll = counter.collectives
    return {
        "flops": float(ca["flops"]),
        "bytes": float(ca["bytes accessed"]),
        "coll_bytes": float(coll.total_bytes),
        "coll_by_kind": dict(coll.bytes_by_kind),
        "coll_counts": dict(coll.count_by_kind),
    }


def extrapolated_costs(arch, shape_name, mesh, opt_overrides=None) -> Dict:
    """One device's costs of the cell at full depth, extrapolated linearly
    from counts at one and two pattern groups, as the reference does:
    ``total = (c2 - c1) * groups + (2 c1 - c2)``, each term floored at 0.
    The depth is ``opt_overrides``' ``n_layers`` where it sets one."""
    cfg = get_config(arch)
    if opt_overrides:
        cfg = dataclasses.replace(cfg, **opt_overrides)
    period = cfg.pattern_period
    c1 = _measure(arch, shape_name, mesh, period, opt_overrides)
    c2 = _measure(arch, shape_name, mesh, 2 * period, opt_overrides)
    g = cfg.n_layers // period

    def lin(a, b):
        return max(b - a, 0) * g + max(2 * a - b, 0)

    return {
        "flops": lin(c1["flops"], c2["flops"]),
        "bytes": lin(c1["bytes"], c2["bytes"]),
        "coll_bytes": lin(c1["coll_bytes"], c2["coll_bytes"]),
        "coll_by_kind": {k: lin(c1["coll_by_kind"][k], c2["coll_by_kind"][k]) for k in c1["coll_by_kind"]},
        "coll_counts": {k: lin(c1["coll_counts"][k], c2["coll_counts"][k]) for k in c1["coll_counts"]},
    }


def run_cell(
    arch: str, shape_name: str, multi_pod: bool, opt_overrides: Optional[Dict] = None
) -> Dict:
    mesh_name = "2x16x16" if multi_pod else "16x16"
    cfg = get_config(arch)
    ok, why = shape_applicable(cfg, shape_name)
    if not ok:
        return {
            "arch": arch, "shape": shape_name, "mesh": mesh_name,
            "status": "skipped", "reason": why,
        }
    t0 = time.time()
    shape, names = PRODUCTION_MESHES[multi_pod]
    try:
        with fake_process_group(math.prod(shape)):
            mesh = make_mesh(shape, names, device_type="cpu")
            cfg2, step, args = build_cell(arch, shape_name, mesh, opt_overrides)
            t_build = time.time() - t0
            argument_bytes = local_bytes(args)
            steps = walked_steps(cfg2, shape_name)
            counter = count_step(step, args, steps)
            chips = mesh_chips(mesh)
        ca = cost_analysis_of(counter)
        coll = counter.collectives
        r = Roofline(
            arch=arch,
            shape=shape_name,
            mesh=mesh_name,
            chips=chips,
            hlo_flops=ca["flops"] * chips,
            hlo_bytes=ca["bytes accessed"] * chips,
            collective_bytes=coll.total_bytes * chips,
            collectives={k: v * chips for k, v in coll.bytes_by_kind.items()},
            collective_counts=dict(coll.count_by_kind),
            model_flops=model_flops_for(cfg2, shape_name),
            bytes_per_device=float(argument_bytes),
        )
        row = r.row()
        row.update(
            {
                "status": "ok",
                "build_s": t_build,
                "compile_s": time.time() - t0,  # the step's run stands in for the compile
                "total_s": time.time() - t0,
                "memory_analysis": memory_analysis_of(argument_bytes),
                "ops": int(ca["ops"]),
                "analytic_bytes": analytic_bytes_for(cfg2, shape_name),
                # the sLSTM's time steps counted at SLSTM_WALKS and extrapolated
                "slstm_walks": list(SLSTM_WALKS) if steps else None,
            }
        )
        return row
    except Exception as e:  # a cell that fails is a row of the artifact, not the end of the sweep
        return {
            "arch": arch, "shape": shape_name, "mesh": mesh_name,
            "status": "error", "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-2000:],
            "compile_s": time.time() - t0,
        }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--out", default=os.path.join(ARTIFACT, "dryrun_torch.json"))
    ap.add_argument("--append", action="store_true")
    ap.add_argument("--merge", nargs="+", default=None,
                    help="artifacts of cells run apart (one process each): write their rows into --out, run none")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else SHAPE_NAMES
    meshes = [False, True]
    if args.single_pod_only:
        meshes = [False]
    if args.multi_pod_only:
        meshes = [True]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    rows = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            rows = json.load(f)

    if args.merge:
        for path in args.merge:
            with open(path) as f:
                rows += [r for r in json.load(f) if (r["arch"], r["shape"], r["mesh"]) not in
                         {(q["arch"], q["shape"], q["mesh"]) for q in rows}]
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
        archs = []

    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = (arch, shape, "2x16x16" if mp else "16x16")
                if any((r["arch"], r["shape"], r["mesh"]) == key for r in rows):
                    continue
                row = run_cell(arch, shape, mp)
                rows.append(row)
                status = row["status"]
                extra = ""
                if status == "ok":
                    extra = (
                        f"run={row['compile_s']:.1f}s flops={row['hlo_flops']:.3g} "
                        f"coll={row['collective_bytes']:.3g}B bottleneck={row['bottleneck']}"
                    )
                elif status == "error":
                    extra = row["error"][:160]
                else:
                    extra = row["reason"][:80]
                print(f"[{status:>7}] {arch:<20} {shape:<12} {key[2]:<8} {extra}", flush=True)
                with open(args.out, "w") as f:
                    json.dump(rows, f, indent=1)

    n_ok = sum(r["status"] == "ok" for r in rows)
    n_err = sum(r["status"] == "error" for r in rows)
    n_skip = sum(r["status"] == "skipped" for r in rows)
    print(f"\ndone: {n_ok} ok, {n_skip} skipped (documented), {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
