"""Renders the port's roofline table (and per-arch bottleneck sentences) from
``artifacts/dryrun_torch.json``, and its perf log from
``artifacts/perf_torch_*.json``, into ``ROOFLINE_TORCH.md``.

A port of ``repro.launch.render_experiments``, into a page of its own: the
two sections sit between their own begin/end markers, so the page renders
again in place; a missing page is created with the markers. Every time on
the page is a bound computed from the H100's data-sheet constants
(``launch/roofline.py``) over counted work, not a measurement.

  PYTHONPATH=src python -m repro_torch.launch.render_experiments
"""
from __future__ import annotations

import glob
import json
import os
from typing import List

from .roofline import CARD, HBM_BW, IB_BW, NODE_GPUS, NVLINK_BW, PEAK_FLOPS

ROOT = os.path.join(os.path.dirname(__file__), "..", "..", "..")
ART = os.path.join(ROOT, "artifacts", "dryrun_torch.json")
PAGE = os.path.join(ROOT, "ROOFLINE_TORCH.md")

TABLE = ("<!-- ROOFLINE_TORCH_TABLE -->", "<!-- /ROOFLINE_TORCH_TABLE -->")
PERF = ("<!-- PERF_TORCH_SECTION -->", "<!-- /PERF_TORCH_SECTION -->")

MOVE_SENTENCES = {
    "compute": "drop remat / raise per-chip batch to amortize — t_compute bound",
    "memory": "fuse elementwise chains to cut HBM round-trips; bigger microbatch raises intensity",
    "collective": "reshard (smaller TP extent / EP capacity trim) to cut moved bytes",
}


def fmt(x: float) -> str:
    return f"{x:.2e}"


def cpu_seconds(r) -> str:
    """The cell's seconds on the CPU that ran the dry-run, and how its
    sLSTM was counted where the walk was extrapolated in time."""
    out = f"{r['total_s']:.1f}" if "total_s" in r else ""
    if r.get("slstm_walks"):
        out += " (sLSTM walks {} and {}, extrapolated)".format(*r["slstm_walks"])
    return out


def roofline_table(rows) -> str:
    header = (
        "| arch | shape | mesh | t_comp (s) | t_mem (s) | t_coll (s) | bound | "
        "MODEL/counted flops | roofline frac | args/device (GiB) | CPU s |\n"
        "|---|---|---|---|---|---|---|---|---|---|---|\n"
    )
    lines = []
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        if r["status"] == "skipped":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | — | — | — | N/A | — | — | — |"
            )
            continue
        if r["status"] != "ok":
            lines.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} | ERROR | | | | | | |"
            )
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {fmt(r['t_compute_s'])} | "
            f"{fmt(r['t_memory_s'])} | {fmt(r['t_collective_s'])} | {r['bottleneck']} | "
            f"{r['useful_flops_ratio']:.2f} | {r['roofline_fraction']:.4f} | "
            f"{r['bytes_per_device'] / 2**30:.2f} | {cpu_seconds(r)} |"
        )
    return header + "\n".join(lines)


def per_arch_summary(rows) -> str:
    """One sentence per (arch, single-pod cell): dominant term + what would
    move it; then the cells that failed, with their errors."""
    out = ["\n**Per-cell bottleneck notes (single-pod):**\n"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r["mesh"] != "16x16" or r["status"] != "ok":
            continue
        b = r["bottleneck"]
        out.append(
            f"- `{r['arch']}/{r['shape']}`: {b}-bound "
            f"(tc={fmt(r['t_compute_s'])}, tm={fmt(r['t_memory_s'])}, "
            f"tx={fmt(r['t_collective_s'])}); MODEL_FLOPS/counted={r['useful_flops_ratio']:.2f} — "
            f"{MOVE_SENTENCES[b]}."
        )
    errors = [r for r in rows if r["status"] == "error"]
    if errors:
        out.append("\n**Cells that did not run:**\n")
        for r in sorted(errors, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
            out.append(f"- `{r['arch']}/{r['shape']}/{r['mesh']}`: {' '.join(r['error'].split())[:200]}")
    return "\n".join(out)


def perf_section(files: List[str]) -> str:
    if not files:
        return "_(hillclimb artifacts not yet generated)_"
    parts = []
    for f in sorted(files):
        with open(f) as fh:
            rows = json.load(fh)
        cell = os.path.basename(f)[len("perf_torch_"):-len(".json")]
        parts.append(f"\n### {cell}\n")
        base = next((r for r in rows if r["variant"] == "baseline" and r["status"] == "ok"), None)
        parts.append(
            "| variant | hypothesis | t_comp | t_mem | t_coll | bound | frac | verdict |\n"
            "|---|---|---|---|---|---|---|---|"
        )
        for r in rows:
            if r["status"] != "ok":
                parts.append(f"| {r['variant']} | {r.get('hypothesis', '')[:60]} | ERROR | | | | | |")
                continue
            verdict = ""
            if base and r is not base:
                d = (r["roofline_fraction"] - base["roofline_fraction"]) / max(
                    base["roofline_fraction"], 1e-12
                )
                verdict = f"{'+' if d >= 0 else ''}{d * 100:.1f}% frac"
            parts.append(
                f"| {r['variant']} | {r.get('hypothesis', '')[:60]} | "
                f"{fmt(r['t_compute_s'])} | {fmt(r['t_memory_s'])} | "
                f"{fmt(r['t_collective_s'])} | {r['bottleneck']} | "
                f"{r['roofline_fraction']:.4f} | {verdict} |"
            )
    return "\n".join(parts)


def new_page() -> str:
    return f"""# Roofline of the PyTorch port on H100 meshes

Rendered by `python -m repro_torch.launch.render_experiments` from
`python -m repro_torch.launch.dryrun` (`artifacts/dryrun_torch.json`) and
`python -m repro_torch.launch.hillclimb` (`artifacts/perf_torch_*.json`).

**These times are bounds, not measurements.** Each cell's sharded step ran
once over `meta` tensors on a fake process group of 256 (16x16) or 512
(2x16x16) ranks; its one-device matmul FLOPs, unfused operation bytes and
collective operand bytes were counted, times the chips, and divided by the
data-sheet rates of an {CARD}: {PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16 dense,
{HBM_BW / 1e12:.2f} TB/s HBM3, a link of {NVLINK_BW / 1e9:.0f} GB/s a
direction (NVLink 4) for meshes of up to {NODE_GPUS} GPUs and
{IB_BW / 1e9:.0f} GB/s (InfiniBand NDR) beyond. No card ran these steps.

## Roofline

{TABLE[0]}
{TABLE[1]}

## Perf log (hillclimb variants)

{PERF[0]}
{PERF[1]}
"""


def replace_between(text: str, markers, body: str) -> str:
    begin, end = markers
    i, j = text.index(begin) + len(begin), text.index(end)
    return text[:i] + "\n" + body + "\n" + text[j:]


def render(rows, perf_files: List[str], page: str) -> str:
    """Writes ``page`` with the two sections rendered from ``rows`` and the
    hillclimb files, and returns its text."""
    text = open(page).read() if os.path.exists(page) else new_page()
    text = replace_between(text, TABLE, roofline_table(rows) + "\n" + per_arch_summary(rows))
    text = replace_between(text, PERF, perf_section(perf_files))
    with open(page, "w") as f:
        f.write(text)
    return text


def main() -> None:
    with open(ART) as f:
        rows = json.load(f)
    render(rows, glob.glob(os.path.join(ROOT, "artifacts", "perf_torch_*.json")), PAGE)
    print(f"rendered {sum(r['status'] == 'ok' for r in rows)} ok / "
          f"{sum(r['status'] == 'skipped' for r in rows)} skipped / "
          f"{sum(r['status'] == 'error' for r in rows)} error cells into ROOFLINE_TORCH.md")


if __name__ == "__main__":
    main()
