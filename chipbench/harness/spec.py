"""Finding a cell's parts by the names ``BENCHMARK.json`` gives them.

Everything that belongs to one configuration, traffic mix, metric or
kernel lies in a file of its own under ``chipbench/``:

* ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives), naming its
  ``entry`` (``entries/<entry>.py``) and its ``reference``
  (``reference/<reference>.py``);
* ``traffic/<mix>.json``;
* ``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``, each with
  ``read(record) -> float | None``;
* ``kernel_costs/<kernel>.py``, every one of which is loaded.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

from .traffic import check

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "chipbench"

__all__ = ["ROOT", "BENCH", "Cell", "check_keys", "load_cell", "load_file", "kernel_costs", "peaks"]


@dataclasses.dataclass
class Cell:
    name: str
    workload: Dict
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]  # BENCHMARK.json entries this cell reports with --trace 0
    per_layer: List[Dict]  # ... and with --trace 1
    run_seconds: int


def load_file(path: Path, name: str):
    """Import the Python file ``path`` as module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def check_keys(what: str, settings: Dict, known) -> None:
    """Refuse a setting that nothing reads: a file that sets it would
    otherwise run as though it had not."""
    unknown = sorted(set(settings) - set(known))
    if unknown:
        raise ValueError(f"{what}: no part of the harness reads {unknown}; it reads {sorted(known)}")


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = json.loads(benchmark.read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {benchmark.name}: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    traffic = check(json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text()))
    return Cell(
        name=name,
        workload=w,
        config=config,
        traffic=traffic,
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        run_seconds=int(bench["run_seconds"]),
    )


def entry(config: Dict):
    return importlib.import_module(f"chipbench.entries.{config['entry']}")


def reference(config: Dict):
    return importlib.import_module(f"chipbench.reference.{config['reference']}")


def reader(kind: str, metric: str):
    """The ``read`` function of ``<kind>/<metric>.py`` (a metric's name may
    hold dots, so the file is loaded by path)."""
    return load_file(BENCH / kind / f"{metric}.py", f"chipbench_{kind}_{metric}").read


def kernel_costs() -> Dict[str, object]:
    """{kernel: its cost module} for every file of ``kernel_costs/``."""
    return {p.stem: load_file(p, f"chipbench_kernel_costs_{p.stem}")
            for p in sorted((BENCH / "kernel_costs").glob("*.py"))}


def peaks() -> Dict:
    return json.loads((BENCH / "peaks.json").read_text())
