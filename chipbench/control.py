#!/usr/bin/env python3
"""Run a control in the program's place and show the comparison fails it.

    python3 chipbench/control.py --workload <cell> --control <name> --queries <n> --seeds <s> [<s> ...]

For each seed: the cell's tables at the configuration's size and its traffic
order, as a run draws them; for each of the first ``n`` answers of that
order, the control's answer (``chipbench/reference/controls.py``) stands
where the program's would, and the run's judge compares it with the
reference's, and holds it to the configuration's ring as it holds the
program's (the control's answers are computed in its own ring). Prints one
JSON line a seed with the numbers compared and ``correct``. The control is plain NumPy: the program does not run, and the
benchmark's own runs never run this.
"""
import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from chipbench.harness import spec  # noqa: E402
from chipbench.harness.judge import LIMITS, judge  # noqa: E402
from chipbench.harness.record import Answer  # noqa: E402
from chipbench.harness.traffic import blocks  # noqa: E402
from chipbench.reference.controls import CONTROL_RING_BITS, control_answer  # noqa: E402


def as_revealed(reference, query: str, rows: list) -> dict:
    """Canonical rows back into revealed columns (an ORDER BY's in its order)."""
    cols = reference.REVEALED_COLUMNS[query]
    by = getattr(reference, "ORDERED_BY", {}).get(query)
    if by is not None:
        rows = sorted(rows, key=lambda r: -r[cols.index(by)])
    return {c: np.array([r[i] for r in rows], dtype=np.int64) for i, c in enumerate(cols)}


def control_readings(cell: spec.Cell, control: str, seed: int, n_queries: int, data=None) -> dict:
    ref = spec.reference(cell.config)
    plain = ref.make_tables(data or cell.config["data"], seed)
    clients = int(cell.traffic.get("clients", 1))
    answers, rounds = [], blocks(cell.traffic, seed)
    while len(answers) < n_queries:
        for q in next(rounds):
            rows = as_revealed(ref, q, control_answer(control, q, plain))
            answers.extend(Answer(q, f"client_{i}", 0.0, 0.0, rows=rows, ring_bits=CONTROL_RING_BITS[control])
                           for i in range(clients))
    checks = judge(answers[:n_queries], ref, lambda q: ref.answer(q, plain),
                   int(cell.config["guarantees"]["ring_bits"]))
    return {"seed": seed, "control": control, "answers": n_queries, **checks,
            "correct": all(checks[k] <= LIMITS[k] for k in LIMITS)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--control", required=True)
    p.add_argument("--queries", type=int, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(control_readings(cell, args.control, seed, args.queries)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
