"""The comparison that decides ``correct`` fails what it must.

The controls (the plain reference one step worse, in the program's place)
at a size where a 16-bit ring's sums wrap, and the run itself, at 48 rows
on the CPU with its look for a card skipped, with the timed path broken
underneath: an answer altered where it is produced, a step that returns its
state unchanged (a filter that passes its table through), and half of a
stacked batch left out."""
import time

import numpy as np
import pytest
import torch

from chipbench.control import control_readings
from chipbench.harness import spec
from chipbench.harness.cell import run_cell

CONTROL_ROWS = {"rows": 4096, "patients": 1024}


@pytest.mark.parametrize("cell,control,number", [("paper_joins", "distinct_dropped", "wrong_answers"),
                                                 ("paper_joins", "ring16", "wrong_ring_answers"),
                                                 ("service_dashboard", "ring16", "wrong_answers"),
                                                 ("service_dashboard", "ring16", "wrong_ring_answers")])
def test_the_cells_control_is_not_correct(cell, control, number):
    c = spec.load_cell(cell)
    data = dict(c.config["data"], **CONTROL_ROWS)
    for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
        got = control_readings(c, control, seed, 24, data=data)
        assert not got["correct"] and got[number] > 0, got


def test_the_reference_in_its_own_place_is_correct():
    c = spec.load_cell("paper_joins")
    ref = spec.reference(c.config)
    plain = ref.make_tables(dict(c.config["data"], **CONTROL_ROWS), 5)
    from chipbench.control import as_revealed
    from chipbench.harness.judge import judge
    from chipbench.harness.record import Answer

    answers = [Answer(q, "a", 0, 0, rows=as_revealed(ref, q, ref.answer(q, plain)), ring_bits=32)
               for q in ref.QUERIES]
    assert judge(answers, ref, lambda q: ref.answer(q, plain), 32) == {
        "wrong_answers": 0, "missing_answers": 0, "wrong_ring_answers": 0}


def _run(name):
    cell = spec.load_cell(name)
    data = dict(cell.config["data"], rows=48, patients=12)
    return run_cell(cell, 2**31 + 21, 0.0, False, torch.device("cpu"), time.perf_counter(), data=data)[0]


@pytest.mark.parametrize("cell", ["paper_joins", "service_dashboard"])
def test_an_altered_answer_is_not_correct(cell, monkeypatch):
    from repro_torch.ops.table import SecretTable

    reveal = SecretTable.reveal_true_rows

    def altered(self):
        rows = reveal(self)
        first = next(iter(rows))
        if len(rows[first]):
            rows[first] = rows[first].copy()
            rows[first][0] ^= np.uint32(1)
        return rows

    monkeypatch.setattr(SecretTable, "reveal_true_rows", altered)
    out = _run(cell)
    assert not out["correct"] and out["checks"]["wrong_answers"]["value"] > 0


# the dashboard's templates filter nothing, so only the paper cell can have this fault
def test_a_filter_returning_its_table_unchanged_is_not_correct(monkeypatch):
    from repro_torch.plan import registry

    monkeypatch.setattr(registry, "oblivious_filter", lambda table, predicates, prf: table)
    out = _run("paper_joins")
    assert not out["correct"] and out["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("cell", ["paper_joins", "service_dashboard"])
def test_answers_from_a_narrower_ring_are_not_correct(cell, monkeypatch):
    # right answers, but from shares in 16-bit words: the stated ring is Z_2^32
    from chipbench.harness import record

    monkeypatch.setattr(record, "share_bits", lambda table: 16)
    for mod in ("engine_plans", "service_sql"):
        monkeypatch.setattr(f"chipbench.entries.{mod}.share_bits", lambda table: 16)
    out = _run(cell)
    checks = out["checks"]
    assert not out["correct"] and checks["wrong_ring_answers"]["value"] == out["attempted"]
    assert checks["wrong_answers"]["value"] == 0


def test_half_the_batch_left_out_is_not_correct(monkeypatch):
    from repro_torch.engine import Engine

    execute_batch = Engine.execute_batch
    warm = sum(spec.load_cell("service_dashboard").traffic["block"].values())
    calls = []

    def half(self, plans):
        # the warm passes run whole; in the window each stacked pass loses half its slots
        results = execute_batch(self, plans)
        calls.append(len(plans))
        return results if len(calls) <= warm else results[: len(results) // 2]

    monkeypatch.setattr(Engine, "execute_batch", half)
    out = _run("service_dashboard")
    assert not out["correct"] and out["checks"]["missing_answers"]["value"] == out["attempted"] // 2
