"""The harness on the CPU at 48 rows through the port's plain kernels: a
cell's closed loop, its metric arithmetic and its last line; the traffic
generator; and BENCHMARK.json against the contract's rules."""
import json
import re
import time

import pytest
import torch

from chipbench.harness import spec
from chipbench.harness.cell import run_cell
from chipbench.harness.traffic import blocks, queries

SMALL = {"rows": 48, "patients": 12}


def _run(name, seconds=0.3, trace=False):
    cell = spec.load_cell(name)
    data = dict(cell.config["data"], **SMALL)
    t0 = time.perf_counter()
    return cell, run_cell(cell, 2**31 + 11, seconds, trace, torch.device("cpu"), t0, data=data)


@pytest.fixture(scope="module")
def service_run():
    return _run("service_dashboard")


def test_last_line_keys_and_checks(service_run):
    cell, (out, rec) = service_run
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] and out["failed"] == 0 and out["attempted"] == len(rec.answers)
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert out["checks"] == {"wrong_answers": {"value": 0, "limit": 0}, "missing_answers": {"value": 0, "limit": 0},
                             "wrong_ring_answers": {"value": 0, "limit": 0}}
    assert {a.ring_bits for a in rec.answers} == {32}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    json.dumps(out)


def test_rate_is_all_the_work_over_all_the_time(service_run):
    _, (out, rec) = service_run
    assert rec.window_s == pytest.approx(rec.answers[-1].t_done - rec.t_start)
    assert all(a.t_submit >= rec.t_start for a in rec.answers)
    assert out["metrics"]["queries_per_s"]["value"] == pytest.approx(len(rec.good) / rec.window_s)
    # whole blocks of whole rounds: every tenant answered in every round
    assert len(rec.answers) % (8 * len(queries(rec.traffic))) == 0
    assert rec.window_s >= 0.3 and all(a.slots == 8 for a in rec.answers)


def test_traced_run_reports_per_layer_metrics():
    cell, (out, rec) = _run("paper_joins", seconds=0.0, trace=True)
    assert out["correct"]
    got = out["metrics"]
    # the CPU has no device trace: only the program's own readings remain
    assert set(got) == {"engine_share_pct", "join_ms_per_query", "resize_ms_per_query", "comm_mb_per_query"}
    total = sum(a.report.total_seconds for a in rec.answers)
    assert got["engine_share_pct"]["value"] == pytest.approx(100 * total / rec.window_s)
    assert got["comm_mb_per_query"]["value"] == pytest.approx(
        sum(a.report.total_bytes for a in rec.answers) / len(rec.answers) / 1e6)


def test_trace_covers_the_windows_last_rounds():
    cell = spec.load_cell("service_dashboard")
    cell.traffic = dict(cell.traffic, trace_seconds=0.4)
    data = dict(cell.config["data"], **SMALL)
    out, rec = run_cell(cell, 2**31 + 12, 0.8, True, torch.device("cpu"), time.perf_counter(), data=data)
    assert out["correct"] and rec.t_start < rec.t_trace
    # whole rounds of eight tenants, from the first that starts after 0.8 - 0.4 s to the end
    assert 0 < len(rec.traced) < len(rec.answers) and len(rec.traced) % 8 == 0
    assert rec.traced == rec.answers[-len(rec.traced):]
    assert rec.answers[-len(rec.traced) - 1].t_submit < rec.t_trace
    assert rec.t_trace - rec.t_start >= 0.4


def test_every_block_is_the_same_work():
    # engines made anew each block: a query draws the same Resizer noise, so
    # sends the same bytes, in every block, under every seed and in any order
    from chipbench.harness.cell import share
    from chipbench.harness.record import Spans

    cell = spec.load_cell("paper_joins")
    ref, data = spec.reference(cell.config), dict(cell.config["data"], **SMALL)
    sent = {}
    for seed, order in ((2**31 + 11, ["dosage_study", "aspirin_count"]), (2**31 + 12, ["aspirin_count", "dosage_study"])):
        plain = ref.make_tables(data, seed)
        entry = spec.entry(cell.config).Entry(cell.config, cell.traffic, share(plain, seed, "cpu"), plain, "cpu",
                                              Spans(False))
        for _ in range(2):
            entry.start_block()
            for q in order * 2:
                sent.setdefault(q, []).extend(a.report.total_bytes for a in entry.round(q))
    for q, got in sent.items():
        assert len(got) == 8 and got[0::2] == [got[0]] * 4 and got[1::2] == [got[1]] * 4, (q, got)
        assert got[0] != got[1]  # the block's second execution draws other noise


def test_blocks_hold_the_same_work_in_a_seeded_order():
    traffic = spec.load_cell("service_dashboard").traffic
    a, b = blocks(traffic, 2**31 + 1), blocks(traffic, 2**31 + 2)
    first = [next(a) for _ in range(6)]
    again = blocks(traffic, 2**31 + 1)
    assert first == [next(again) for _ in range(6)]
    other = [next(b) for _ in range(6)]
    assert first != other
    for blk in first + other:
        assert sorted(blk) == sorted(queries(traffic))


def test_a_mix_or_configuration_asking_for_what_nothing_reads_is_refused():
    from chipbench.harness.traffic import check

    traffic = spec.load_cell("paper_joins").traffic
    with pytest.raises(ValueError, match="closed loops only"):
        check(dict(traffic, loop="open"))
    with pytest.raises(ValueError, match="reads"):
        check(dict(traffic, arrivals_per_s=4))
    config = spec.load_cell("paper_joins").config
    with pytest.raises(ValueError, match="reads"):
        spec.reference(config).make_tables(dict(config["data"], rows=48, skew=1.1), 1)
    for name, part in (("paper_joins", "engine"), ("service_dashboard", "service")):
        cell = spec.load_cell(name)
        cfg = dict(cell.config, **{part: dict(cell.config[part], join="sort-merge")})
        with pytest.raises(ValueError, match="reads"):
            spec.entry(cfg).Entry(cfg, cell.traffic, {}, {}, "cpu", None)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in bench["workloads"]}
            assert "workloads" not in e2e[m["moves"]] or w in e2e[m["moves"]]["workloads"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in bench["configs"]:
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert (spec.ROOT / c["file"]).is_file() and 1 <= len(c["source"]) <= 200
    pairs = set()
    for w in bench["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert (spec.BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = spec.load_cell(w["name"])
        for m in cell.per_layer:
            assert (spec.BENCH / "layer_metrics" / f"{m['name']}.py").is_file()
        for m in cell.end_to_end:
            assert (spec.BENCH / "end_to_end" / f"{m['name']}.py").is_file()
    assert len(json.dumps(bench)) < 64 * 1024
