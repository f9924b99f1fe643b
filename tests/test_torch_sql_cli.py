"""The port's SQL CLI explain verbs against the reference's CLI, on the CPU:
``python -m repro_torch.sql --explain`` prints the text of ``python -m
repro.sql --explain`` for every golden exactly, ``--explain-analyze`` (in
process and ``--networked``) prints the reference's text once the measured
seconds are masked, and ``--trace-out`` writes the merged distributed trace
as JSONL and as a Chrome trace."""
import contextlib
import io
import json
import re

import pytest

pytest.importorskip("jax")

from repro.sql.__main__ import main as jmain  # noqa: E402
from repro_torch.data import QUERY_SQL  # noqa: E402
from repro_torch.obs.explain import _COLS  # noqa: E402
from repro_torch.sql.__main__ import main  # noqa: E402

GROUP_SQL = "SELECT major_icd9, COUNT(*) AS c FROM diagnoses GROUP BY major_icd9"
DOSAGE_SQL = QUERY_SQL["dosage_study"]
CLOCK_COLUMNS = ("sec", "net stall")  # what the clock decides, not the protocol


def _run(entry, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = entry(argv)
    return rc, buf.getvalue()


def _mask_clock(text: str) -> str:
    """Blank the measured seconds: the ``sec`` and ``net stall`` columns of
    every plan row and TOTAL line, and the stall of the wire trailer."""
    out, spans = [], None
    for line in text.splitlines():
        if "est.rows" in line and line.rstrip().endswith("resize"):
            start = len(line) - sum(w for _, w in _COLS) - len("  resize")
            spans, pos = [], start
            for name, width in _COLS:
                if name in CLOCK_COLUMNS:
                    spans.append((pos, pos + width))
                pos += width
        elif not line.strip():
            spans = None
        elif line.startswith("wire:"):
            line = re.sub(r"\d+\.\d{3}s stall", "#s stall", line)
        elif spans is not None:
            for a, b in spans:
                if len(line) > a:
                    line = line[:a] + "#" * (min(b, len(line)) - a) + line[b:]
        out.append(line)
    return "\n".join(out)


def test_cli_explain_prints_the_references_text_for_every_golden():
    rc, text = _run(main, ["--explain", "--device", "cpu"])
    jrc, jtext = _run(jmain, ["--explain"])
    assert rc == jrc == 0
    assert text.count("EXPLAIN ") == jtext.count("EXPLAIN ") >= 14
    assert text == jtext


@pytest.mark.parametrize("networked", [False, True], ids=["in_process", "networked"])
def test_cli_explain_analyze_prints_the_references_text(networked):
    sql = DOSAGE_SQL if networked else GROUP_SQL
    flags = ["--networked"] if networked else []
    rc, text = _run(main, ["--explain-analyze", "--device", "cpu", *flags, sql])
    jrc, jtext = _run(jmain, ["--explain-analyze", *flags, sql])
    assert rc == jrc == 0
    assert text.startswith(f"EXPLAIN ANALYZE {sql}")
    assert ("wire:" in text) == networked
    assert _mask_clock(text) == _mask_clock(jtext)
    assert _mask_clock(text) != text  # the mask hid measured seconds, nothing else


def test_cli_trace_out_writes_jsonl_and_chrome_trace(tmp_path):
    path = tmp_path / "trace.jsonl"
    rc, text = _run(main, ["--explain-analyze", "--networked", "--device", "cpu",
                           "--trace-out", str(path), GROUP_SQL])
    assert rc == 0 and f"-> {path}" in text
    spans = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert len({s["trace_id"] for s in spans}) == 1
    assert {s["attrs"]["party"] for s in spans if "party" in s["attrs"]} == {0, 1, 2}
    chrome = json.loads((tmp_path / "trace.jsonl.chrome.json").read_text())
    events = [e for e in chrome["traceEvents"] if e.get("ph") == "X"]
    assert len(events) == len(spans)
    assert {e["tid"] for e in events} >= {0, 1, 2, 3}  # the coordinator and each party
