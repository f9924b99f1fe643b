"""The port's observability layer (``repro_torch.obs``) against repro's.

The cases of ``tests/test_obs.py`` (redaction boundary, tracer, metrics
registry, the ledger's coalesced counts and ``batched_tally``, the report's
round-trip and summary) and the non-networked cases of
``tests/test_distributed_obs.py`` (trace context, clock offset, Chrome
export, merge semantics, the wire-metrics publisher) run here against the
port's ``obs``, ledger and report, with torch where the reference uses jax.
Then the outputs are held against the reference's for the same inputs:
``public_view``, ``fingerprint_hash``, ``render_prometheus``,
``chrome_trace`` and ``explain_text`` (EXPLAIN and EXPLAIN ANALYZE)."""
import json

import numpy as np
import pytest
import torch

from repro_torch.core.ledger import CommLedger, batched_tally, log_comm
from repro_torch.engine.executor import ExecutionReport, NodeStats
from repro_torch.obs import (
    Tracer,
    MetricsRegistry,
    active_tracer,
    redact,
    record,
    span,
)
from repro_torch.obs.distributed import (
    TraceContext,
    WireMetricsPublisher,
    chrome_trace,
    clock_offset,
    merge_party_spans,
    new_trace_id,
)
from repro_torch.obs.trace import Span


# -----------------------------------------------------------------------------
# redact: the disclosure audit boundary
# -----------------------------------------------------------------------------

RESIZER_INFO = {"n": 144, "t": 9, "s": 23, "s_padded": 32, "eta": 14}


def test_public_view_drops_secret_keys():
    pub = redact.public_view(RESIZER_INFO)
    assert pub == {"n": 144, "s": 23, "s_padded": 32}
    assert "t" not in pub and "eta" not in pub


def test_public_view_default_denies_unknown_keys():
    dropped = []
    pub = redact.public_view({"n": 4, "mystery_field": 7}, dropped)
    assert pub == {"n": 4}
    assert "mystery_field" in dropped


def test_public_view_recurses_into_nested_dicts():
    pub = redact.public_view({"node": "Resize", "count": {"t": 3, "s": 5}})
    assert pub == {"node": "Resize", "count": {"s": 5}}


def test_assert_emittable_raises_on_secret():
    with pytest.raises(redact.RedactionError):
        redact.assert_emittable(RESIZER_INFO)
    redact.assert_emittable({"n": 144, "s": 23})  # public-only: fine


def test_audit_labels_rejects_secret_dimension():
    with pytest.raises(redact.RedactionError):
        redact.audit_labels("m", ("tenant", "t"))
    redact.audit_labels("m", ("tenant", "sig"))


def test_metric_with_secret_labelname_cannot_be_declared():
    m = MetricsRegistry()
    with pytest.raises(redact.RedactionError):
        m.counter("bad_total", "", ("eta",))


def test_fingerprint_hash_is_stable_and_short():
    fp = "Join(pid==pid)\n  Scan(a)\n  Scan(b)"
    h = redact.fingerprint_hash(fp)
    assert h == redact.fingerprint_hash(fp) and len(h) == 12
    assert "\n" not in h


# -----------------------------------------------------------------------------
# Tracer
# -----------------------------------------------------------------------------

def test_tracer_nests_spans_and_redacts_attrs():
    with Tracer() as tr:
        with span("query", tenant="alice"):
            with span("execute"):
                record("node[Resize]", seconds=0.5, **RESIZER_INFO)
    q, ex, nd = tr.spans
    assert q.parent_id is None
    assert ex.parent_id == q.span_id
    assert nd.parent_id == ex.span_id
    assert nd.seconds == 0.5
    assert nd.attrs == {"n": 144, "s": 23, "s_padded": 32}
    assert sorted(set(tr.redactions)) == ["eta", "t"]


def test_module_helpers_are_noops_without_tracer():
    assert active_tracer() is None
    with span("query"):  # nullcontext
        record("node[x]", n_out=1)
    annotated = Tracer()
    assert annotated.spans == []


def test_tracer_jsonl_round_trip(tmp_path):
    with Tracer() as tr:
        with span("query", tenant="a", sql="SELECT 1"):
            record("compile", seconds=0.1, cache_hit=True)
    path = tmp_path / "trace.jsonl"
    tr.write(str(path))
    lines = path.read_text().strip().splitlines()
    assert len(lines) == 2
    objs = [json.loads(ln) for ln in lines]
    assert {o["name"] for o in objs} == {"query", "compile"}
    by_name = {o["name"]: o for o in objs}
    assert by_name["compile"]["parent_id"] == by_name["query"]["span_id"]
    assert by_name["compile"]["attrs"]["cache_hit"] is True


def test_tracer_annotate_merges_into_open_span():
    with Tracer() as tr:
        with span("query") as sp:
            from repro_torch.obs import annotate

            annotate(cache_hit=True, t=99)  # t must be dropped
    assert sp.attrs == {"cache_hit": True}
    assert "t" in tr.redactions


# -----------------------------------------------------------------------------
# MetricsRegistry
# -----------------------------------------------------------------------------

def test_counter_labels_total_and_touch():
    m = MetricsRegistry()
    c = m.counter("q_total", "queries", ("tenant",))
    c.touch(tenant="bob")
    c.inc(tenant="alice")
    c.inc(2, tenant="alice")
    assert c.value(tenant="alice") == 3
    assert c.value(tenant="bob") == 0
    assert c.total() == 3
    assert dict((k[0], v) for k, v in c.samples()) == {"alice": 3, "bob": 0}
    with pytest.raises(ValueError):
        c.inc(-1, tenant="alice")


def test_counter_rejects_undeclared_labels():
    m = MetricsRegistry()
    c = m.counter("q_total", "", ("tenant",))
    with pytest.raises(ValueError):
        c.inc(reason="full")


def test_registry_dedupes_and_rejects_shape_conflicts():
    m = MetricsRegistry()
    a = m.counter("x_total", "", ("tenant",))
    assert m.counter("x_total", "", ("tenant",)) is a
    with pytest.raises(ValueError):
        m.counter("x_total", "", ("reason",))
    with pytest.raises(ValueError):
        m.gauge("x_total", "")


def test_histogram_buckets_sum_count():
    m = MetricsRegistry()
    h = m.histogram("lat_seconds", "", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.5, 5.0):
        h.observe(v)
    assert h.count() == 4 and h.sum() == pytest.approx(5.555)
    text = m.render_prometheus()
    assert 'lat_seconds_bucket{le="0.01"} 1' in text
    assert 'lat_seconds_bucket{le="0.1"} 2' in text
    assert 'lat_seconds_bucket{le="1.0"} 3' in text
    assert 'lat_seconds_bucket{le="+Inf"} 4' in text
    assert "lat_seconds_count 4" in text


def test_prometheus_exposition_format():
    m = MetricsRegistry()
    c = m.counter("reflex_queries_total", "Completed queries", ("tenant",))
    c.inc(tenant='we"ird\nname')
    g = m.gauge("reflex_queue_depth", "Pending")
    g.set(3)
    text = m.render_prometheus()
    assert "# HELP reflex_queries_total Completed queries" in text
    assert "# TYPE reflex_queries_total counter" in text
    assert "# TYPE reflex_queue_depth gauge" in text
    assert 'reflex_queries_total{tenant="we\\"ird\\nname"} 1.0' in text
    assert "reflex_queue_depth 3.0" in text


def test_snapshot_is_json_safe():
    m = MetricsRegistry()
    m.counter("a_total", "", ("tenant",)).inc(tenant="x")
    m.histogram("b_seconds", "").observe(0.2)
    blob = json.loads(json.dumps(m.snapshot()))
    assert blob["a_total"]["samples"] == [
        {"labels": {"tenant": "x"}, "value": 1.0}
    ]
    assert blob["b_seconds"]["samples"][0]["count"] == 1


# -----------------------------------------------------------------------------
# Ledger satellite: coalesced count semantics
# -----------------------------------------------------------------------------

def test_ledger_coalesces_identical_runs():
    """Identical consecutive logs coalesce into one entry with the true
    repetition count, and every aggregate scales by it."""
    led = CommLedger()
    with led:
        for _ in range(5):
            log_comm("mul", 1, 64)
        log_comm("eq", 5, 20)
        log_comm("mul", 1, 64)  # new run: eq broke the streak
    assert [(e.op, e.count) for e in led.entries] == [
        ("mul", 5), ("eq", 1), ("mul", 1),
    ]
    assert led.tally() == {"bytes_per_party": 6 * 64 + 20, "rounds": 6 + 5}
    by = led.by_op()
    assert by["mul"] == {"rounds": 6, "bytes_per_party": 384, "calls": 6}
    assert by["eq"] == {"rounds": 5, "bytes_per_party": 20, "calls": 1}


def test_fused_scales_coalesced_bytes():
    led = CommLedger()
    with led:
        with led.fused("eqtree", 5):
            for _ in range(4):
                log_comm("and", 1, 8)
    (e,) = led.entries
    assert (e.op, e.rounds, e.bytes_per_party, e.count) == ("eqtree", 5, 32, 1)
    assert led.tally() == {"bytes_per_party": 32, "rounds": 5}


def test_by_op_matches_tally_under_vmapped_pass():
    """batched_tally composes with by_op(): the one profile of a vmapped
    protocol is the per-slot cost, so physical bytes scale by K while
    by_op() keeps reporting per-slot calls and rounds."""
    def proto(x):
        for _ in range(3):
            log_comm("mul", 1, int(x.shape[-1]) * 4)
        return x * 2

    xs = torch.ones((4, 8), dtype=torch.int32)  # K=4 slots of 8 lanes
    with CommLedger() as led:
        torch.func.vmap(proto)(xs)  # runs once with per-slot shapes
    per_slot = led.tally()
    assert per_slot == {"bytes_per_party": 3 * 32, "rounds": 3}
    assert led.by_op()["mul"]["calls"] == 3  # coalesced run of 3
    phys = batched_tally(per_slot, slots=4)
    assert phys["bytes_per_party"] == 4 * per_slot["bytes_per_party"]
    assert phys["rounds"] == per_slot["rounds"]  # rounds shared by the batch
    # tally and by_op agree on totals whatever the coalescing did
    by = led.by_op()
    assert sum(v["bytes_per_party"] for v in by.values()) == per_slot["bytes_per_party"]
    assert sum(v["rounds"] for v in by.values()) == per_slot["rounds"]


# -----------------------------------------------------------------------------
# Report satellites: to_dict/to_json round-trip, summary rendering
# -----------------------------------------------------------------------------

def _scalar_report():
    """NodeStats carrying numpy/torch scalars and nested extra."""
    return ExecutionReport(nodes=[
        NodeStats(
            node="Scan(t)", n_in=0, n_ins=[], n_out=8,
            seconds=np.float64(0.25), bytes_per_party=0, rounds=0,
        ),
        NodeStats(
            node="Resize[rho]", n_in=8, n_ins=[8],
            n_out=int(torch.tensor(5)),
            seconds=0.5, bytes_per_party=1024, rounds=7,
            extra={
                "n": np.int64(8), "t": torch.tensor(3, dtype=torch.int32),
                "s": np.uint32(5), "s_padded": 8,
                "nested": {"p": np.float32(0.4), "list": [np.int32(1), 2]},
            },
        ),
    ])


def test_to_dict_to_json_round_trip_with_foreign_scalars():
    rep = _scalar_report()
    blob = json.loads(rep.to_json())  # would raise if any scalar leaked
    rz = blob["nodes"][1]
    assert rz["extra"]["n"] == 8 and rz["extra"]["s"] == 5
    assert rz["extra"]["nested"]["list"] == [1, 2]
    assert isinstance(rz["extra"]["nested"]["p"], float)
    assert blob["total_bytes"] == 1024 and blob["total_rounds"] == 7
    assert blob["total_seconds"] == pytest.approx(0.75)
    # a second encode of the decoded blob is the identity (fully JSON-native)
    assert json.loads(json.dumps(blob)) == blob


def test_summary_renders_all_inputs_and_extra():
    rep = ExecutionReport(nodes=[
        NodeStats(
            node="Join(pid==pid)", n_in=12, n_ins=[12, 16], n_out=192,
            seconds=0.1, bytes_per_party=2048, rounds=7,
        ),
        NodeStats(
            node="Resize[rho]", n_in=192, n_ins=[192], n_out=32,
            seconds=0.2, bytes_per_party=4096, rounds=9,
            extra={"n": 192, "t": 11, "s": 25, "s_padded": 32, "eta": 14},
        ),
        NodeStats(
            node="Resize[skip]", n_in=32, n_ins=[32], n_out=32,
            seconds=0.0, bytes_per_party=0, rounds=0,
            extra={"n": 32, "t": 11, "s": 32, "skipped": True},
        ),
    ])
    text = rep.summary()
    join_line, rz_line, skip_line = text.splitlines()[1:4]
    assert "12x16" in join_line  # every input size, not just the first
    assert "S=25" in rz_line and "pad->32" in rz_line
    assert "trim skipped" in skip_line
    # the secret resizer fields never reach the rendered summary
    assert "t=11" not in text and "eta" not in text


# -----------------------------------------------------------------------------
# distributed: trace context, clock offset, Chrome export, merge, wire metrics
# -----------------------------------------------------------------------------


def test_new_trace_id_shape_and_uniqueness():
    ids = {new_trace_id() for _ in range(64)}
    assert len(ids) == 64
    assert all(len(i) == 16 and int(i, 16) >= 0 for i in ids)


def test_trace_context_roundtrip():
    ctx = TraceContext("ab" * 8, parent_span_id=7)
    assert TraceContext.from_dict(ctx.to_dict()) == ctx
    assert TraceContext.from_dict({"trace_id": "x"}).parent_span_id is None


def test_clock_offset_recovers_true_skew():
    # party clock ahead of the coordinator's by delta, symmetric one-way
    # delay d: the NTP midpoint recovers delta exactly
    delta, d = 5.0, 0.3
    t_send, t_ack = 100.0, 100.0 + 2 * d
    t_recv = t_send + d + delta
    t_reply = t_recv  # instantaneous handling
    assert clock_offset(t_send, t_recv, t_reply, t_ack) == pytest.approx(delta)


def test_chrome_trace_event_shape():
    spans = [
        Span(name="execute", span_id=1, parent_id=None, ts=10.0,
             seconds=0.5, attrs={}),
        Span(name="node[Scan]", span_id=2, parent_id=1, ts=10.1,
             seconds=0.2, attrs={"party": 1}),
    ]
    doc = chrome_trace(spans, trace_id="cafe" * 4)
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    assert len(events) == 2
    assert doc["otherData"]["trace_id"] == "cafe" * 4
    by_name = {e["name"]: e for e in events}
    # the coordinator rides tid 0, party p rides tid p+1; ts is relative us
    assert by_name["execute"]["tid"] == 0
    assert by_name["node[Scan]"]["tid"] == 2
    assert by_name["execute"]["ts"] == 0
    assert by_name["node[Scan]"]["ts"] == pytest.approx(0.1e6)
    assert by_name["node[Scan]"]["dur"] == pytest.approx(0.2e6)


# -----------------------------------------------------------------------------
# Merge semantics
# -----------------------------------------------------------------------------


def _shipment(party, trace_id, spans, *, skew=0.0):
    return {
        "party": party,
        "trace_id": trace_id,
        "spans": spans,
        "clock": {"t_recv": 100.0 + skew, "t_reply": 100.1 + skew},
        "t_send": 100.0,
        "t_ack": 100.1,
    }


def test_merge_rejects_foreign_trace_id():
    stray = {"name": "node[Scan]", "span_id": 1, "parent_id": None,
             "ts": 100.0, "seconds": 0.1, "attrs": {"party": 0}}
    with Tracer() as tr:
        tid = tr.ensure_trace_id()
        with tr.span("execute") as sp:
            with pytest.raises(ValueError, match="trace"):
                merge_party_spans(
                    tr, sp, [_shipment(0, "not-the-trace", [stray])]
                )
        assert tid == tr.trace_id


def test_merge_re_audits_party_attrs():
    """A misbehaving party cannot smuggle a secret-keyed attr into the
    merged trace: the coordinator re-runs the deny-list audit on arrival."""
    bad = {"name": "node[Resize]", "span_id": 1, "parent_id": None,
           "ts": 100.0, "seconds": 0.1, "attrs": {"t": 999}}
    with Tracer() as tr:
        tid = tr.ensure_trace_id()
        with tr.span("execute") as sp:
            with pytest.raises(redact.RedactionError):
                merge_party_spans(tr, sp, [_shipment(1, tid, [bad])])


def test_merge_reparents_renumbers_and_normalizes_clock():
    party_spans = [
        {"name": "node[Scan]", "span_id": 1, "parent_id": None,
         "ts": 107.0, "seconds": 0.2, "attrs": {"party": 2}},
        {"name": "node[Count]", "span_id": 2, "parent_id": 1,
         "ts": 107.1, "seconds": 0.1, "attrs": {"party": 2}},
    ]
    with Tracer() as tr:
        tid = tr.ensure_trace_id()
        with tr.span("execute") as sp:
            # party clock runs 7s ahead (t_recv=107 vs send/ack 100..100.1)
            n = merge_party_spans(
                tr, sp, [_shipment(2, tid, party_spans, skew=7.0)]
            )
        assert n == 2
    merged = {s.name: s for s in tr.spans if s.name.startswith("node[")}
    root, child = merged["node[Scan]"], merged["node[Count]"]
    assert root.parent_id == sp.span_id  # re-parented under execute
    assert child.parent_id == root.span_id  # sibling linkage preserved
    assert root.span_id != 1 and child.span_id != 2  # renumbered
    assert "clock_offset_s" in root.attrs
    # normalized onto the coordinator clock: 107 - ~7 ≈ 100
    assert abs(root.ts - 100.0) < 0.2


def test_wire_publisher_is_delta_safe():
    reg = MetricsRegistry()
    pub = WireMetricsPublisher(reg)
    snap = {
        "party": 1,
        "sent": [{"link": "1->0", "kind": "data", "frames": 4, "bytes": 256,
                  "seconds": 0.01}],
        "recv": [{"link": "2->1", "kind": "data", "frames": 4, "bytes": 256,
                  "seconds": 0.02}],
        "rejects": [{"reason": "crc", "count": 2}],
        "connects": [{"peer": 0, "retries": 3, "backoff_seconds": 0.05}],
        "links": [{"link": "1<->0", "sent": 4, "recv": 0}],
    }
    pub.publish(snap)
    pub.publish(snap)  # identical re-pull: counters must not advance

    def val(name, **labels):
        for s in reg.snapshot()[name]["samples"]:
            if all(s["labels"].get(k) == v for k, v in labels.items()):
                return s["value"]
        raise AssertionError(f"no sample {labels} in {name}")

    assert val("reflex_wire_bytes_total", party="1", link="1->0") == 256
    assert val("reflex_wire_frames_total", party="1", link="1->0") == 4
    # inbound entries feed the wait counter only — each link's frames are
    # counted once mesh-wide, by the sender
    assert val(
        "reflex_wire_recv_wait_seconds_total", party="1", link="2->1"
    ) == pytest.approx(0.02)
    assert val("reflex_wire_rejects_total", party="1", reason="crc") == 2
    assert val("reflex_wire_connect_retries_total", party="1", peer="0") == 3
    # grown totals advance by the delta only
    snap["sent"][0]["bytes"] = 300
    pub.publish(snap)
    assert val("reflex_wire_bytes_total", party="1", link="1->0") == 300


# -----------------------------------------------------------------------------
# Outputs equal to the reference's for the same inputs
# -----------------------------------------------------------------------------

jax = pytest.importorskip("jax")

from repro.obs import MetricsRegistry as JRegistry  # noqa: E402
from repro.obs import explain_text as jexplain  # noqa: E402
from repro.obs import redact as jredact  # noqa: E402
from repro.obs.distributed import chrome_trace as jchrome  # noqa: E402
from repro.obs.trace import Span as JSpan  # noqa: E402

INFOS = [
    {"n": 144, "t": 9, "s": 23, "s_padded": 32, "eta": 14, "p": 0.2},
    {"node": "Resize", "count": {"t": 3, "s": 5}, "skipped": True, "mystery": 1},
    {"offline": {"hits": 3, "misses": 1}, "wire": {"exchanges": 2, "stall_seconds": 0.1, "wire_bytes": 64}},
    {"party": 1, "slots": 4, "stacked": True, "tenant": "a", "oracle": [1, 2], "true_rows": 3},
]


@pytest.mark.parametrize("info", INFOS)
def test_public_view_equals_the_reference(info):
    tdrop, jdrop = [], []
    assert redact.public_view(info, tdrop) == jredact.public_view(info, jdrop)
    assert tdrop == jdrop
    assert redact.SECRET_KEYS == jredact.SECRET_KEYS and redact.PUBLIC_KEYS == jredact.PUBLIC_KEYS


@pytest.mark.parametrize("fp", ["Join(pid==pid)\n  Scan(a)\n  Scan(b)", "", "Distinct(pid)"])
def test_fingerprint_hash_equals_the_reference(fp):
    assert redact.fingerprint_hash(fp) == jredact.fingerprint_hash(fp)


def test_prometheus_and_snapshot_equal_the_reference():
    def fill(m):
        c = m.counter("reflex_queries_total", "Completed queries", ("tenant",))
        c.inc(tenant='we"ird\nname')
        c.inc(3, tenant="b")
        m.gauge("reflex_queue_depth", "Pending").set(3)
        h = m.histogram("lat_seconds", "latency", buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.05, 0.5, 5.0):
            h.observe(v)
        return m

    t, j = fill(MetricsRegistry()), fill(JRegistry())
    assert t.render_prometheus() == j.render_prometheus()
    assert json.dumps(t.snapshot(), sort_keys=True) == json.dumps(j.snapshot(), sort_keys=True)


def test_chrome_trace_equals_the_reference():
    rows = [("execute", 1, None, 10.0, 0.5, {}), ("node[Scan]", 2, 1, 10.1, 0.2, {"party": 1}),
            ("node[Resize]", 3, 1, 10.3, 0.1, {"s": 5, "party": 0})]
    tdoc = chrome_trace([Span(*r) for r in rows], trace_id="cafe" * 4)
    jdoc = jchrome([JSpan(*r) for r in rows], trace_id="cafe" * 4)
    assert json.dumps(tdoc, sort_keys=True) == json.dumps(jdoc, sort_keys=True)


def test_explain_text_equals_the_reference():
    from repro.core import noise as jnoise
    from repro.core.resizer import ResizerConfig as JConfig
    from repro.data import all_query_plans as jplans
    from repro.engine.executor import ExecutionReport as JReport
    from repro.plan import insert_resizers as jinsert
    from repro.plan.cost import CostModel as JCostModel
    from repro_torch.core import noise as tnoise
    from repro_torch.core.resizer import ResizerConfig as TConfig
    from repro_torch.data import all_query_plans
    from repro_torch.obs import explain_text
    from repro_torch.plan import insert_resizers
    from repro_torch.plan.cost import CostModel

    kw = dict(table_sizes={"diagnoses": 8192, "medications": 8192, "demographics": 2048},
              table_cols={"diagnoses": 6, "medications": 5, "demographics": 3})
    for query in ("dosage_study", "comorbidity", "aspirin_count"):
        plan = insert_resizers(all_query_plans()[query], lambda node: TConfig(noise=tnoise.BetaNoise(2, 6)))
        jplan = jinsert(jplans()[query], lambda node: JConfig(noise=jnoise.BetaNoise(2, 6)))
        cm, jcm = CostModel(**kw, noise=tnoise.BetaNoise(2, 6)), JCostModel(**kw, noise=jnoise.BetaNoise(2, 6))
        assert explain_text(plan, cm, title=query) == jexplain(jplan, jcm, title=query)
        # EXPLAIN ANALYZE over one report (post-order entries), rendered by both
        order = []

        def walk(n):
            for c in n.children():
                walk(c)
            order.append(n)

        walk(plan)
        nodes = [NodeStats(node=n.describe(), n_in=8, n_ins=[8] * len(n.children()), n_out=4, seconds=0.125,
                           bytes_per_party=2048 * i, rounds=i,
                           extra={"n": 8, "t": 3, "s": 4, "s_padded": 4, "p": 0.3,
                                  "offline": {"hits": i, "misses": 1}} if "Resize" in n.describe() else {})
                 for i, n in enumerate(order)]
        rep = ExecutionReport(nodes=nodes)
        jrep = JReport.from_dict(rep.to_dict())
        text = explain_text(plan, cm, rep)
        assert text == jexplain(jplan, jcm, jrep)
        assert "t=3" not in text and "0.3" not in text
