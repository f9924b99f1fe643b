"""CLI of the port's SQL front end, against the HealthLNK catalog:

    python -m repro_torch.sql --check [--device cpu]   # goldens + execution checks
    python -m repro_torch.sql [--device cpu] "SELECT ..." # print the compiled plan
    python -m repro_torch.sql --explain ["SQL"]        # plan tree + cost estimates
    python -m repro_torch.sql --explain-analyze ["SQL"]
                                       # execute on synthetic HealthLNK data:
                                       # estimates vs actuals per node
    python -m repro_torch.sql --explain-analyze --networked ["SQL"]
                                       # the same, executed by three parties
                                       # on a loopback mesh (ReflexClient)
    python -m repro_torch.sql --explain-analyze --networked --trace-out PATH ["SQL"]
                                       # also write the merged distributed
                                       # trace (JSONL + Chrome trace JSON)

The CLI runs on ``cuda`` unless ``--device cpu`` asks for the CPU, and
raises where there is no card. ``--check`` has three parts:

1. every golden SQL string of ``repro_torch.data.QUERY_SQL`` must compile
   to a plan equal to its hand-compiled twin (``all_query_plans()``);
2. each dialect golden (Project, SUM, AVG, MIN, MAX, OR, composite-key
   GroupBy, GroupBy SUM and AVG, HAVING) is compiled and executed on a
   tiny synthetic HealthLNK dataset and its answer held against the
   plaintext oracle;
3. ``dosage_study``, compiled once with the product join and once with the
   sort-merge join forced (over a catalog that declares each table's pid
   bound), must reveal the same rows as the oracle.

It exits non-zero on any mismatch. ``--explain`` / ``--explain-analyze``
with no SQL run every golden query; their text is the reference's
(``python -m repro.sql``) for the same data and key, but for the measured
seconds.
"""
from __future__ import annotations

import sys


def check(device) -> int:
    """Run the three parts of ``--check`` on ``device``; 0 when all pass."""
    from ..data.queries import all_query_plans, all_query_sql
    from .compile import compile_logical, plan_fingerprint

    plans = all_query_plans()
    failures = 0
    for name, sql_text in all_query_sql().items():
        try:
            compiled = compile_logical(sql_text)
        except Exception as e:  # noqa: BLE001 — report and keep checking
            print(f"FAIL {name}: {type(e).__name__}: {e}")
            failures += 1
            continue
        if compiled != plans[name]:
            print(f"FAIL {name}: compiled plan differs from hand-compiled plan")
            print("  compiled:\n" + plan_fingerprint(compiled))
            print("  expected:\n" + plan_fingerprint(plans[name]))
            failures += 1
        else:
            print(f"OK   {name}")
    failures += _check_dialect_execution(device)
    failures += _check_sortmerge_execution(device)
    return 1 if failures else 0


def _check_dialect_execution(device) -> int:
    """Compile and execute each dialect golden on a tiny dataset; its answer
    must equal the plaintext oracle."""
    from ..core import threefry
    from ..data.healthlnk import generate_healthlnk, plaintext_oracle, revealed_answer
    from ..data.queries import DIALECT_QUERIES, QUERY_SQL
    from ..engine.executor import Engine
    from .compile import compile_logical

    tables, plain = generate_healthlnk(n=8, seed=3, aspirin_frac=0.5, device=device)
    eng = Engine(tables, key=threefry.PRNGKey(2), device=device)
    failures = 0
    for name in DIALECT_QUERIES:
        try:
            plan = compile_logical(QUERY_SQL[name])
            out, report = eng.execute(plan)
            # every plan node must have produced a ledger entry
            ok = revealed_answer(name, plan, out) == plaintext_oracle(name, plain) and len(report.nodes) >= 2
            if ok:
                print(f"OK   exec {name}")
            else:
                print(f"FAIL exec {name}: result mismatch vs plaintext oracle")
                failures += 1
        except Exception as e:  # noqa: BLE001
            print(f"FAIL exec {name}: {type(e).__name__}: {e}")
            failures += 1
    return failures


def _check_sortmerge_execution(device) -> int:
    """Force the sort-merge join on ``dosage_study``: its revealed rows must
    equal the product join's and the plaintext oracle's."""
    import numpy as np

    from ..core import threefry
    from ..data.healthlnk import generate_healthlnk, plaintext_oracle
    from ..data.queries import QUERY_SQL
    from ..engine.executor import Engine
    from ..plan.nodes import JoinSortMerge
    from .catalog import Catalog
    from .compile import compile_query

    name = "dosage_study"
    try:
        tables, plain = generate_healthlnk(n=8, seed=3, aspirin_frac=0.5, device=device)
        # declare the observed per-key duplicate bound so the planner may
        # pick the sort-merge join (a deployment declares it as metadata)
        mult = {t: {"pid": int(np.bincount(cols["pid"]).max())} for t, cols in plain.items()}
        catalog = Catalog.from_tables(tables, multiplicity=mult)
        eng = Engine(tables, key=threefry.PRNGKey(2), device=device)
        results = {}
        for mode in ("product", "sortmerge"):
            plan = compile_query(QUERY_SQL[name], catalog, join_algo=mode)
            has_sm = any(isinstance(n, JoinSortMerge) for n in _walk_nodes(plan))
            if (mode == "sortmerge") != has_sm:
                print(f"FAIL exec {name} [{mode}]: algorithm selection "
                      f"did not produce the expected physical join")
                return 1
            out, _ = eng.execute(plan)
            results[mode] = sorted(out.reveal_true_rows()["pid"].tolist())
        oracle = sorted(set(plaintext_oracle(name, plain)))
        if results["product"] == results["sortmerge"] == oracle:
            print(f"OK   exec {name} [sortmerge == product == oracle]")
            return 0
        print(f"FAIL exec {name} [sortmerge]: {results} vs oracle {oracle}")
        return 1
    except Exception as e:  # noqa: BLE001
        print(f"FAIL exec {name} [sortmerge]: {type(e).__name__}: {e}")
        return 1


def _walk_nodes(plan):
    yield plan
    for c in plan.children():
        yield from _walk_nodes(c)


def explain(argv, analyze: bool, device) -> int:
    """EXPLAIN [ANALYZE] the given SQL — or every golden query when no SQL is
    given — against ``generate_healthlnk(n=16, seed=3, aspirin_frac=0.5)``
    with engine key seed 2, as the reference's CLI does. With
    ``--networked``, EXPLAIN ANALYZE executes on a 3-party loopback mesh
    through :class:`~repro_torch.runtime.ReflexClient` (actuals come from
    real wire exchanges). ``--trace-out PATH`` (ANALYZE only) runs the
    queries under a tracer and writes the trace — in networked mode the
    merged distributed trace with all three parties' spans — as JSONL to
    PATH, plus a Chrome trace-event file at PATH + ".chrome.json"."""
    import contextlib

    from ..core import threefry
    from ..data.healthlnk import generate_healthlnk
    from ..data.queries import all_query_sql
    from ..obs import trace as obs_trace
    from ..obs.distributed import write_chrome_trace
    from ..runtime import ReflexClient

    networked = "--networked" in argv
    argv = [a for a in argv if a != "--networked"]
    trace_out = None
    if "--trace-out" in argv:
        i = argv.index("--trace-out")
        if i + 1 >= len(argv):
            print("--trace-out requires a PATH argument")
            return 1
        trace_out = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    tables, _ = generate_healthlnk(n=16, seed=3, aspirin_frac=0.5, device=device)
    if networked:
        client = ReflexClient.networked(tables, key_seed=2, device=device)
    else:
        client = ReflexClient.in_process(tables, key=threefry.PRNGKey(2), device=device)
    queries = {"query": " ".join(argv)} if argv else all_query_sql()
    tracer = obs_trace.Tracer() if (trace_out and analyze) else None
    failures = 0
    try:
        with tracer if tracer is not None else contextlib.nullcontext():
            for name, sql_text in queries.items():
                try:
                    if analyze:
                        text, _res = client.explain_analyze("explain-cli", sql_text)
                    else:
                        text = client.explain(sql_text)
                except Exception as e:  # noqa: BLE001 — report and keep going
                    print(f"FAIL {name}: {type(e).__name__}: {e}")
                    failures += 1
                    continue
                print(text)
                print()
    finally:
        client.close()
    if tracer is not None:
        with open(trace_out, "w") as f:
            f.write(tracer.to_jsonl())
        write_chrome_trace(trace_out + ".chrome.json", tracer.spans, trace_id=tracer.trace_id)
        print(f"trace: {len(tracer.spans)} spans -> {trace_out} (+ {trace_out}.chrome.json)")
    return 1 if failures else 0


def main(argv) -> int:
    from ..config import resolve_device

    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0
    argv = list(argv)
    device = None
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            print("--device requires a value (cuda or cpu)")
            return 2
        device = argv[i + 1]
        del argv[i:i + 2]
    device = resolve_device(device)
    if argv and argv[0] in ("--explain", "--explain-analyze"):
        return explain(argv[1:], analyze=argv[0] == "--explain-analyze", device=device)
    if argv and argv[0] == "--check":
        return check(device)
    from .compile import compile_query

    print(compile_query(" ".join(argv)).pretty())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
