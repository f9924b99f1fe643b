"""The engine's report surface against repro's: ``ExecutionReport.to_dict``
/ ``from_dict`` round-trip, ``to_json`` and ``summary()`` character for
character with the seconds zeroed (``summary`` reads ``extra`` through
``redact.public_view``: "S=", "pad->", "trim skipped"), the reveal hook's
(describe, public info) sequence, the ``execute`` / ``node[...]`` spans, and
an engine with ``jit_ops=True`` (the per-operator cache), whose report,
summary and reveal-hook sequence equal the reference's jit engine's."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core import noise as jnoise  # noqa: E402
from repro.core.resizer import ResizerConfig as JConfig  # noqa: E402
from repro.data import all_query_plans as jplans  # noqa: E402
from repro.data.healthlnk import generate_healthlnk as jgenerate  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.engine.executor import ExecutionReport as JReport  # noqa: E402
from repro.obs import redact as jredact  # noqa: E402
from repro.ops.filter import Predicate as JPred  # noqa: E402
from repro.plan import nodes as jn  # noqa: E402
from repro.plan import insert_resizers as jinsert  # noqa: E402
from repro_torch.core import noise as tnoise  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.resizer import ResizerConfig as TConfig  # noqa: E402
from repro_torch.data import all_query_plans  # noqa: E402
from repro_torch.data.healthlnk import generate_healthlnk as tgenerate  # noqa: E402
from repro_torch.engine import Engine as TEngine  # noqa: E402
from repro_torch.engine.executor import ExecutionReport  # noqa: E402
from repro_torch.obs import Tracer, redact  # noqa: E402
from repro_torch.ops.filter import Predicate as TPred  # noqa: E402
from repro_torch.plan import nodes as tn  # noqa: E402
from repro_torch.plan import insert_resizers  # noqa: E402

DATA = dict(n=24, seed=3, aspirin_frac=0.4, icd_heart_frac=0.3)
# dosage_study: Beta Resizers trim (S, and pad-> with a bucket); comorbidity
# with NoTrim: "trim skipped"
CASES = {
    "dosage_beta_bucket": ("dosage_study", lambda m: m.ResizerConfig(noise=m.noise.BetaNoise(2, 6), bucket=4)),
    "comorbidity_notrim": ("comorbidity", lambda m: m.ResizerConfig(noise=m.noise.NoTrim())),
}


class _JMods:
    ResizerConfig, noise = JConfig, jnoise


class _TMods:
    ResizerConfig, noise = TConfig, tnoise


_RUNS: dict = {}


def _zero_seconds(d):
    for n in d["nodes"]:
        n["seconds"] = 0.0
    d["total_seconds"] = 0.0
    return d


def _run(case):
    if case not in _RUNS:
        query, cfg = CASES[case]
        jtables, _ = jgenerate(**DATA)
        ttables, _ = tgenerate(**DATA, device="cpu")
        jseen, tseen = [], []
        jeng = JEngine(jtables, key=jax.random.PRNGKey(5))
        jeng.reveal_hook = lambda node, info: jseen.append((node.describe(), jredact.public_view(info)))
        teng = TEngine(ttables, key=threefry.PRNGKey(5), device="cpu")
        teng.reveal_hook = lambda node, info: tseen.append((node.describe(), redact.public_view(info)))
        _, jrep = jeng.execute(jinsert(jplans()[query], lambda node: cfg(_JMods), placement="all_internal"))
        tracer = Tracer()
        with tracer:
            _, trep = teng.execute(insert_resizers(all_query_plans()[query], lambda node: cfg(_TMods),
                                                   placement="all_internal"))
        _RUNS[case] = (jrep, trep, jseen, tseen, tracer)
    return _RUNS[case]


@pytest.mark.parametrize("case", list(CASES))
def test_to_dict_round_trips(case):
    _, trep, _, _, _ = _run(case)
    d = trep.to_dict()
    back = ExecutionReport.from_dict(d)
    assert back.to_dict() == d
    assert [s.extra for s in back.nodes] == [s.extra for s in trep.nodes]
    assert back.total_rounds == trep.total_rounds and back.total_bytes == trep.total_bytes


@pytest.mark.parametrize("case", list(CASES))
def test_json_and_summary_equal_the_reference(case):
    jrep, trep, _, _, _ = _run(case)
    assert _zero_seconds(trep.to_dict()) == _zero_seconds(jrep.to_dict())
    tz = ExecutionReport.from_dict(_zero_seconds(trep.to_dict()))
    jz = JReport.from_dict(_zero_seconds(jrep.to_dict()))
    assert tz.to_json(indent=1) == jz.to_json(indent=1)
    assert tz.summary() == jz.summary()
    marker = {"dosage_beta_bucket": "pad->", "comorbidity_notrim": "trim skipped"}[case]
    assert marker in tz.summary()


@pytest.mark.parametrize("case", list(CASES))
def test_reveal_hook_sees_the_reference_sequence(case):
    _, _, jseen, tseen, _ = _run(case)
    assert tseen == jseen
    if case == "comorbidity_notrim":
        assert tseen == []  # a skipped trim reveals nothing
    else:
        assert len(tseen) == 3 and all("s" in info and "p" not in info and "t" not in info for _, info in tseen)


def test_spans_carry_only_public_values():
    _, trep, _, _, tracer = _run("dosage_beta_bucket")
    spans = tracer.spans
    assert [s.name for s in spans if s.name == "execute"] == ["execute"]
    nodes = [s for s in spans if s.name.startswith("node[")]
    assert len(nodes) == len(trep.nodes)
    assert sum(s.seconds for s in nodes) == pytest.approx(trep.total_seconds)
    for s in spans:
        redact.assert_emittable(s.attrs)


def test_jit_ops_runs_and_equals_the_reference():
    """``jit_ops=True`` runs and equals the reference's jit engine: a
    capture and a replay through the per-operator cache give the reference's
    jit report (seconds zeroed), summary and revealed sizes, and its shares."""
    small = dict(n=8, seed=3, aspirin_frac=0.4, icd_heart_frac=0.3)
    jtables, _ = jgenerate(**small)
    ttables, _ = tgenerate(**small, device="cpu")

    def plan(m, mods, pred):
        cfg = mods.ResizerConfig(noise=mods.noise.BetaNoise(2, 6))
        return m.CountValid(m.Resize(m.Filter(m.Scan("medications"), [pred("med", "eq", 1)]), cfg))

    jseen, tseen = [], []
    jeng = JEngine(jtables, key=jax.random.PRNGKey(5), jit_ops=True)
    jeng.reveal_hook = lambda node, info: jseen.append((node.describe(), jredact.public_view(info)))
    teng = TEngine(ttables, key=threefry.PRNGKey(5), jit_ops=True, device="cpu")
    teng.reveal_hook = lambda node, info: tseen.append((node.describe(), redact.public_view(info)))
    for _ in range(2):
        jout, jrep = jeng.execute(plan(jn, _JMods, JPred))
        tout, trep = teng.execute(plan(tn, _TMods, TPred))
        assert _zero_seconds(trep.to_dict()) == _zero_seconds(jrep.to_dict())
        assert ExecutionReport.from_dict(_zero_seconds(trep.to_dict())).summary() == JReport.from_dict(
            _zero_seconds(jrep.to_dict())).summary()
        assert tout.cols["cnt"].shares.numpy().view("uint32").tolist() == np.asarray(
            jout.cols["cnt"].shares).view("uint32").tolist()
    assert tseen == jseen and len(tseen) == 2
