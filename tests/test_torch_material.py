"""The material scope (``repro_torch.core.material``) against repro's.

Every fold, draw, zero sharing and hop permutation passes through the
ambient source with the reference's op names and args, keyed by the pair
keys' content. A recording source must see the same sequence of
``(op, content_key, args)`` in the port (on both circuit paths) as in
repro; a pool filled by one run must serve a second run entirely from
memory with shares identical to an on-demand run; and the engine's per-node
``extra["offline"]`` hit/miss counts must equal the reference's."""
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.core import material as jmaterial  # noqa: E402
from repro.core import noise as jnoise  # noqa: E402
from repro.core.resizer import ResizerConfig as JConfig  # noqa: E402
from repro.data import all_query_plans as jplans  # noqa: E402
from repro.data.healthlnk import generate_healthlnk as jgenerate  # noqa: E402
from repro.engine import Engine as JEngine  # noqa: E402
from repro.plan import insert_resizers as jinsert  # noqa: E402
from repro_torch import RuntimeConfig  # noqa: E402
from repro_torch.core import material  # noqa: E402
from repro_torch.core import noise as tnoise  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.resizer import ResizerConfig as TConfig  # noqa: E402
from repro_torch.data import all_query_plans  # noqa: E402
from repro_torch.data.healthlnk import generate_healthlnk as tgenerate  # noqa: E402
from repro_torch.engine import Engine as TEngine  # noqa: E402
from repro_torch.plan import insert_resizers  # noqa: E402
from test_torch_slice import _assert_outputs_equal, _assert_reports_equal  # noqa: E402

DATA = dict(n=16, seed=3, aspirin_frac=0.4, icd_heart_frac=0.3)
QUERY = "dosage_study"


class _Recorder:
    """Records every fetch and computes it on demand (all misses)."""

    def __init__(self, key_fn):
        self.key_fn, self.events, self.hits, self.misses = key_fn, [], 0, 0

    def fetch(self, op, pair_keys, args, compute):
        self.events.append(self.key_fn(op, pair_keys, args))
        self.misses += 1
        return compute()


class _Pool(material.MaterialSource):
    """A dict pool: serves what it holds, computes (and keeps) the rest."""

    def __init__(self):
        self.store, self.hits, self.misses = {}, 0, 0

    def fetch(self, op, pair_keys, args, compute):
        key = material.content_key(op, pair_keys, args)
        if key in self.store:
            self.hits += 1
            return self.store[key].clone()
        self.misses += 1
        value = compute()
        self.store[key] = value.clone()
        return value


_REF: dict = {}


def _reference():
    if not _REF:
        jtables, _ = jgenerate(**DATA)
        plan = jinsert(jplans()[QUERY], lambda node: JConfig(noise=jnoise.BetaNoise(2, 6)), placement="all_internal")
        rec = _Recorder(jmaterial.content_key)
        with jmaterial.material_scope(rec):
            out, rep = JEngine(jtables, key=jax.random.PRNGKey(5)).execute(plan)
        _REF.update(out=out, rep=rep, events=rec.events)
    return _REF


def _port(source, fused=True):
    ttables, _ = tgenerate(**DATA, device="cpu")
    plan = insert_resizers(all_query_plans()[QUERY], lambda node: TConfig(noise=tnoise.BetaNoise(2, 6)),
                           placement="all_internal")
    engine = TEngine(ttables, key=threefry.PRNGKey(5), config=RuntimeConfig(fuse_circuits=fused), device="cpu")
    with material.material_scope(source):
        return engine.execute(plan)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "gates"])
def test_recorded_sequence_equals_the_reference(fused):
    ref = _reference()
    rec = _Recorder(material.content_key)
    out, rep = _port(rec, fused)
    assert len(rec.events) == len(ref["events"]) > 100
    assert rec.events == ref["events"]
    assert {e[0] for e in rec.events} <= {"fold", "draw", "uniform", "zero_xor", "zero_add", "perm"}
    # attribution: every node's misses equal the reference's
    assert [s.extra.get("offline") for s in rep.nodes] == [s.extra.get("offline") for s in ref["rep"].nodes]
    _assert_reports_equal(ref["rep"], rep)
    _assert_outputs_equal(ref["out"], out)


def test_pooled_run_equals_on_demand_run():
    pool = _Pool()
    cold_out, cold_rep = _port(pool)
    assert pool.misses > 0  # (a derivation repeated within the run hits)
    misses, requests = pool.misses, pool.hits + pool.misses
    hot_out, hot_rep = _port(pool)
    assert pool.misses == misses and pool.hits + pool.misses == 2 * requests
    plain_out, plain_rep = _port(None)
    for out in (cold_out, hot_out):
        leaves = torch.utils._pytree.tree_leaves(out)
        want = torch.utils._pytree.tree_leaves(plain_out)
        assert all(torch.equal(a, b) for a, b in zip(leaves, want))
    offline = [s.extra.get("offline") for s in hot_rep.nodes]
    assert sum(o["hits"] for o in offline if o) == requests
    assert all(o is None or o["misses"] == 0 for o in offline)
    assert all("offline" not in s.extra for s in plain_rep.nodes)


def test_content_key_equals_the_reference():
    pk = threefry.split(threefry.PRNGKey(9), 3)
    jpk = jax.vmap(jax.random.key_data)(jax.random.split(jax.random.wrap_key_data(jax.random.PRNGKey(9)), 3))
    args = ((3, 4), "uint32")
    assert material.content_key("draw", pk, args) == jmaterial.content_key("draw", jpk, args)


def test_scope_nests_and_steps_aside_under_vmap():
    a, b = _Pool(), _Pool()
    assert material.active_source() is None
    with material.material_scope(a):
        with material.material_scope(b):
            assert material.active_source() is b
        assert material.active_source() is a
        concrete = torch.zeros(2, dtype=torch.int32)
        assert material.active_if_concrete(concrete) is a
        seen = []
        torch.func.vmap(lambda x: seen.append(material.active_if_concrete(x)) or x)(torch.zeros(3, 2))
        assert seen == [None]
    assert material.active_source() is None
