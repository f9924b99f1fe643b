"""The lazy join's guarantees (the reference's ``tests/test_lazy_join.py``)
on the port, held against ``repro`` from the same numpy tables and keys:
the gather log (no payload gathered at the product size before the trim,
exactly S rows after it), the byte count, the eager join, the Resize after
either, and the runtime config's join tile. Shares compare exactly.

Byte relation: the port's lazy index maps are int64, the reference's
int32, so a lazy table's bytes are the reference's plus 4 bytes a row of
each index map; share bytes are equal."""
import threading

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.config import RuntimeConfig as JConfig  # noqa: E402
from repro.config import use_config as juse_config  # noqa: E402
from repro.core import ledger as jledger  # noqa: E402
from repro.core import noise as jnoise  # noqa: E402
from repro.core import prf as jprf  # noqa: E402
from repro.core.resizer import Resizer as JResizer  # noqa: E402
from repro.core.resizer import ResizerConfig as JResizerConfig  # noqa: E402
from repro.ops import join as jjoin  # noqa: E402
from repro.ops import table as jtable  # noqa: E402
from repro_torch.config import RuntimeConfig as TConfig  # noqa: E402
from repro_torch.config import use_config as tuse_config  # noqa: E402
from repro_torch.core import ledger as tledger  # noqa: E402
from repro_torch.core import noise as tnoise  # noqa: E402
from repro_torch.core.resizer import Resizer as TResizer  # noqa: E402
from repro_torch.core.resizer import ResizerConfig as TResizerConfig  # noqa: E402
from repro_torch.core.ring import to_numpy  # noqa: E402
from repro_torch.interop import key_from_numpy, prf_from_numpy, tables_from_numpy  # noqa: E402
from repro_torch.ops import join as tjoin  # noqa: E402
from repro_torch.ops import table as ttable  # noqa: E402


def _entries(led):
    return [(e.op, e.rounds, e.bytes_per_party, e.count) for e in led.entries]


def _tables(n1=12, n2=9, extra_cols=0, seed=0):
    """The reference's two join sides, in repro and carried over to the port."""
    rng = np.random.default_rng(seed)
    left = {"pid": rng.integers(0, 5, n1).astype(np.uint32), "x": np.arange(n1, dtype=np.uint32)}
    right = {"pid2": rng.integers(0, 5, n2).astype(np.uint32), "y": np.arange(n2, dtype=np.uint32)}
    for c in range(extra_cols):
        left[f"lc{c}"] = rng.integers(0, 100, n1).astype(np.uint32)
        right[f"rc{c}"] = rng.integers(0, 100, n2).astype(np.uint32)
    jl = jtable.SecretTable.from_plaintext(left, jax.random.PRNGKey(seed + 1))
    jr = jtable.SecretTable.from_plaintext(right, jax.random.PRNGKey(seed + 2))
    t = tables_from_numpy({
        name: ({c: np.asarray(v.shares) for c, v in jt.cols.items()}, np.asarray(jt.valid.shares))
        for name, jt in (("l", jl), ("r", jr))
    }, "cpu")
    return (jl, t["l"]), (jr, t["r"])


def _prfs(seed):
    jp = jprf.setup_prf(jax.random.PRNGKey(seed))
    return jp, prf_from_numpy(np.asarray(jp.pair_keys))


def _keys(seed):
    k = jax.random.PRNGKey(seed)
    return k, key_from_numpy(np.asarray(k))


def _same_table(jt, tt):
    assert list(jt.cols) == list(tt.cols)
    for name in jt.cols:
        assert (np.asarray(jt.col(name).shares) == to_numpy(tt.col(name).shares)).all(), name
    assert (np.asarray(jt.valid.shares) == to_numpy(tt.valid.shares)).all()


def _resize(pkg, table, prf, key):
    cfg = (JResizerConfig if pkg == "j" else TResizerConfig)(
        noise=(jnoise if pkg == "j" else tnoise).ConstantNoise(0.1))
    return (JResizer if pkg == "j" else TResizer)(cfg)(table, prf, key)


def test_payload_is_gathered_only_at_the_trim_as_in_the_reference():
    """No payload gather at the product size; the Resizer realizes exactly
    S rows a lazy column, and the log, S and the trimmed shares equal the
    reference's."""
    (jl, tl), (jr, tr) = _tables(extra_cols=2, seed=30)
    jp, tp = _prfs(6)
    jk, tk = _keys(7)
    total = jl.n * jr.n
    logs, outs = {}, {}
    for pkg, l, r, prf, key, mod in (("j", jl, jr, jp, jk, jtable), ("t", tl, tr, tp, tk, ttable)):
        joined = (jjoin if pkg == "j" else tjoin).oblivious_join(l, r, ("pid", "pid2"), prf)
        assert len(joined.lazy_names()) == len(joined.cols) == 8
        mod.reset_gather_log()
        outs[pkg] = _resize(pkg, joined, prf, key)
        logs[pkg] = mod.gather_log()
    (jout, jinfo), (tout, tinfo) = outs["j"], outs["t"]
    assert logs["t"] == logs["j"] and len(logs["t"]) == 8
    assert max(logs["t"]) == tinfo["s"] == jinfo["s"] < total
    assert tout.n == tinfo["s_padded"] == jinfo["s_padded"]
    assert not tout.lazy_names()
    _same_table(jout, tout)


def test_first_access_materializes_at_the_product_size_and_logs_it():
    (jl, tl), (jr, tr) = _tables(seed=70)
    jp, tp = _prfs(6)
    for join, mod, l, r, prf in ((jjoin, jtable, jl, jr, jp), (tjoin, ttable, tl, tr, tp)):
        joined = join.oblivious_join(l, r, ("pid", "pid2"), prf)
        mod.reset_gather_log()
        joined.col("x")
        assert mod.gather_log() == [l.n * r.n]
        assert joined.lazy_names() == ["pid", "pid2", "y"]


def test_gather_log_is_bounded_and_per_thread():
    ttable.reset_gather_log()
    lazy = ttable.LazyGather(tables_from_numpy(
        {"t": ({"a": np.zeros((3, 4), np.uint32)}, np.zeros((3, 4), np.uint32))}, "cpu")["t"].cols["a"],
        torch.arange(4))
    for _ in range(4100):
        lazy.materialize()
    assert len(ttable.gather_log()) == 4096 == jtable._GATHER_LOG_MAX
    seen = []
    worker = threading.Thread(target=lambda: seen.append(ttable.gather_log()))
    worker.start()
    worker.join()
    assert seen == [[]]
    ttable.reset_gather_log()
    assert ttable.gather_log() == []


@pytest.mark.parametrize("lazy", [True, False])
def test_table_nbytes_against_the_reference(lazy):
    """The reference's footprint test on both packages: adding payload
    columns grows the eager join by a product-size column each and the lazy
    one by its bases only. Share bytes equal the reference's; each lazy
    index map holds int64 words, 4 bytes a row more than the reference's."""
    sizes = {}
    for extra in (0, 4):
        (jl, tl), (jr, tr) = _tables(n1=32, n2=32, extra_cols=extra, seed=50)
        jp, tp = _prfs(6)
        j = jjoin.oblivious_join(jl, jr, ("pid", "pid2"), jp, lazy=lazy)
        t = tjoin.oblivious_join(tl, tr, ("pid", "pid2"), tp, lazy=lazy)
        index_rows = 2 * 32 * 32 if lazy else 0  # the two product-layout maps
        assert ttable.table_nbytes(t) == jtable.table_nbytes(j) + 4 * index_rows
        if lazy:
            for name in t.cols:
                assert t.cols[name].nbytes() == j.cols[name].nbytes() + 4 * 32 * 32
        sizes[extra] = ttable.table_nbytes(t)
    product_col_bytes = 3 * 32 * 32 * 4
    growth = sizes[4] - sizes[0]
    if lazy:
        assert growth < product_col_bytes  # bases only: O(n1 + n2) a column
    else:
        assert growth == 8 * product_col_bytes  # 8 extra expanded columns


def test_table_nbytes_counts_a_shared_buffer_once():
    (_, tl), (_, tr) = _tables(seed=51)
    _, tp = _prfs(6)
    t = tjoin.oblivious_join(tl, tr, ("pid", "pid2"), tp)
    maps = {t.cols["pid"].index.data_ptr(), t.cols["pid2"].index.data_ptr()}
    assert len(maps) == 2 and t.cols["x"].index is t.cols["pid"].index
    shares = t.valid.shares.nbytes + sum(tl.cols[c].shares.nbytes for c in tl.cols) + sum(
        tr.cols[c].shares.nbytes for c in tr.cols)
    assert ttable.table_nbytes(t) == shares + 2 * t.n * 8


@pytest.mark.parametrize("theta", [None, ("x", "le", "y"), ("x", "eq", "y")])
def test_eager_join_equals_the_reference_and_its_ledger_the_lazy_one(theta):
    (jl, tl), (jr, tr) = _tables(seed=10)
    jp, tp = _prfs(6)
    with jledger.CommLedger() as jled:
        je = jjoin.oblivious_join(jl, jr, ("pid", "pid2"), jp, theta=theta, lazy=False)
    with tledger.CommLedger() as tled:
        te = tjoin.oblivious_join(tl, tr, ("pid", "pid2"), tp, theta=theta, lazy=False)
    assert not te.lazy_names()
    _same_table(je, te)
    assert _entries(tled) == _entries(jled)
    with tledger.CommLedger() as lazy_led:
        tz = tjoin.oblivious_join(tl, tr, ("pid", "pid2"), tp, theta=theta, lazy=True, tile=13)
    assert lazy_led.tally() == tled.tally()
    lazy_rows, eager_rows = tz.reveal(), te.reveal()
    for k in eager_rows:
        assert (lazy_rows[k] == eager_rows[k]).all(), k


def test_eager_join_of_an_empty_side_is_empty():
    (jl, tl), (_, tr) = _tables(seed=110)
    _, tp = _prfs(6)
    empty = ttable.SecretTable({"pid2": tr.cols["pid2"].take(torch.arange(0))},
                               tr.valid.take(torch.arange(0)))
    for lazy in (True, False):
        out = tjoin.oblivious_join(tl, empty, ("pid", "pid2"), tp, lazy=lazy)
        assert out.n == 0 and out.reveal()["_valid"].shape == (0,)


def test_resize_after_lazy_and_eager_joins_equals_the_reference():
    """Lazy and eager joins, then the same Resizer: S, ledgers and trimmed
    shares equal the reference's on each path; the lazy Resize's ledger
    equals the eager one's (the deferred payload's shuffle bytes are
    ledgered)."""
    (jl, tl), (jr, tr) = _tables(extra_cols=1, seed=40)
    jp, tp = _prfs(6)
    jk, tk = _keys(11)
    got = {}
    for lazy in (True, False):
        jj = jjoin.oblivious_join(jl, jr, ("pid", "pid2"), jp, lazy=lazy)
        tj = tjoin.oblivious_join(tl, tr, ("pid", "pid2"), tp, lazy=lazy)
        with jledger.CommLedger() as jled:
            jout, jinfo = _resize("j", jj, jp, jk)
        with tledger.CommLedger() as tled:
            tout, tinfo = _resize("t", tj, tp, tk)
        assert _entries(tled) == _entries(jled)
        assert tinfo == {k: v for k, v in jinfo.items()}
        _same_table(jout, tout)
        got[lazy] = (tout.reveal_true_rows(), tinfo["s"], tled.tally())
    (lazy_rows, ls, lt), (eager_rows, es, et) = got[True], got[False]
    assert ls == es and lt == et
    for k in eager_rows:
        assert sorted(lazy_rows[k].tolist()) == sorted(eager_rows[k].tolist())


@pytest.mark.parametrize("tile", [13, 64])
def test_direct_join_takes_the_runtime_configs_tile(tile):
    """A direct call without ``tile`` folds its per-tile PRF keys by the
    runtime config's ``join_tile``, as the reference does."""
    (jl, tl), (jr, tr) = _tables(seed=20)
    jp, tp = _prfs(6)
    with juse_config(JConfig(join_tile=tile)), jledger.CommLedger() as jled:
        j = jjoin.oblivious_join(jl, jr, ("pid", "pid2"), jp)
    with tuse_config(TConfig(join_tile=tile)), tledger.CommLedger() as tled:
        t = tjoin.oblivious_join(tl, tr, ("pid", "pid2"), tp)
    _same_table(j, t)
    assert _entries(tled) == _entries(jled)
