"""The relational layer that sorts: the segmented scan, segment starts,
GroupBy (COUNT / SUM / AVG, single and composite keys), OrderBy (ascending
and descending, with and without LIMIT) and the terminal SUM / AVG / MIN /
MAX, each against repro on the same shares and PRF keys: output shares,
ledger entries and revealed rows equal (exact: all values are ring words),
and the revealed rows equal a numpy answer."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.core import ledger as jledger  # noqa: E402
from repro.core.sharing import AShare as JAShare  # noqa: E402
from repro.ops import aggregate as jaggregate  # noqa: E402
from repro.ops import groupby as jgroupby  # noqa: E402
from repro.ops.orderby import oblivious_orderby as jorderby  # noqa: E402
from repro_torch.core import ledger as tledger  # noqa: E402
from repro_torch.core.ring import from_numpy, to_numpy  # noqa: E402
from repro_torch.core.sharing import AShare as TAShare  # noqa: E402
from repro_torch.kernels import override_fusion  # noqa: E402
from repro_torch.ops import aggregate as taggregate  # noqa: E402
from repro_torch.ops import groupby as tgroupby  # noqa: E402
from repro_torch.ops.orderby import oblivious_orderby as torderby  # noqa: E402
from test_torch_ops import _entries, _pair, _prfs, _same_shares, _same_table  # noqa: E402


def _both(jfn, tfn, fused=True):
    """Run the reference and the port, each under its own ledger."""
    with jledger.CommLedger() as jl:
        jout = jfn()
    with override_fusion(fused), tledger.CommLedger() as tl:
        tout = tfn()
    assert _entries(jl) == _entries(tl)
    return jout, tout


def _same_rows(jout, tout):
    jrows, trows = jout.reveal_true_rows(), tout.reveal_true_rows()
    assert list(jrows) == list(trows)
    for name in jrows:
        np.testing.assert_array_equal(np.asarray(jrows[name]), trows[name])
    return trows


def _plain_true(tt):
    d = tt.reveal()
    keep = d.pop("_valid") == 1
    return {k: v[keep] for k, v in d.items()}


def _arith(rng, values):
    """An additive sharing of ``values`` (uint32), as (3, ...) numpy words."""
    s0 = rng.integers(0, 2**32, values.shape, dtype=np.uint64).astype(np.uint32)
    s1 = rng.integers(0, 2**32, values.shape, dtype=np.uint64).astype(np.uint32)
    return np.stack([s0, s1, values - s0 - s1])


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("pair", [False, True])
@pytest.mark.parametrize("n", [5, 16])
def test_segmented_reduce_matches_reference(n, pair, fused):
    rng = np.random.default_rng(n)
    lanes = (n, 2) if pair else (n,)
    vals = rng.integers(0, 50, lanes).astype(np.uint32)
    flags = (rng.random(n) < 0.4).astype(np.uint32)
    flags[0] = 1
    vs, fs = _arith(rng, vals), _arith(rng, flags[:, None] if pair else flags)
    jp, tp = _prfs(20 + n)
    jout, tout = _both(
        lambda: jgroupby.segmented_reduce(JAShare(jnp.asarray(vs)), JAShare(jnp.asarray(fs)), jp),
        lambda: tgroupby.segmented_reduce(TAShare(from_numpy(vs, "cpu")), TAShare(from_numpy(fs, "cpu")), tp),
        fused,
    )
    _same_shares(jout, tout)
    got = to_numpy(tout.shares).sum(axis=0, dtype=np.uint32)
    seg = np.cumsum(flags)  # segment number of each row
    want = np.stack([vals[(seg == seg[i]) & (np.arange(n) <= i)].sum(axis=0) for i in range(n)])
    np.testing.assert_array_equal(got, want.astype(np.uint32))


@pytest.mark.parametrize("keys", [("a",), ("a", "b"), ("a", "b", "c")])
def test_segment_starts_and_count_composite(keys):
    jt, tt = _pair(16, seed=21, hi=2)
    jp, tp = _prfs(22)
    jstart, tstart = _both(
        lambda: jgroupby.segment_starts([jt.col(k) for k in keys], jt.valid, jp),
        lambda: tgroupby.segment_starts([tt.col(k) for k in keys], tt.valid, tp),
    )
    _same_shares(jstart, tstart)
    jcnt, tcnt = _both(
        lambda: jgroupby.segmented_count(jt.valid, jstart, jp),
        lambda: tgroupby.segmented_count(tt.valid, tstart, tp),
    )
    _same_shares(jcnt, tcnt)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("agg", ["count", "sum", "avg"])
@pytest.mark.parametrize("keys", ["a", ("a", "b")])
@pytest.mark.parametrize("n", [13, 16])
def test_groupby_matches_reference(n, keys, agg, fused):
    jt, tt = _pair(n, seed=30 + n, cols=("a", "b", "v"), hi=3)
    jp, tp = _prfs(31)
    if agg == "count":
        jfn = lambda: jgroupby.oblivious_groupby_count(jt, keys, jp)  # noqa: E731
        tfn = lambda: tgroupby.oblivious_groupby_count(tt, keys, tp)  # noqa: E731
    else:
        jfn = lambda: getattr(jgroupby, f"oblivious_groupby_{agg}")(jt, keys, "v", jp)  # noqa: E731
        tfn = lambda: getattr(tgroupby, f"oblivious_groupby_{agg}")(tt, keys, "v", tp)  # noqa: E731
    jout, tout = _both(jfn, tfn, fused)
    _same_table(jout, tout)
    rows = _same_rows(jout, tout)
    plain = _plain_true(tt)
    names = [keys] if isinstance(keys, str) else list(keys)
    groups = {}
    for i in range(len(plain["a"])):
        groups.setdefault(tuple(int(plain[k][i]) for k in names), []).append(int(plain["v"][i]))
    got = {}
    for i in range(len(rows[names[0]])):
        key = tuple(int(rows[k][i]) for k in names)
        if agg == "count":
            got[key] = int(rows["cnt"][i])
        elif agg == "sum":
            got[key] = int(rows["sum"][i])
        else:
            got[key] = (int(rows["avg_sum"][i]), int(rows["avg_cnt"][i]))
    want = {
        k: len(v) if agg == "count" else sum(v) if agg == "sum" else (sum(v), len(v)) for k, v in groups.items()
    }
    assert got == want


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("limit", [None, 3, 64])
@pytest.mark.parametrize("descending", [False, True])
def test_orderby_matches_reference(descending, limit, fused):
    jt, tt = _pair(13, seed=40, cols=("a", "b", "c"), hi=9)
    jp, tp = _prfs(41)
    jout, tout = _both(
        lambda: jorderby(jt, "b", jp, descending=descending, limit=limit),
        lambda: torderby(tt, "b", tp, descending=descending, limit=limit),
        fused,
    )
    _same_table(jout, tout)
    assert list(tout.cols) == ["a", "c", "b"]  # the sort column moves to the end
    assert tout.n == (16 if limit is None or limit >= 16 else limit)
    rows = _same_rows(jout, tout)
    want = sorted(_plain_true(tt)["b"].tolist(), reverse=descending)
    assert rows["b"].tolist() == want[: limit or len(want)]


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("op", ["sum", "avg", "min", "max"])
@pytest.mark.parametrize("empty", [False, True])
def test_terminal_aggregates_match_reference(op, empty, fused):
    jt, tt = _pair(13, seed=50, cols=("a", "v"), hi=40)
    if empty:  # no true row: every valid bit shared as 0
        jt = type(jt)(jt.cols, jt.valid.map_shares(lambda s: s & 0))
        tt = type(tt)(tt.cols, tt.valid.map_shares(lambda s: s & 0))
    jp, tp = _prfs(51)
    jout, tout = _both(
        lambda: getattr(jaggregate, f"{op}_column")(jt, "v", jp),
        lambda: getattr(taggregate, f"{op}_column")(tt, "v", tp),
        fused,
    )
    _same_table(jout, tout)
    rows = _same_rows(jout, tout)
    vals = _plain_true(tt)["v"].tolist()
    if op == "sum":
        assert rows["sum"].tolist() == [sum(vals)]
    elif op == "avg":
        assert (rows["avg_sum"].tolist(), rows["avg_cnt"].tolist()) == ([sum(vals)], [len(vals)])
    else:
        # an empty selection reveals no row
        want = [] if empty else [min(vals) if op == "min" else max(vals)]
        assert rows[op].tolist() == want
