"""Ring-64 through the port against repro with ``jax_enable_x64``, bit for bit.

``jax_enable_x64`` must be set before JAX makes any array, so the reference
runs once per module in a fresh interpreter (the fixture ``reference``):
it shares the inputs in ring-64, runs every case on both of its circuit
paths, and writes the share triples, the revealed values, the ledger
entries and the material-source events to a file. Each case is then a
test of its own here: the port's shares, revealed values, ledger entries
(rounds and bytes per party, 8 bytes a lane) and material keys must equal
the reference's, exactly, on the fused and on the gate-by-gate path.

Fused: the port under ``override_fusion(True)`` against repro with its
kernels and fusion on (its Pallas kernels in interpret mode). Gate by gate:
the port under ``override_fusion(False)`` against repro's default path.
The material events of both of the port's paths are held against the
reference's default path, as ``tests/test_torch_material.py`` does for
ring-32.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro_torch.core import circuits as tc  # noqa: E402
from repro_torch.core import ledger as tledger  # noqa: E402
from repro_torch.core import material  # noqa: E402
from repro_torch.core import prf as tprf  # noqa: E402
from repro_torch.core import sharing as ts  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.ring import RING32, RING64, from_numpy, ring_of, s64, srl, to_numpy  # noqa: E402
from repro_torch.interop import tables_from_numpy  # noqa: E402
from repro_torch.kernels import override_fusion  # noqa: E402

N = 16
TOP = 2**64 - 1
# the public constants: near the top of the ring, where a signed compare or
# an unmasked c + 1 would go wrong
C_LT = 2**63
C_LE = TOP - 1
C_WRAP = TOP  # le_public's c + 1 wraps to 0, as in the reference

# case -> expression over the circuits (c) and sharing (s) modules of
# either package, the ring-64 inputs xb, yb (XOR) and xa, ya (additive) and
# the PRF; the same text runs in both packages
CASES = {
    "mul": "s.mul(xa, ya, prf)",
    "and": "s.and_(xb, yb, prf)",
    "eq": "c.eq(xb, yb, prf)",
    "eq_public": f"c.eq_public(xb, {C_LT}, prf)",
    "lt": "c.lt(xb, yb, prf)",
    "lt_public": f"c.lt_public(xb, {C_LT}, prf)",
    "le_public": f"c.le_public(xb, {C_LE}, prf)",
    "le_public_wrap": f"c.le_public(xb, {C_WRAP}, prf)",
    "gt_public": f"c.gt_public(xb, {C_LE}, prf)",
    "ks_add": "c.ks_add(xb, yb, prf)",
    "a2b": "c.a2b(xa, prf)",
    "b2a": "c.b2a(xb, prf)",
    "bit2a": "c.bit2a(xb.and_public(1), prf)",
    "or_bit": "c.or_bit(xb.and_public(1), yb.and_public(1), prf)",
}
PATHS = ("fused", "gates")


def _inputs():
    rng = np.random.default_rng(7)
    x = rng.integers(0, 2**64, N, dtype=np.uint64)
    y = rng.integers(0, 2**64, N, dtype=np.uint64)
    x[0], y[0] = TOP, 0
    x[1], y[1] = 0, TOP
    x[2], y[2] = 2**63, 2**63 - 1
    x[3], y[3] = 2**63 - 1, 2**63
    y[4] = x[4]
    x[5] = C_LT
    x[6] = TOP
    return x, y


REFERENCE = textwrap.dedent(
    """
    import json, sys
    import jax
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    from repro.core import circuits as c, ledger, material, prf as jprf, sharing as s
    from repro.core.ring import RING64
    from repro.kernels import override_fusion, override_kernels

    out_dir, cases, x, y = sys.argv[1], json.loads(sys.argv[2]), *json.loads(sys.argv[3])
    x, y = np.array(x, dtype=np.uint64), np.array(y, dtype=np.uint64)
    prf = jprf.setup_prf(jax.random.PRNGKey(1))
    xb = s.share_b(x, jax.random.PRNGKey(2), ring=RING64)
    yb = s.share_b(y, jax.random.PRNGKey(3), ring=RING64)
    xa = s.share_a(x, jax.random.PRNGKey(4), ring=RING64)
    ya = s.share_a(y, jax.random.PRNGKey(5), ring=RING64)
    arrays, meta = {}, {}
    arrays["inputs"] = np.stack([np.asarray(t.shares) for t in (xb, yb, xa, ya)])
    arrays["finding"] = np.asarray(
        s.share_b(np.array([0xDEADBEEFCAFEBABE], dtype=np.uint64), jax.random.PRNGKey(2), ring=RING64).shares)

    class Recorder:
        def __init__(self):
            self.events, self.hits, self.misses = [], 0, 0

        def fetch(self, op, pair_keys, args, compute):
            key = material.content_key(op, pair_keys, args)
            self.events.append([key[0], key[1].hex(), repr(key[2])])
            self.misses += 1
            return compute()

    def record(name, fn):
        rec = Recorder()
        with ledger.CommLedger() as led, material.material_scope(rec):
            out = fn()
        meta[name] = {"ledger": [[e.op, e.rounds, e.bytes_per_party, e.count] for e in led.entries],
                      "material": rec.events}
        return out

    arrays["zero_add"] = np.asarray(record("zero_add", lambda: jprf.zero_share_add(prf.fold(5), (N,), RING64)))
    arrays["zero_xor"] = np.asarray(record("zero_xor", lambda: jprf.zero_share_xor(prf.fold(6), (N,), RING64)))
    arrays["rand"] = np.asarray(record("rand", lambda: jprf.rand_replicated(prf.fold(9), (2, N), RING64)))
    for name, expr in cases.items():
        for path in ("fused", "gates"):
            fn = lambda: eval(expr)
            if path == "fused":
                with override_kernels(True), override_fusion(True):
                    z = record(f"{name}/{path}", fn)
            else:
                with override_kernels(False):
                    z = record(f"{name}/{path}", fn)
            reveal = s.reveal_a if isinstance(z, s.AShare) else s.reveal_b
            arrays[f"{name}/{path}/shares"] = np.asarray(z.shares)
            arrays[f"{name}/{path}/reveal"] = np.asarray(reveal(z))

    # the reference's own ring-64 cases (tests/test_fused_circuits.py)
    rng = np.random.default_rng(1)
    rx = rng.integers(0, 1 << 63, 64, dtype=np.uint64)
    ry = rng.integers(0, 1 << 63, 64, dtype=np.uint64)
    rxb = s.share_b(rx, jax.random.PRNGKey(2), ring=RING64)
    ryb = s.share_b(ry, jax.random.PRNGKey(3), ring=RING64)
    rxa = s.share_a(rx, jax.random.PRNGKey(4), ring=RING64)
    rc = int(rng.integers(0, 1 << 63))
    own = {"lt_public": lambda: c.lt_public(rxb, rc, prf), "ks_add": lambda: c.ks_add(rxb, ryb, prf),
           "a2b": lambda: c.a2b(rxa, prf)}
    for name, fn in own.items():
        with override_kernels(True), override_fusion(True):
            arrays[f"own/{name}"] = np.asarray(fn().shares)
    meta["own"] = {"c": rc, "x": [int(v) for v in rx], "y": [int(v) for v in ry]}
    np.savez(out_dir + "/ref.npz", **arrays)
    with open(out_dir + "/ref.json", "w") as f:
        json.dump(meta, f)
    print("reference written")
    """
)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ring64")
    x, y = _inputs()
    env = dict(os.environ)
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env["PYTHONPATH"] = os.path.abspath(src) + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c", "N = %d\n" % N + REFERENCE, str(out), json.dumps(CASES),
         json.dumps([[int(v) for v in x], [int(v) for v in y]])],
        capture_output=True, text=True, env=env, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(out / "ref.npz") as f:
        arrays = dict(f)
    return arrays, json.loads((out / "ref.json").read_text())


class _Recorder:
    def __init__(self):
        self.events, self.hits, self.misses = [], 0, 0

    def fetch(self, op, pair_keys, args, compute):
        key = material.content_key(op, pair_keys, args)
        self.events.append([key[0], key[1].hex(), repr(key[2])])
        self.misses += 1
        return compute()


def _record(fn):
    rec = _Recorder()
    with tledger.CommLedger() as led, material.material_scope(rec):
        out = fn()
    return out, [[e.op, e.rounds, e.bytes_per_party, e.count] for e in led.entries], rec.events


def _port_inputs():
    x, y = _inputs()
    prf = tprf.setup_prf(threefry.PRNGKey(1))
    return dict(
        xb=ts.share_b(x, threefry.PRNGKey(2), "cpu", ring=RING64),
        yb=ts.share_b(y, threefry.PRNGKey(3), "cpu", ring=RING64),
        xa=ts.share_a(x, threefry.PRNGKey(4), "cpu", ring=RING64),
        ya=ts.share_a(y, threefry.PRNGKey(5), "cpu", ring=RING64),
        prf=prf,
    )


def test_ring64_shares_equal_the_reference(reference):
    arrays, _ = reference
    got = _port_inputs()
    for i, name in enumerate(("xb", "yb", "xa", "ya")):
        t = got[name].shares
        assert t.dtype == torch.int64 and got[name].ring == RING64
        assert (to_numpy(t) == arrays["inputs"][i]).all(), name
    x, y = _inputs()
    assert (to_numpy(ts.reveal_b(got["xb"])) == x).all()
    assert (to_numpy(ts.reveal_a(got["ya"])) == y).all()


def test_ring64_share_randomness_has_zero_high_halves_as_in_the_reference(reference):
    """The reference draws every ring-64 random word as a 32-bit threefry
    word, zero-extended (``src/repro/core/sharing.py:258-259,269-270``,
    ``src/repro/core/prf.py:48-53``): s0 and s1 of a sharing have zero high
    halves, so the party holding s2 reads the plaintext's high 32 bits. The
    port keeps it, bit for bit."""
    arrays, _ = reference
    secret = np.array([0xDEADBEEFCAFEBABE], dtype=np.uint64)
    got = to_numpy(ts.share_b(secret, threefry.PRNGKey(2), "cpu", ring=RING64).shares)[:, 0]
    want = arrays["finding"][:, 0]
    assert (got == want).all()
    assert [int(v) for v in got] == [0xA2E41AF6, 0xFEE5144F, 0xDEADBEEF96FFB407]
    assert int(got[2]) >> 32 == int(secret[0]) >> 32
    for name in ("xb", "xa"):
        legs = to_numpy(_port_inputs()[name].shares)[:2]
        assert (legs >> np.uint64(32) == 0).all()


@pytest.mark.parametrize("name", ["zero_add", "zero_xor", "rand"])
def test_ring64_randomness_and_material_keys(reference, name):
    arrays, meta = reference
    prf = tprf.setup_prf(threefry.PRNGKey(1))
    fns = {
        "zero_add": lambda: tprf.zero_share_add(prf.fold(5), (N,), "cpu", RING64),
        "zero_xor": lambda: tprf.zero_share_xor(prf.fold(6), (N,), "cpu", RING64),
        "rand": lambda: tprf.rand_replicated(prf.fold(9), (2, N), "cpu", RING64),
    }
    out, ledger, events = _record(fns[name])
    assert out.dtype == torch.int64
    assert (to_numpy(out) == arrays[name]).all()
    assert events == meta[name]["material"]
    assert ledger == meta[name]["ledger"] == []
    assert any("uint64" in e[2] for e in events)
    if name != "rand":  # a sharing of zero, with zero high halves
        combine = np.bitwise_xor.reduce if name == "zero_xor" else np.add.reduce
        assert (combine(to_numpy(out), axis=0) == 0).all()
    assert (to_numpy(out if name == "rand" else tprf.rand_replicated(prf.fold(9), (N,), "cpu", RING64))
            >> np.uint64(32) == 0).all()


def _want(name, x, y):
    """The plaintext each case computes (numpy uint64; bits in the LSB)."""
    one = np.uint64(1)
    return {
        "mul": x * y, "and": x & y, "eq": x == y, "eq_public": x == np.uint64(C_LT), "lt": x < y,
        "lt_public": x < np.uint64(C_LT), "le_public": x <= np.uint64(C_LE),
        "le_public_wrap": np.zeros_like(x, dtype=bool), "gt_public": x > np.uint64(C_LE),
        "ks_add": x + y, "a2b": x, "b2a": x, "bit2a": x & one, "or_bit": (x | y) & one,
    }[name].astype(np.uint64)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("name", list(CASES))
def test_ring64_circuit_equals_the_reference(reference, name, path):
    arrays, meta = reference
    env = dict(_port_inputs(), c=tc, s=ts)
    with override_fusion(path == "fused"):
        z, ledger, events = _record(lambda: eval(CASES[name], {}, env))
    assert z.shares.dtype == torch.int64
    assert (to_numpy(z.shares) == arrays[f"{name}/{path}/shares"]).all()
    reveal = ts.reveal_a if isinstance(z, ts.AShare) else ts.reveal_b
    opened = to_numpy(reveal(z))
    assert (opened == arrays[f"{name}/{path}/reveal"]).all()
    x, y = _inputs()
    assert (opened == _want(name, x, y)).all()
    assert ledger == meta[f"{name}/{path}"]["ledger"]
    # every interactive gate sends 8 bytes a lane on ring-64
    assert all(bpp % (8 * N) == 0 for _, _, bpp, _ in ledger if bpp)
    assert events == meta[f"{name}/gates"]["material"]


@pytest.mark.parametrize("name", ["lt_public", "ks_add", "a2b"])
def test_the_references_own_ring64_cases(reference, name):
    """``tests/test_fused_circuits.py``'s ring-64 subprocess cases: the
    fused path's shares equal the reference's fused shares, the gate-by-gate
    path gives the same, and the answer is the plaintext's."""
    arrays, meta = reference
    own = meta["own"]
    x, y = np.array(own["x"], dtype=np.uint64), np.array(own["y"], dtype=np.uint64)
    prf = tprf.setup_prf(threefry.PRNGKey(1))
    xb = ts.share_b(x, threefry.PRNGKey(2), "cpu", ring=RING64)
    yb = ts.share_b(y, threefry.PRNGKey(3), "cpu", ring=RING64)
    xa = ts.share_a(x, threefry.PRNGKey(4), "cpu", ring=RING64)
    fns = {"lt_public": lambda: tc.lt_public(xb, own["c"], prf), "ks_add": lambda: tc.ks_add(xb, yb, prf),
           "a2b": lambda: tc.a2b(xa, prf)}
    outs = []
    for fused in (True, False):
        with override_fusion(fused):
            outs.append(fns[name]())
    assert (to_numpy(outs[0].shares) == arrays[f"own/{name}"]).all()
    assert (to_numpy(outs[1].shares) == arrays[f"own/{name}"]).all()
    want = {"lt_public": x < np.uint64(own["c"]), "ks_add": x + y, "a2b": x}[name].astype(np.uint64)
    assert (to_numpy(ts.reveal_b(outs[0])) == want).all()


def test_ring64_words_near_the_top_wrap_as_unsigned():
    """int64 storage: +, -, * wrap mod 2^64; the ring's right shift is
    logical; 2^63 and 2^64 - 1 carry over from numpy and back."""
    vals = np.array([0, 1, 2**63 - 1, 2**63, 2**63 + 1, TOP - 1, TOP], dtype=np.uint64)
    t = from_numpy(vals, "cpu", RING64)
    assert t.dtype == torch.int64 and ring_of(t) == RING64
    assert (to_numpy(t) == vals).all()
    with np.errstate(over="ignore"):
        assert (to_numpy(t + t) == vals + vals).all()
        assert (to_numpy(t * t) == vals * vals).all()
        assert (to_numpy(t - 1) == vals - np.uint64(1)).all()
    for d in (1, 31, 32, 63):
        assert (to_numpy(srl(t, d)) == vals >> np.uint64(d)).all()
    assert s64(TOP) == -1 and s64(2**63) == -(2**63) and s64(2**64 + 5) == 5
    assert ring_of(from_numpy(vals, "cpu")) == RING32


def test_interop_carries_ring64_shares():
    x, _ = _inputs()
    arr = to_numpy(ts.share_b(x, threefry.PRNGKey(2), "cpu", ring=RING64).shares)
    assert arr.dtype == np.uint64
    table = tables_from_numpy({"t": ({"v": arr}, arr & np.uint64(1))}, "cpu")["t"]
    assert table.col("v").ring == RING64 and table.valid.ring == RING64
    assert (to_numpy(ts.reveal_b(table.col("v"))) == x).all()
    narrow = tables_from_numpy({"t": ({"v": arr.astype(np.uint32)}, arr.astype(np.uint32) & 1)}, "cpu")["t"]
    assert narrow.col("v").ring == RING32
