"""The three paper goldens with joins, ``dosage_study``, ``aspirin_count``
and ``three_join``, through ``Engine.execute`` in the port and in repro:
the same cases and checks as ``tests/test_torch_dialect.py`` (placements
``none``, ``all_internal`` and ``after_joins``; UniformNoise and
TruncatedLaplace; the fused and the gate-by-gate path; shares, per-node
ledger, every S and the rows exact, the answer equal to the oracle).

``three_join`` runs with Resizers only, as the reference's own test runs
it: without them its third product join holds 20,736 rows and its
CountDistinct sorts 2^15, one case that took minutes on a loaded test
worker."""
import pytest

pytest.importorskip("jax")

from test_torch_dialect import PAPER_JOIN_QUERIES, cases, check_golden, data  # noqa: E402,F401


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "gates"])
@pytest.mark.parametrize(
    "query,placement,noise",
    [c for c in cases(PAPER_JOIN_QUERIES, PAPER_JOIN_QUERIES) if c[:2] != ("three_join", "none")],
)
def test_join_golden_matches_reference(data, query, placement, noise, fused):  # noqa: F811
    check_golden(data, query, placement, noise, fused)
