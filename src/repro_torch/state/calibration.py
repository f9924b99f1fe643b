"""CalibrationStore: feed already-revealed intermediate sizes back to the
planner (DESIGN.md §12.4).

Every non-NoTrim Resize reveal-and-trim discloses a noisy size S for its
child subplan. That disclosure is *already paid for* by the CRT ledger — so
remembering it and using it to plan better is free signal (the SPECIAL
synopsis-reuse observation): the planner's static registry defaults
(``selectivity=0.1``, ``join_selectivity=0.01``) are replaced by the sizes
the engine actually observed, with **zero additional disclosure** — the
store only ever holds values an attacker watching the wire already has.

Observations are keyed by the **literal-masked, Resize-stripped** fingerprint
of the revealed subplan (:func:`calibration_key`): ``WHERE dosage = 325`` and
``WHERE dosage = 81`` share a key (like the prepared-statement cache), and a
physical subtree with inner Resizers maps to the same key as the logical
subtree the join reorderer scores at compile time.

``refine`` is the cost-model hook (:class:`repro_torch.plan.cost.CostModel`): for
a Resizer-candidate node with an observation, the estimated true size T
becomes the EWMA of observed S (an overestimate of T by E[eta] — safely
conservative), and — when the planner knows the noise strategy — the
oblivious size flowing upward becomes the post-trim E[S], because placement
will insert a Resizer there. Under NoTrim, E[S] = N and the refinement
changes nothing: calibration never assumes a trim the mode won't perform.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..plan.nodes import PlanNode, Resize
from ..plan.registry import lookup
from .store import JournalStore, SyncResult

__all__ = ["CalibrationStore", "calibration_key", "strip_resizers"]

EWMA_ALPHA = 0.5  # weight of the newest observation


def strip_resizers(plan: PlanNode) -> PlanNode:
    """The logical twin of a physical subtree: every Resize replaced by its
    child, so execution-time keys match compile-time (pre-placement) keys."""
    children = [strip_resizers(c) for c in plan.children()]
    node = plan.replace_children(children)
    return node.child if isinstance(node, Resize) else node


def calibration_key(plan: PlanNode) -> str:
    """Literal-masked, Resize-stripped fingerprint of a subplan."""
    from ..sql.compile import template_fingerprint

    return template_fingerprint(strip_resizers(plan))


class CalibrationStore:
    """Persisted map calibration_key -> observed revealed-size statistics,
    replicated through a :class:`JournalStore` (same lease/tail-sync/compact
    mechanics as the privacy ledger; merging size observations is conflict-
    free, the journal just makes them durable and shared)."""

    def __init__(self, store: Optional[JournalStore] = None):
        self._store = store
        # key -> {"count", "s_ewma", "n_last", "s_last"}
        self._stats: Dict[str, Dict] = {}
        # observations folded locally but not yet journaled: observe() runs
        # on the engine's execution critical path (the reveal hook), where a
        # per-reveal fsync'd transaction would serialize disk round-trips
        # into every Resize — flush() lands them in one transaction at query
        # finalize / window close instead (calibration is a planning hint,
        # not privacy-critical state, so deferred durability is safe)
        self._pending: list = []
        if store is not None:
            with store.transaction() as sync:
                self._sync(sync)

    # -- journal fold ----------------------------------------------------------
    def _sync(self, sync: SyncResult) -> None:
        if sync.reload:
            self._stats.clear()
            if sync.snapshot:
                self._stats.update(sync.snapshot.get("state", {}))
        for rec in sync.records:
            self._fold(rec)

    def _fold(self, rec: Dict) -> None:
        if rec.get("type") != "obs":
            return
        st = self._stats.setdefault(
            rec["fp"], {"count": 0, "s_ewma": float(rec["s"]),
                        "n_last": 0, "s_last": 0}
        )
        st["count"] += 1
        st["s_ewma"] = (
            EWMA_ALPHA * float(rec["s"])
            + (1.0 - EWMA_ALPHA) * float(st["s_ewma"])
        )
        st["n_last"], st["s_last"] = int(rec["n"]), int(rec["s"])

    # -- recording -------------------------------------------------------------
    def observe(self, key: str, n: int, s: int) -> None:
        """Record one already-revealed (N, S) pair for a subplan key: folded
        into local planning state immediately, journaled (durable + visible
        to every replica) at the next :meth:`flush`."""
        rec = {"type": "obs", "fp": key, "n": int(n), "s": int(s)}
        self._fold(rec)
        if self._store is not None:
            self._pending.append(rec)

    def flush(self) -> None:
        """Journal buffered observations — ONE transaction for all of them,
        off the engine's critical path."""
        if self._store is None or not self._pending:
            return
        pending, self._pending = self._pending, []
        with self._store.transaction() as sync:
            self._sync(sync)
            for rec in pending:
                full = sync.append(rec)
                if sync.reload:
                    # the reload rebuilt _stats from disk, dropping the
                    # buffered local folds — re-fold what we just journaled
                    self._fold(full)

    def observe_plan(self, resize_child: PlanNode, n: int, s: int) -> None:
        self.observe(calibration_key(resize_child), n, s)

    # -- planner hooks ---------------------------------------------------------
    def size_for(self, plan: PlanNode) -> Optional[float]:
        if not self._stats:
            return None  # empty store: skip the fingerprint entirely
        st = self._stats.get(calibration_key(plan))
        return None if st is None else float(st["s_ewma"])

    def refine(self, node: PlanNode, est: Dict, noise) -> Dict:
        """Cost-model refinement: see module docstring. ``est`` is the
        registry estimate ``{"n","t","cols","bytes"}``; returns a (possibly)
        replaced dict — never mutates the input."""
        if not self._stats:
            # computing a subplan fingerprint per node per candidate order is
            # pure waste while nothing has been observed yet — and that is
            # every compile of a freshly-started service
            return est
        if lookup(type(node)).resizer != "internal":
            return est  # only Resizer candidates ever get trimmed
        obs = self.size_for(node)
        if obs is None:
            return est
        out = dict(est)
        t_cal = max(min(obs, est["n"]), 1.0)
        out["t"] = t_cal
        if noise is not None:
            s_eff = min(t_cal + noise.mean(int(est["n"]), int(t_cal)), est["n"])
            out["n"] = max(int(round(s_eff)), 1)
        return out

    # -- persistence / reporting ----------------------------------------------
    def maybe_compact(self, max_wal_bytes: int = 1 << 16) -> bool:
        self.flush()  # buffered observations must reach the WAL first
        if self._store is None or self._store.wal_bytes <= max_wal_bytes:
            return False
        with self._store.transaction() as sync:
            self._sync(sync)
            self._store.compact(dict(self._stats))
        return True

    def __len__(self) -> int:
        return len(self._stats)

    def status(self) -> Dict:
        return {
            "entries": len(self._stats),
            "observations": sum(s["count"] for s in self._stats.values()),
            "pending": len(self._pending),
            "store": None if self._store is None else self._store.status(),
        }
