"""PrivacyAccountant: the CRT metric enforced as a runtime budget (a port of
``repro.service.accountant``; signatures are the same strings, so the two
packages' journals are interchangeable).

The paper's Cardinality Recovery Threshold (core/crt.py, §3.3) says how many
*equivalent observations* r of a noisy intermediate size S = T + eta an
attacker needs to pin the true size T within ±err at confidence alpha. The
offline metric guards nothing: an engine that happily serves observation
r + 1 hands the attacker exactly the sample mean it needs. This module turns
the metric into an admission-control budget (DESIGN.md §9).

**What counts as one observation.** Every non-NoTrim ``Resize`` node reveals
one noisy size S when it trims. Two reveals are *equivalent* — i.i.d. draws
of the same S distribution — iff they resize the same logical intermediate
(structurally identical subplan over the same base tables, hence the same T)
using the same noise strategy and addition design. The observation signature
is therefore ``(fingerprint(child subplan), strategy key, addition)``; the
budget for a signature is ``floor(crt_rounds(noise, addition, N, T, err,
confidence))``, initialized on first observation (when N and T are known) and
decremented on every subsequent one. Budgets are *global* across tenants —
colluding tenants submitting the same query are one attacker.

**Depletion.** When a signature's budget is exhausted the accountant either
refuses the query (``policy="refuse"``) or escalates the noise strategy
(``policy="escalate"``): TLap eps is halved (4x the variance, so ~4x the
fresh budget) until ``min_eps``, then the Resizer degenerates to NoTrim —
no trim, no disclosure, no budget to spend. Observations under the escalated
strategy form a *new* signature: mixing draws from different distributions
does not refund the attacker's spent observations (Eq. 1 assumes i.i.d.
noise), so per-strategy accounting is conservative and correct.

**Durability (DESIGN.md §12).** With a :class:`repro_torch.state.JournalStore`
attached, the ledger survives restarts and is shared across replicas via a
two-phase **intent -> record** protocol: ``admit`` journals one *intent* per
observation it is about to allow — durably, *before* the engine reveals
anything — and ``record``/``charge_failed`` later journal the matching
*record*/*charge*. An intent without a matching record (a crash between
reveal and record, or a torn record line) stays open forever and counts
against the budget exactly like a spent observation — the attacker may
already hold the sample — so crash-replay refuses at-or-before where an
uninterrupted run would, never after. A torn *intent* line means the append
never returned, so the engine never ran: dropping it discloses nothing.
Open intents owned by *this* session are excluded from ``remaining`` (they
are already counted by the in-memory admission group ``planned``); foreign
open intents — other live replicas' in-flight queries, or a dead session's
conservative charges — are subtracted like observations.

Simulation note: T is read from the Resizer's oracle info — the coordinator-
side trusted state a real deployment would hold as each party's share of the
accounting, or bound via a DP estimate.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Tuple

from ..core.crt import crt_rounds
from ..errors import BudgetRefused
from ..core.noise import BetaNoise, NoiseStrategy, NoTrim, TruncatedLaplace
from ..engine.executor import ExecutionReport
from ..plan.nodes import PlanNode, Resize
from ..sql.compile import plan_fingerprint

__all__ = ["PrivacyAccountant", "QueryRefused", "strategy_key", "escalate_strategy"]

# The refusal error lives in the typed taxonomy (repro_torch.errors); the
# reference's old name stays importable here. BudgetRefused subclasses
# RuntimeError.
QueryRefused = BudgetRefused


def strategy_key(noise: NoiseStrategy, addition: str) -> str:
    """Stable identity of a (noise strategy, addition design) pair — dataclass
    repr carries every calibration parameter."""
    return f"{noise!r}|{addition}"


def escalate_strategy(
    noise: NoiseStrategy, min_eps: float = 0.0625
) -> Optional[NoiseStrategy]:
    """Next rung of the noise ladder, or None if there is none (NoTrim).

    TLap: halve eps (b doubles, Var(eta) ~ 4x, so Eq. 1 gives ~4x budget)
    until min_eps, then NoTrim. Beta: halve (alpha, beta) — same mean
    fraction, fatter spread — until alpha < 0.5, then NoTrim. Everything
    else jumps straight to NoTrim (fully oblivious: nothing disclosed).
    """
    if isinstance(noise, NoTrim):
        return None
    if isinstance(noise, TruncatedLaplace) and noise.eps / 2.0 >= min_eps:
        return TruncatedLaplace(
            eps=noise.eps / 2.0, delta=noise.delta, sensitivity=noise.sensitivity
        )
    if isinstance(noise, BetaNoise) and noise.alpha / 2.0 >= 0.5:
        return BetaNoise(alpha=noise.alpha / 2.0, beta=noise.beta / 2.0)
    return NoTrim()


def _iter_resizes(plan: PlanNode, include_notrim: bool = False):
    """Post-order (== execution-order) Resize nodes of a plan — the one
    traversal shared by reservation, release, charge, and record, so their
    eligibility rules cannot drift apart."""
    for c in plan.children():
        yield from _iter_resizes(c, include_notrim)
    if isinstance(plan, Resize) and (
        include_notrim or not isinstance(plan.cfg.noise, NoTrim)
    ):
        yield plan


def _drop_reservations(
    planned: Dict[Tuple[str, str], int], sig: Tuple[str, str], count: int = 1
) -> None:
    left = planned.get(sig, 0) - count
    if left > 0:
        planned[sig] = left
    else:
        planned.pop(sig, None)


@dataclasses.dataclass
class _SigState:
    observed: int = 0
    budget: Optional[int] = None  # set at first observation (needs N, T)
    n: int = 0
    t: int = 0
    # open intents: journaled "about to reveal" charges not yet matched by a
    # record (intent id -> owner session). Foreign entries count against the
    # budget like observations (conservative: the sample may be out there).
    intents: Dict[str, str] = dataclasses.field(default_factory=dict)


class PrivacyAccountant:
    """Tracks per-signature observation counts against ``crt_rounds`` and
    rewrites (or refuses) plans whose next reveal would exceed the budget."""

    def __init__(
        self,
        err: float = 1.0,
        confidence: float = 0.999,
        policy: str = "escalate",  # "escalate" | "refuse"
        min_eps: float = 0.0625,
        store=None,  # repro_torch.state.JournalStore for a durable, shared ledger
    ):
        if policy not in ("escalate", "refuse"):
            raise ValueError(f"unknown policy {policy!r}")
        self.err = err
        self.confidence = confidence
        self.policy = policy
        self.min_eps = min_eps
        self._state: Dict[Tuple[str, str], _SigState] = {}
        self.escalation_count = 0
        self.refusal_count = 0
        self._store = None
        self._intent_ids = itertools.count(1)
        if store is not None:
            self.attach_store(store)

    # -- durable journal (intent -> record; see module docstring) -------------
    @property
    def durable(self) -> bool:
        return self._store is not None

    @property
    def store(self):
        return self._store

    def attach_store(self, store) -> None:
        """Bind a :class:`repro_torch.state.JournalStore` and fold its snapshot +
        WAL into this accountant's state. Every open intent found on disk
        belongs to some *other* (possibly dead) session and is conservatively
        counted against its signature's budget from here on.

        Observations charged while this accountant ran non-durably are NOT
        discarded: they merge on top of the journal's state (summed observed,
        the tighter budget). They stay local-only — the journal has no record
        of them, so other replicas cannot see them — which errs toward
        refusing earlier here, never toward extra disclosure anywhere."""
        if self._store is not None:
            raise ValueError("accountant already has a journal store")
        pre = self._state
        self._state = {}
        self._store = store
        with store.transaction() as sync:
            self._sync(sync)
        for sig, st_mem in pre.items():
            st = self._state.get(sig)
            if st is None:
                self._state[sig] = st_mem
                continue
            st.observed += st_mem.observed
            st.intents.update(st_mem.intents)
            if st_mem.budget is not None and (
                st.budget is None or st_mem.budget < st.budget
            ):
                st.budget, st.n, st.t = st_mem.budget, st_mem.n, st_mem.t

    def _sync(self, sync) -> None:
        if sync.reload:
            self._state.clear()
            if sync.snapshot:
                self._load_snapshot(sync.snapshot.get("state", {}))
        for rec in sync.records:
            self._apply(rec)

    def _apply(self, rec: Dict) -> None:
        """Fold one journal record into in-memory state — the single place
        WAL semantics are defined (startup replay, tail-sync, and this
        session's own appends all route through here)."""
        typ = rec.get("type")
        if typ not in ("intent", "record", "charge"):
            return
        sig = (rec["fp"], rec["strat"])
        st = self._state.setdefault(sig, _SigState())
        if typ == "intent":
            st.intents[rec["intent"]] = rec.get("owner", "?")
            return
        iid = rec.get("intent")
        if iid is not None:
            st.intents.pop(iid, None)
        st.observed += 1
        if typ == "record" and st.budget is None:
            st.n, st.t = int(rec["n"]), int(rec["t"])
            st.budget = int(rec["budget"])

    def _load_snapshot(self, blob: Dict) -> None:
        for entry in blob.get("sigs", []):
            self._state[(entry["fp"], entry["strat"])] = _SigState(
                observed=int(entry["observed"]),
                budget=entry["budget"],
                n=int(entry["n"]),
                t=int(entry["t"]),
                intents=dict(entry.get("intents", {})),
            )

    def _snapshot_blob(self) -> Dict:
        return {
            "sigs": [
                {
                    "fp": sig[0],
                    "strat": sig[1],
                    "observed": st.observed,
                    "budget": st.budget,
                    "n": st.n,
                    "t": st.t,
                    "intents": dict(st.intents),
                }
                for sig, st in self._state.items()
            ]
        }

    def maybe_compact(self, max_wal_bytes: int = 1 << 16) -> bool:
        """Fold the WAL into a snapshot once it outgrows ``max_wal_bytes``
        (open intents are preserved in the snapshot — compaction never
        forgets a conservative charge)."""
        if self._store is None or self._store.wal_bytes <= max_wal_bytes:
            return False
        with self._store.transaction() as sync:
            self._sync(sync)
            self._store.compact(self._snapshot_blob())
        return True

    def _oldest_own_intent(self, sig: Tuple[str, str]) -> Optional[str]:
        st = self._state.get(sig)
        if st is None or self._store is None:
            return None
        own = self._store.session
        for iid, owner in st.intents.items():  # dict preserves append order
            if owner == own:
                return iid
        return None

    def _reserved(self, sig: Tuple[str, str]) -> int:
        """Foreign open intents: other replicas' in-flight observations and
        dead sessions' conservative charges. This session's own open intents
        are excluded — ``planned`` already counts them at admission."""
        st = self._state.get(sig)
        if st is None or not st.intents:
            return 0
        own = self._store.session if self._store is not None else None
        return sum(1 for owner in st.intents.values() if owner != own)

    # -- signatures -----------------------------------------------------------
    def signature(self, node: Resize) -> Tuple[str, str]:
        # strategy_key already embeds the addition design
        return (
            plan_fingerprint(node.child),
            strategy_key(node.cfg.noise, node.cfg.addition),
        )

    def budget_for(self, noise: NoiseStrategy, addition: str, n: int, t: int) -> int:
        """floor(crt_rounds): the number of equivalent observations that may
        be disclosed before the attacker's Eq. 1 estimator reaches ±err at
        the configured confidence."""
        return int(
            math.floor(
                crt_rounds(noise, addition, n, t, err=self.err,
                           confidence=self.confidence)
            )
        )

    def remaining(self, sig: Tuple[str, str]) -> Optional[int]:
        st = self._state.get(sig)
        if st is None or st.budget is None:
            return None  # not yet observed: first observation is always free
        return st.budget - st.observed - self._reserved(sig)

    def spent(self, sig: Tuple[str, str]) -> int:
        """Observations charged against ``sig`` including open (foreign)
        intents — the conservative count crash-recovery tests assert on."""
        st = self._state.get(sig)
        if st is None:
            return 0
        return st.observed + len(st.intents)

    # -- admission ------------------------------------------------------------
    def admit(
        self, plan: PlanNode, planned: Optional[Dict[Tuple[str, str], int]] = None
    ) -> Tuple[PlanNode, List[Dict]]:
        """Durable path: sync foreign journal records, decide, then journal
        one *intent* per reserved observation — all under the state lease, so
        two replicas can never jointly overdraw — before any engine work.
        Non-durable path: the in-memory decision alone (see below)."""
        if self._store is None:
            return self._admit_locked(plan, planned)[:2]
        with self._store.transaction() as sync:
            self._sync(sync)
            admitted, escalations, added = self._admit_locked(plan, planned)
            for sig, count in added.items():
                for _ in range(count):
                    iid = f"{self._store.session}-{next(self._intent_ids)}"
                    self._apply(sync.append({
                        "type": "intent", "fp": sig[0], "strat": sig[1],
                        "intent": iid,
                    }))
            return admitted, escalations

    def _admit_locked(
        self, plan: PlanNode, planned: Optional[Dict[Tuple[str, str], int]] = None
    ) -> Tuple[PlanNode, List[Dict], Dict[Tuple[str, str], int]]:
        """Check every Resize in the plan against its budget. Returns a
        (possibly rewritten) plan plus the escalation records. Raises
        :class:`QueryRefused` under ``policy='refuse'``. The input plan is
        never mutated (it may be cache-shared).

        A plan may contain several Resizes with the *same* signature
        (duplicated subtrees, e.g. a self-join); ``planned`` charges them
        against the remaining budget as a group so a single admit cannot
        overdraw a known budget. (A signature's very first budget is only
        learned at execution, so duplicates inside the first-ever plan for a
        signature may still spend up to that plan's multiplicity.)

        Pass an explicit ``planned`` dict to extend that group across
        *several* admits: the admission scheduler threads one dict through
        every query queued in the same drain window, so K queued queries with
        the same signature spend K observations against the remaining budget
        at admit time — exactly what a serial admit/record interleaving would
        have charged — even though their ``record`` calls all land after the
        batched execution. The dict is mutated in place; drop it once the
        window's records are committed."""
        escalations: List[Dict] = []
        if planned is None:
            planned = {}
        added: Dict[Tuple[str, str], int] = {}  # this admit's reservations

        def reserve(sig: Tuple[str, str]) -> None:
            planned[sig] = planned.get(sig, 0) + 1
            added[sig] = added.get(sig, 0) + 1

        def rewrite(node: PlanNode) -> PlanNode:
            old_children = node.children()
            new_children = [rewrite(c) for c in old_children]
            if any(n is not o for n, o in zip(new_children, old_children)):
                node = node.replace_children(new_children)  # preserve identity
                # when nothing changed: cache hits stay shared objects
            if not isinstance(node, Resize) or isinstance(node.cfg.noise, NoTrim):
                return node
            while True:
                sig = self.signature(node)
                rem = self.remaining(sig)
                if rem is None or rem - planned.get(sig, 0) > 0:
                    reserve(sig)
                    return node
                st = self._state[sig]
                if self.policy == "refuse":
                    self.refusal_count += 1
                    raise QueryRefused(sig, st.observed, st.budget)
                nxt = escalate_strategy(node.cfg.noise, self.min_eps)
                if nxt is None:
                    return node  # already NoTrim: nothing disclosed
                self.escalation_count += 1
                escalations.append(
                    {
                        "from": strategy_key(node.cfg.noise, node.cfg.addition),
                        "to": strategy_key(nxt, node.cfg.addition),
                        "observed": st.observed,
                        "budget": st.budget,
                    }
                )
                node = Resize(
                    node.child, dataclasses.replace(node.cfg, noise=nxt)
                )
                if isinstance(nxt, NoTrim):
                    return node

        try:
            return rewrite(plan), escalations, added
        except QueryRefused:
            # a refused query executes nothing: roll this admit's reservations
            # back out of the (possibly caller-shared) admission group, or
            # they would shrink other queries' effective budgets forever
            # (no intents were journaled yet — they are appended only after
            # the whole rewrite succeeds)
            for sig, count in added.items():
                _drop_reservations(planned, sig, count)
            raise

    def release_planned(
        self, plan: PlanNode, planned: Dict[Tuple[str, str], int]
    ) -> None:
        """Drop a now-recorded plan's contributions from an admission group:
        once :meth:`record` has charged the plan's observations to the real
        per-signature state, keeping them in ``planned`` too would double-
        count them against queries admitted later in the same window."""
        for node in _iter_resizes(plan):
            _drop_reservations(planned, self.signature(node))

    def charge_failed(self, plan: PlanNode) -> None:
        """Conservatively charge one observation per non-NoTrim Resize of a
        plan whose execution may have disclosed its noisy sizes but could not
        be recorded (engine failure mid-plan, demux/record failure): the
        attacker may already hold the sample, so the budget must count it —
        over-charging a plan that in fact died before its reveal only errs
        toward refusing/escalating earlier, never toward extra disclosure.
        A never-seen signature keeps ``budget=None``; a later successful
        record initializes it with these observations already spent.

        Durable path: journals a *charge* record closing this plan's open
        intent (the same net state a crash-replay would reach)."""
        if self._store is None:
            for node in _iter_resizes(plan):
                self._state.setdefault(
                    self.signature(node), _SigState()
                ).observed += 1
            return
        with self._store.transaction() as sync:
            self._sync(sync)
            for node in _iter_resizes(plan):
                sig = self.signature(node)
                self._apply(sync.append({
                    "type": "charge", "fp": sig[0], "strat": sig[1],
                    "intent": self._oldest_own_intent(sig),
                }))

    # -- recording ------------------------------------------------------------
    def record(self, plan: PlanNode, report: ExecutionReport) -> None:
        """Charge one observation per executed non-NoTrim Resize, matching
        plan Resize nodes (post-order == execution order) to the report's
        per-node resize info to learn (N, T) for budget initialization.

        Durable path: each charge is journaled as a *record* closing the
        oldest open intent this session holds for the signature (equivalent
        observations are i.i.d. draws, so oldest-first matching is exact)."""
        resizes = list(_iter_resizes(plan, include_notrim=True))
        infos = [s.extra for s in report.nodes if s.node.startswith("Resize")]
        if len(infos) != len(resizes):
            raise RuntimeError(
                f"report has {len(infos)} resize entries for "
                f"{len(resizes)} Resize nodes — cannot attribute observations"
            )
        charges = [
            (node, info)
            for node, info in zip(resizes, infos)
            if not (isinstance(node.cfg.noise, NoTrim) or info.get("skipped"))
        ]
        if self._store is None:
            for node, info in charges:
                self._charge_observation(self.signature(node), node, info)
            return
        with self._store.transaction() as sync:
            self._sync(sync)
            for node, info in charges:
                sig = self.signature(node)
                n, t = int(info["n"]), int(info["t"])
                budget = max(
                    self.budget_for(node.cfg.noise, node.cfg.addition, n, t), 1
                )
                self._apply(sync.append({
                    "type": "record", "fp": sig[0], "strat": sig[1],
                    "intent": self._oldest_own_intent(sig),
                    "n": n, "t": t, "budget": budget,
                }))

    def _charge_observation(self, sig, node, info) -> None:
        st = self._state.setdefault(sig, _SigState())
        if st.budget is None:
            st.n, st.t = int(info["n"]), int(info["t"])
            st.budget = max(
                self.budget_for(node.cfg.noise, node.cfg.addition, st.n, st.t),
                1,
            )
        st.observed += 1

    # -- reporting ------------------------------------------------------------
    def budget_metrics(self) -> List[Dict]:
        """Per-signature budget burn-down for the metrics registry. Unlike
        :meth:`status` (the coordinator-side trusted API) this view is
        export-safe: full fingerprints for the caller to hash into labels,
        observed/budget/remaining counts — and no true cardinality T."""
        return [
            {
                "fp": sig[0],
                "strategy": sig[1],
                "observed": st.observed,
                "budget": st.budget,
                "remaining": None if st.budget is None
                else st.budget - st.observed - self._reserved(sig),
            }
            for sig, st in self._state.items()
        ]

    def status(self) -> List[Dict]:
        return [
            {
                "subplan": sig[0].splitlines()[0],
                "strategy": sig[1],
                "observed": st.observed,
                "budget": st.budget,
                "remaining": None if st.budget is None
                else st.budget - st.observed - self._reserved(sig),
                "reserved": self._reserved(sig),
                "open_intents": len(st.intents),
                "n": st.n,
                "t": st.t,
            }
            for sig, st in self._state.items()
        ]
