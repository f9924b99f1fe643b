"""Disclosure audit boundary for all emitted telemetry (DESIGN.md §14.3).

Shrinkwrap's observation — telemetry about intermediate results is itself a
disclosure channel — applies to our own instruments: a span attribute, metric
label, or EXPLAIN line that carries a *secret-dependent* value (the true
selection cardinality T, the sampled noise parameters p/eta that were derived
from T) would leak exactly what the Resizer's noise exists to hide, without
passing through the CRT accountant at all.

This module is the single policy every emitted value passes through:

* :func:`public_view` — default-deny projection of an attribute mapping onto
  the emittable allow-list. Unknown keys are DROPPED (and counted), never
  forwarded: a new internal field is private until someone argues it into
  ``PUBLIC_KEYS`` here, next to the reason it is public.
* :func:`assert_emittable` — the strict twin used by the redaction test
  suite and by exporters in audit mode: raises :class:`RedactionError` on any
  key outside the allow-list.
* :func:`audit_labels` — metric-registration gate: label names must be
  drawn from the public vocabulary (a secret can't even be *named* as a
  metric dimension).

What is emittable, and why (the full argument lives in DESIGN.md §14.3):

* **Oblivious capacities** (``n``, ``n_in``, ``n_ins``, ``n_out``) — padded
  physical sizes, fixed by the plan and public table sizes; every party sees
  them on the wire.
* **Post-reveal sizes** (``s``, ``s_padded``) — the noisy trimmed size S is
  *the* controlled disclosure: it was opened by the protocol and charged to
  the CRT budget by the accountant before any telemetry could mention it.
* **Protocol-determined costs** (``seconds``, ``bytes_per_party``,
  ``rounds``) — functions of static shapes (the ledger is computed by shape
  tracing alone); wall time is the coordinator's own clock.
* **Plan structure** (``node``, ``op``, fingerprints, strategy/addition
  names) — the coordinator compiled the plan; nothing about the data.
* **Service bookkeeping** (tenants, cache hits, batch slots, flush reasons,
  budget/observed/remaining counts, WAL stats) — coordinator-side state.

What is NOT emittable (``SECRET_KEYS``): ``t`` (the true cardinality — the
exact value CRT prices the attacker's estimate of), ``p`` / ``eta`` (the
sampled noise parameters: eta = S - T, so either one plus the public S
reconstructs T).
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterable, Tuple

__all__ = [
    "PUBLIC_KEYS",
    "SECRET_KEYS",
    "RedactionError",
    "public_view",
    "assert_emittable",
    "audit_labels",
    "fingerprint_hash",
]


class RedactionError(ValueError):
    """An emitted value failed the disclosure audit."""


#: Keys whose values are secret-dependent and must NEVER be emitted.
SECRET_KEYS = frozenset({
    "t",        # true cardinality of the resized intermediate
    "p",        # parallel-addition coin probability, sampled from (n, t)
    "eta",      # sequential-addition filler count: eta = S - t exactly
    "true_rows",
    "oracle",
})

#: The emittable vocabulary — every key an argument for being public
#: (see module docstring / DESIGN.md §14.3).
PUBLIC_KEYS = frozenset({
    # oblivious capacities and post-reveal sizes
    "n", "n_in", "n_ins", "n_out", "s", "s_padded", "skipped",
    # protocol-determined costs
    "seconds", "bytes_per_party", "rounds", "wait_seconds",
    # plan / strategy structure
    "node", "op", "label", "strategy", "addition", "fingerprint",
    "sig", "template", "placement", "algo", "cols",
    # service bookkeeping
    "tenant", "sql", "query", "cache_hit", "rebind", "batch_slots", "slots",
    "reason", "ticket", "batched", "queue_depth", "bucket", "escalations",
    "budget", "observed", "remaining", "reserved", "open_intents",
    "refused", "recorded", "policy",
    # engine / jit / batch
    "stacked", "split", "jit", "k", "phase", "est_rows", "est_bytes",
    # state layer
    "journal", "wal_bytes", "records", "generation", "compactions",
    "appends", "fsync",
    # misc identity
    "name", "kind", "status", "ok", "count", "version",
    # multi-party runtime (DESIGN.md §16): the party id is execution
    # topology, and wire-byte/exchange counts equal the ledger's
    # protocol-determined costs by construction (audited in CI)
    "party", "wire_bytes", "exchanges", "transport", "peer",
    # offline randomness pool (DESIGN.md §15): hit/miss counts are cache
    # bookkeeping over *template-derived* material — the pool key is the
    # template fingerprint plus pow2 shape buckets, both already public plan
    # structure; depths/refill stats are coordinator-side memory accounting
    "offline", "hits", "misses", "depth", "depth_bytes", "entries",
    "refills", "trigger", "watermark", "evictions", "gc_dropped",
    "static_entries", "counter_entries", "recipes", "bundles",
    # distributed observability (DESIGN.md §17): wire/link accounting is
    # protocol-determined — per-link frame and byte counts equal the ledger's
    # analytic tallies by the coordinator's audit, sequence watermarks are
    # framing metadata every party already sees on the wire, and stall /
    # send / backoff durations are each process's own wall clock (the same
    # argument as "seconds" above). Trace identity (trace_id, clock offsets)
    # is coordinator-chosen plumbing, independent of any secret value.
    "wire", "link", "links", "frames", "bytes", "sent", "recv",
    "stall_seconds", "retries", "backoff_seconds", "rejects", "connects",
    "seq", "queries", "mesh", "up", "clock_offset_s", "trace_id",
    "rtt_seconds", "parties", "spans", "merged",
})


def fingerprint_hash(fp: str) -> str:
    """Short stable id for a (multi-line) plan fingerprint — fingerprints are
    public plan structure, but raw ones are unusable as metric labels."""
    return hashlib.sha1(fp.encode()).hexdigest()[:12]


def _walk(mapping: Dict, path: str = "") -> Iterable[Tuple[str, str, object]]:
    for k, v in mapping.items():
        here = f"{path}.{k}" if path else str(k)
        yield here, str(k), v
        if isinstance(v, dict):
            yield from _walk(v, here)


def public_view(mapping: Dict, dropped: list | None = None) -> Dict:
    """Project ``mapping`` onto the allow-list (recursing into dicts).

    Default-deny: a key neither public nor secret is still dropped — it just
    also lands in ``dropped`` (when given) so callers can count redactions.
    """
    out: Dict = {}
    for k, v in mapping.items():
        if str(k) in SECRET_KEYS or str(k) not in PUBLIC_KEYS:
            if dropped is not None:
                dropped.append(str(k))
            continue
        out[k] = public_view(v, dropped) if isinstance(v, dict) else v
    return out


def assert_emittable(mapping: Dict, where: str = "telemetry") -> None:
    """Strict audit: raise :class:`RedactionError` if ``mapping`` (including
    nested dicts) carries any key outside :data:`PUBLIC_KEYS`."""
    for path, key, _v in _walk(mapping):
        if key in SECRET_KEYS:
            raise RedactionError(
                f"{where}: secret-dependent key {path!r} must never be emitted"
            )
        if key not in PUBLIC_KEYS:
            raise RedactionError(
                f"{where}: key {path!r} is not in the emittable allow-list "
                "(obs/redact.py PUBLIC_KEYS); argue it public there first"
            )


def audit_labels(metric: str, labelnames: Iterable[str]) -> None:
    """Metric-registration gate: every label dimension must be a public
    vocabulary word (checked once, at registry time — fail fast)."""
    for name in labelnames:
        if name in SECRET_KEYS:
            raise RedactionError(
                f"metric {metric!r}: label {name!r} is secret-dependent"
            )
        if name not in PUBLIC_KEYS:
            raise RedactionError(
                f"metric {metric!r}: label {name!r} is not in the emittable "
                "allow-list (obs/redact.py PUBLIC_KEYS)"
            )
