"""The randomness pool: content-addressed precomputed correlated randomness
(a port of ``repro.offline.pool``).

Storage model (DESIGN.md §15.2)
-------------------------------

Material falls into two classes with different lifetimes:

* **Template-static** material — every derivation whose PRF-fold path does
  not pass through a Resizer counter root (filter/gate/conversion folds,
  sort and shuffle controls of stateless operators). The fold tags are
  static per plan template, so the same entries serve every execution of
  the template: a pure memo, stored per (template fingerprint, shape-key)
  bundle and evicted LRU under the byte budget.
* **Counter-dependent** material — everything derived under a Resizer's
  per-execution root fold ``prf.fold(900 + ctr)``. Counters never repeat,
  so these entries are single-use: stored in a global content-addressed
  map tagged with their counter and garbage-collected once the engine's
  counter watermark passes them.

Counter-range ownership: the engine's ``_resize_ctr`` is the *only*
allocator of counters; the pool never advances it. The pool merely owns
**material** for a declared range of upcoming counters (``owned_counters``)
— a pooled counter the engine never reaches is garbage-collected, and an
engine counter the pool never provisioned is an ordinary miss that falls
back to on-demand derivation *from the same counter*, so the counter
stream never splits between hot and cold executions.

Recording and replay
--------------------

The first (cold) execution of a template runs under a recording
:class:`PoolSource`: every derivation event is captured as
``(op, parent-ref, args)`` where the parent-ref points at the event that
produced the parent pair-keys (or at the engine's base PRF). Static events
are inserted into the pool as they are computed (record-and-fill); events
under a counter root form a per-root *recipe subtree* that the
:class:`~repro.offline.provisioner.Provisioner` replays later with future
counter tags to provision material the engine has not drawn yet. Replay
calls the same derivation functions the online path's ``compute`` closures
call (``core/prf.py``: ``_fold_keys`` / ``_draw_bits`` / ``_draw_uniform`` /
``zero_share_unpooled``; ``core/shuffle.py``: ``threefry.permutation``),
which is what makes hits bit-identical to misses.

Device and widths
-----------------
Keys are (3, 2) int32 CPU tensors, so folds are host arithmetic; draws,
zero sharings and permutations are derived on the pool's ``device``, the
engine's. A hop permutation is kept as int32, the width of JAX's, and
widened to the int64 index the gather takes when served. Bytes are counted
from shapes (``numel() * element_size()``), never by copying a tensor to
the host, and equal the reference's counts for the same entries.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np
import torch

from ..config import resolve_device
from ..core import material, threefry
from ..core.prf import PRFSetup, _draw_bits, _draw_uniform, _fold_keys, zero_share_unpooled

__all__ = ["RandomnessPool", "PoolSource", "Recipe", "RESIZE_TAG_LO", "RESIZE_TAG_HI"]

# The engine derives each Resizer's per-execution randomness from
# eng.prf.fold(900 + ctr) (plan/registry.py _apply_resize). Tags in this
# window folded directly from the engine's base PRF are counter roots;
# everything else folded from the base is template-static.
RESIZE_TAG_LO = 900
RESIZE_TAG_HI = 1000


def _derive(op: str, parent: torch.Tensor, args: tuple, device) -> torch.Tensor:
    """The on-demand derivation for one recorded event — identical to the
    compute() closures at the call sites in core/prf.py and core/shuffle.py."""
    if op == "fold":
        return _fold_keys(parent, args[0])
    if op == "draw":
        return _draw_bits(parent, tuple(args[0]), device)
    if op == "uniform":
        return _draw_uniform(parent, tuple(args[0]), device)
    if op in ("zero_add", "zero_xor"):
        return zero_share_unpooled(PRFSetup(parent), tuple(args[0]), device, xor=op == "zero_xor")
    if op == "perm":
        hop, n = args
        return threefry.permutation(parent[hop], n, device)
    raise ValueError(f"unknown derivation op {op!r}")


def _stored(op: str, val: torch.Tensor) -> torch.Tensor:
    """The pool's form of a value: a permutation narrowed to int32."""
    return val.to(torch.int32) if op == "perm" else val


def _served(op: str, val: torch.Tensor) -> torch.Tensor:
    """The call site's form of a pooled value: a permutation as int64."""
    return val.to(torch.int64) if op == "perm" else val


def _nbytes(val: torch.Tensor) -> int:
    return val.numel() * val.element_size()


def _key_bytes(pair_keys: torch.Tensor) -> bytes:
    return material.content_key("", pair_keys, ())[1]


@dataclasses.dataclass(frozen=True)
class _Event:
    op: str
    parent: tuple  # ("base",) | ("ev", producing event index) | ("lit", bytes)
    args: tuple
    root: Optional[int]  # counter-root ordinal, None for template-static
    is_root: bool  # the fold event that opens a counter subtree


@dataclasses.dataclass(frozen=True)
class Recipe:
    """The recorded derivation DAG of one template execution."""

    events: Tuple[_Event, ...]
    n_roots: int  # number of Resizer counter roots (== resizes per execution)

    def static_events(self) -> List[Tuple[int, _Event]]:
        return [(i, e) for i, e in enumerate(self.events) if e.root is None]


class RandomnessPool:
    """Bounded store of precomputed correlated randomness.

    Thread-safe: consumption (engine thread) and refill (provisioner
    thread) interleave under one lock; no caller writes into a served
    tensor, so a served reference never changes under the reader.
    ``device`` (default ``"cuda"``; raises without a card unless ``"cpu"``)
    is where draws are derived: the engine's device.
    """

    def __init__(self, max_bytes: int = 64 << 20, device=None):
        self.max_bytes = int(max_bytes)
        self.device = resolve_device(device)
        self._lock = threading.RLock()
        # bundle_key -> {content_key -> value}; OrderedDict for bundle LRU
        self._static: "OrderedDict[tuple, Dict[tuple, torch.Tensor]]" = OrderedDict()
        self._static_bytes: Dict[tuple, int] = {}
        # content_key -> (value, counter); single-use, GC'd by watermark
        self._counter: Dict[tuple, Tuple[torch.Tensor, int]] = {}
        self._counter_bytes = 0
        self._recipes: Dict[tuple, Recipe] = {}
        self._provisioned: Dict[tuple, Set[int]] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.gc_dropped = 0

    # -- consumption ---------------------------------------------------------

    def take(self, bundle_key: tuple, key: tuple) -> Optional[torch.Tensor]:
        """Serve a precomputed value, or None (caller derives on demand).
        Entries are NOT removed on take: static entries are memos, and
        counter entries can legitimately be re-fetched within one execution
        (e.g. the lazy-payload path re-deriving the shuffle's hop perms)."""
        with self._lock:
            bundle = self._static.get(bundle_key)
            if bundle is not None:
                val = bundle.get(key)
                if val is not None:
                    self._static.move_to_end(bundle_key)
                    self.hits += 1
                    return val
            ent = self._counter.get(key)
            if ent is not None:
                self.hits += 1
                return ent[0]
            self.misses += 1
            return None

    # -- filling -------------------------------------------------------------

    def put(self, bundle_key: tuple, key: tuple, val: torch.Tensor) -> None:
        """Insert template-static material (memo class)."""
        val = _stored(key[0], val)
        nbytes = _nbytes(val)
        with self._lock:
            bundle = self._static.setdefault(bundle_key, {})
            if key in bundle:
                return
            bundle[key] = val
            self._static_bytes[bundle_key] = (
                self._static_bytes.get(bundle_key, 0) + nbytes
            )
            self._static.move_to_end(bundle_key)
            self._enforce_budget(protect=bundle_key)

    def put_counter(self, key: tuple, val: torch.Tensor, ctr: int) -> None:
        """Insert counter-dependent material for a future counter."""
        val = _stored(key[0], val)
        nbytes = _nbytes(val)
        with self._lock:
            if key in self._counter:
                return
            self._counter[key] = (val, int(ctr))
            self._counter_bytes += nbytes
            self._enforce_budget()

    def _enforce_budget(self, protect: Optional[tuple] = None) -> None:
        # evict least-recently-used static bundles first (they can always be
        # re-derived); counter entries expire via gc() instead
        while self.total_bytes() > self.max_bytes and len(self._static) > (
            1 if protect in self._static else 0
        ):
            for bk in self._static:
                if bk != protect:
                    self._drop_bundle(bk)
                    self.evictions += 1
                    break
            else:
                break

    def _drop_bundle(self, bundle_key: tuple) -> None:
        self._static.pop(bundle_key, None)
        self._static_bytes.pop(bundle_key, None)

    def gc(self, counter_watermark: int) -> int:
        """Drop counter entries at or below the engine's counter watermark:
        those counters have been allocated (or skipped) and never recur."""
        with self._lock:
            dead = [k for k, (_, c) in self._counter.items() if c <= counter_watermark]
            for k in dead:
                val, _ = self._counter.pop(k)
                self._counter_bytes -= _nbytes(val)
            for owned in self._provisioned.values():
                owned.difference_update(
                    {c for c in owned if c <= counter_watermark}
                )
            self.gc_dropped += len(dead)
            return len(dead)

    # -- recipes + provisioning ---------------------------------------------

    def register_recipe(self, bundle_key: tuple, recipe: Recipe) -> None:
        with self._lock:
            self._recipes.setdefault(bundle_key, recipe)

    def has_recipe(self, bundle_key: tuple) -> bool:
        with self._lock:
            return bundle_key in self._recipes

    def recipes(self) -> List[tuple]:
        with self._lock:
            return list(self._recipes)

    def ensure_static(self, bundle_key: tuple, base_pair_keys: torch.Tensor) -> int:
        """Re-derive a bundle's template-static entries (after eviction or a
        restart with a persisted recipe). Returns the number of entries made."""
        with self._lock:
            recipe = self._recipes.get(bundle_key)
            if recipe is None:
                return 0
            todo = recipe.static_events()
        env: Dict[int, torch.Tensor] = {}
        made = 0
        for i, ev in todo:
            parent = self._resolve_parent(ev, env, base_pair_keys)
            if parent is None:
                continue
            key = (ev.op, _key_bytes(parent), ev.args)
            with self._lock:
                val = self._static.get(bundle_key, {}).get(key)
            if val is None:
                val = _derive(ev.op, parent, ev.args, self.device)
                self.put(bundle_key, key, val)
                made += 1
            if ev.op == "fold":
                env[i] = val
        return made

    def provision(
        self,
        bundle_key: tuple,
        base_pair_keys: torch.Tensor,
        counters: Iterable[int],
    ) -> int:
        """Precompute the counter-dependent material of ``bundle_key`` for
        each future counter in ``counters`` (every root subtree is replayed
        per counter, since which Resizer lands on which counter depends on
        future admission order). Returns the number of entries made."""
        with self._lock:
            recipe = self._recipes.get(bundle_key)
            if recipe is None or recipe.n_roots == 0:
                return 0
            owned = self._provisioned.setdefault(bundle_key, set())
            todo = [c for c in counters if c not in owned]
        made = 0
        for ctr in todo:
            if self.total_bytes() >= self.max_bytes:
                break
            for root in range(recipe.n_roots):
                made += self._replay_root(recipe, base_pair_keys, root, ctr)
            with self._lock:
                self._provisioned[bundle_key].add(ctr)
        return made

    def _replay_root(
        self, recipe: Recipe, base_pair_keys: torch.Tensor, root: int, ctr: int
    ) -> int:
        env: Dict[int, torch.Tensor] = {}
        made = 0
        for i, ev in enumerate(recipe.events):
            if ev.root != root:
                continue
            parent = self._resolve_parent(ev, env, base_pair_keys)
            if parent is None:
                return made  # unresolvable chain: leave the rest on-demand
            args = (RESIZE_TAG_LO + ctr,) if ev.is_root else ev.args
            val = _derive(ev.op, parent, args, self.device)
            key = (ev.op, _key_bytes(parent), args)
            self.put_counter(key, val, ctr)
            made += 1
            if ev.op == "fold":
                env[i] = val
        return made

    @staticmethod
    def _resolve_parent(
        ev: _Event, env: Dict[int, torch.Tensor], base_pair_keys: torch.Tensor
    ) -> Optional[torch.Tensor]:
        kind = ev.parent[0]
        if kind == "base":
            return base_pair_keys
        if kind == "ev":
            return env.get(ev.parent[1])
        # literal parent: pair keys produced outside the recorded stream
        # (should not occur under counter roots; static replay uses verbatim)
        raw = np.frombuffer(ev.parent[1], dtype=np.uint32).view(np.int32)
        return torch.from_numpy(raw.reshape(3, 2).copy())

    # -- introspection -------------------------------------------------------

    def total_bytes(self) -> int:
        with self._lock:
            return sum(self._static_bytes.values()) + self._counter_bytes

    def owned_counters(self, bundle_key: tuple) -> Tuple[int, int, int]:
        """(lo, hi, count) of counters provisioned for this bundle."""
        with self._lock:
            owned = self._provisioned.get(bundle_key) or set()
            if not owned:
                return (0, 0, 0)
            return (min(owned), max(owned), len(owned))

    def stats(self) -> dict:
        with self._lock:
            return {
                "bundles": len(self._static),
                "static_entries": sum(len(b) for b in self._static.values()),
                "counter_entries": len(self._counter),
                "depth_bytes": self.total_bytes(),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "gc_dropped": self.gc_dropped,
                "recipes": len(self._recipes),
            }

    def source(
        self,
        bundle_key: tuple,
        base_pair_keys: torch.Tensor,
        record: Optional[bool] = None,
    ) -> "PoolSource":
        """A per-execution consumption handle. ``record`` defaults to True
        exactly when this bundle has no recipe yet (first cold run)."""
        if record is None:
            record = not self.has_recipe(bundle_key)
        return PoolSource(self, bundle_key, base_pair_keys, record=record)


class PoolSource(material.MaterialSource):
    """One execution's window onto the pool: serves hits, derives misses,
    and (on the first cold run of a template) records the derivation DAG."""

    def __init__(
        self,
        pool: RandomnessPool,
        bundle_key: tuple,
        base_pair_keys: torch.Tensor,
        record: bool = False,
    ):
        self.pool = pool
        self.bundle_key = bundle_key
        self.base_bytes = _key_bytes(base_pair_keys)
        self.record = record
        self.hits = 0
        self.misses = 0
        self._events: List[_Event] = []
        self._produced: Dict[bytes, int] = {}  # fold output bytes -> event idx
        self._root_of: Dict[bytes, int] = {}  # pair-key bytes -> root ordinal
        self._seen: Set[tuple] = set()
        self._n_roots = 0

    def fetch(self, op, pair_keys, args, compute):
        pk_bytes = _key_bytes(pair_keys)
        key = (op, pk_bytes, args)
        val = self.pool.take(self.bundle_key, key)
        if val is None:
            self.misses += 1
            val = compute()
            fresh = True
        else:
            self.hits += 1
            val = _served(op, val)
            fresh = False
        self._note(op, pk_bytes, args, key, val, fresh)
        return val

    def _note(self, op, pk_bytes, args, key, val, fresh):
        if key in self._seen:
            return  # one event per unique derivation
        self._seen.add(key)
        root = self._root_of.get(pk_bytes)
        is_root = False
        if (
            op == "fold"
            and pk_bytes == self.base_bytes
            and RESIZE_TAG_LO <= args[0] < RESIZE_TAG_HI
        ):
            root, is_root = self._n_roots, True
            self._n_roots += 1
        if self.record:
            if pk_bytes == self.base_bytes:
                parent: tuple = ("base",)
            elif pk_bytes in self._produced:
                parent = ("ev", self._produced[pk_bytes])
            else:
                parent = ("lit", pk_bytes)
            self._events.append(_Event(op, parent, args, root, is_root))
        if op == "fold":
            out_b = _key_bytes(val)
            if self.record:
                self._produced.setdefault(out_b, len(self._events) - 1)
            if root is not None:
                self._root_of.setdefault(out_b, root)
        if root is None and fresh:
            # backfill: static material fills the pool on every cold fetch,
            # whether or not this run is the recording one (self-healing
            # after eviction or shape drift)
            self.pool.put(self.bundle_key, key, val)

    def finish(self) -> None:
        """Register the recorded recipe (call after the execution completes)."""
        if self.record and self._events:
            self.pool.register_recipe(
                self.bundle_key, Recipe(tuple(self._events), self._n_roots)
            )

    def event_counts(self) -> Dict[str, int]:
        """Recorded unique derivation events by op (test/manifest cross-check)."""
        out: Dict[str, int] = {}
        for e in self._events:
            out[e.op] = out.get(e.op, 0) + 1
        return out
