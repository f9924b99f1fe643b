"""Background provisioner: size pool targets and refill during idle windows
(a port of ``repro.offline.provisioner``).

The provisioner owns the *when* of offline work; the pool owns the *what*.
Refill passes run:

* inline, when the service signals an idle window (``hint()`` after the
  scheduler drains its last bucket) — bounded work on the caller thread,
  deterministic for tests;
* on a daemon thread (``start()``), woken by hints and a periodic
  interval, for deployments where idle windows are scarce.

Sizing: the per-template demand callback (the service feeds it from the
``reflex_offline_demand_total`` counter in the metrics registry, i.e. the
observed admission rate per template fingerprint) sets how many upcoming
engine counters each template's Resizer material is provisioned for:
``clamp(window, demand_since_last_refill, max_window)``. Static material
is re-derived whenever its bundle was evicted. All refill work is
traced (``offline.refill`` spans) and exported through the
``reflex_offline_refill*`` metrics.

On the card the background thread's draws go to the current stream of
that thread, which is the device's default stream, the one the engine
launches on: a pooled tensor is therefore complete before any kernel the
engine queues after taking it, with no event or ``record_stream`` needed.
Nothing in a refill copies a device tensor to the host (the pool counts
bytes from shapes, and key derivation is host arithmetic on CPU keys).
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

from ..obs import trace as obs_trace
from .pool import RandomnessPool

__all__ = ["Provisioner"]


class Provisioner:
    """Sizes and refills a :class:`RandomnessPool` off the critical path."""

    def __init__(
        self,
        pool: RandomnessPool,
        base_prf,
        ctr_fn: Callable[[], int],
        demand_fn: Optional[Callable[[], Dict[tuple, float]]] = None,
        window: int = 8,
        max_window: int = 64,
        interval_s: float = 1.0,
        metrics=None,
    ):
        self.pool = pool
        self.base_pair_keys = base_prf.pair_keys
        self.ctr_fn = ctr_fn
        self.demand_fn = demand_fn
        self.window = int(window)
        self.max_window = int(max_window)
        self.interval_s = float(interval_s)
        self.refills = 0
        self.last_refill_s = 0.0
        self.last_error: Optional[BaseException] = None
        self._demand_seen: Dict[tuple, float] = {}
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._refill_lock = threading.Lock()
        self._m_refills = self._m_refill_s = None
        if metrics is not None:
            self._m_refills = metrics.counter(
                "reflex_offline_refills_total",
                "Offline pool refill passes by trigger",
                ("trigger",),
            )
            self._m_refill_s = metrics.histogram(
                "reflex_offline_refill_seconds",
                "Wall time of one offline refill pass",
            )

    # -- sizing --------------------------------------------------------------

    def _target_window(self, bundle_key: tuple) -> int:
        """Upcoming-counter coverage for one template, from observed demand."""
        if self.demand_fn is None:
            return self.window
        demand = self.demand_fn() or {}
        total = float(demand.get(bundle_key, 0.0))
        delta = total - self._demand_seen.get(bundle_key, 0.0)
        self._demand_seen[bundle_key] = total
        return max(self.window, min(self.max_window, int(delta)))

    # -- refill --------------------------------------------------------------

    def refill(self, trigger: str = "manual") -> dict:
        """One synchronous refill pass: GC consumed counters, restore evicted
        static bundles, provision upcoming counter windows. Thread-safe and
        reentrant-serialized; returns a summary dict."""
        with self._refill_lock:
            t0 = time.perf_counter()
            watermark = int(self.ctr_fn())
            dropped = self.pool.gc(watermark)
            static_made = counter_made = 0
            with obs_trace.span("offline.refill", reason=trigger):
                for bundle_key in self.pool.recipes():
                    static_made += self.pool.ensure_static(
                        bundle_key, self.base_pair_keys
                    )
                    target = self._target_window(bundle_key)
                    counter_made += self.pool.provision(
                        bundle_key,
                        self.base_pair_keys,
                        range(watermark + 1, watermark + 1 + target),
                    )
            dt = time.perf_counter() - t0
            self.refills += 1
            self.last_refill_s = dt
            if self._m_refills is not None:
                self._m_refills.inc(trigger=trigger)
                self._m_refill_s.observe(dt)
            return {
                "trigger": trigger,
                "seconds": dt,
                "gc_dropped": dropped,
                "static_entries": static_made,
                "counter_entries": counter_made,
                "watermark": watermark,
            }

    def hint(self) -> Optional[dict]:
        """Idle-window signal (e.g. scheduler drained its last bucket). Wakes
        the background thread if running, else refills inline."""
        if self._thread is not None and self._thread.is_alive():
            self._wake.set()
            return None
        return self.refill(trigger="idle")

    # -- background thread ---------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="reflex-offline-provisioner", daemon=True
        )
        self._thread.start()

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            self._thread = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(timeout=self.interval_s)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.refill(trigger="background")
            except Exception as e:  # keep the daemon alive; surface via stats
                self.last_error = e

    def stats(self) -> dict:
        return {
            "refills": self.refills,
            "last_refill_seconds": self.last_refill_s,
            "running": self._thread is not None and self._thread.is_alive(),
            "error": repr(self.last_error) if self.last_error else None,
        }
