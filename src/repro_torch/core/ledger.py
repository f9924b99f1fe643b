"""Static communication-cost ledger for the simulated 3-party protocols.

For every protocol primitive the ledger records the synchronous rounds and
the bytes each party sends. Costs depend only on shapes, so they are the same
on every device: the per-node tallies are the parity signal against
``repro.core.ledger``. Use::

    with CommLedger() as led:
        protocol(...)
    print(led.tally())

``fused(op, rounds)`` coalesces the entries logged inside it into one entry
with ``rounds`` rounds (independent gates that share rounds), and runs of
identical entries coalesce into one entry with a ``count``.

An exchange driver (:func:`exchange_scope`, any object with an
``exchange(op, rounds, nbytes, payload)`` method) is called once per
top-level entry: the multi-party runtime's
:class:`~repro_torch.runtime.exchange.RingExchange` turns each into one
framed wire exchange. ``payload`` is the canonical ``(3, ...)`` share tensor
a protocol hands :func:`log_comm` at its sync point (a reveal's opening, a
mul / AND gate's reshared output, ``reveal_k``); entries logged inside
``fused()`` reach the driver as one payload-free entry. The ledger only
passes the tensor on: without a driver installed (single-process mode)
nothing reads it.

:func:`measure_comm` is the counterpart of the reference's
``jax.eval_shape`` under a ledger: it runs a protocol on ``meta`` tensors,
so only the Python body (and its logging) runs, with no compute and no
allocation.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections import defaultdict
from typing import Dict, List, Optional

import torch
import torch.utils._pytree as pytree

__all__ = [
    "CommEntry",
    "CommLedger",
    "log_comm",
    "active_ledger",
    "fused_scope",
    "measure_comm",
    "batched_tally",
    "exchange_scope",
    "active_exchange",
]

_STATE = threading.local()


def _stack() -> List["CommLedger"]:
    if not hasattr(_STATE, "stack"):
        _STATE.stack = []
    return _STATE.stack


def active_exchange():
    """The exchange driver installed on this thread, or None."""
    return getattr(_STATE, "exchange", None)


@contextlib.contextmanager
def exchange_scope(driver):
    """Install ``driver`` as this thread's exchange boundary: every top-level
    ledger entry logged inside the block becomes one ``driver.exchange``
    call."""
    prev = getattr(_STATE, "exchange", None)
    _STATE.exchange = driver
    try:
        yield driver
    finally:
        _STATE.exchange = prev


def _exchange(entry: "CommEntry", payload=None) -> None:
    drv = active_exchange()
    if drv is not None:
        drv.exchange(entry.op, entry.rounds, entry.bytes_per_party, payload)


@dataclasses.dataclass
class CommEntry:
    op: str
    rounds: int
    bytes_per_party: int
    count: int = 1


class CommLedger:
    """Accumulates (rounds, bytes/party) per protocol op."""

    def __init__(self) -> None:
        self.entries: List[CommEntry] = []
        self._fuse_depth = 0
        self._fuse_buffer: List[CommEntry] = []

    def __enter__(self) -> "CommLedger":
        _stack().append(self)
        return self

    def __exit__(self, *exc) -> None:
        top = _stack().pop()
        if top is not self:
            raise RuntimeError("CommLedger stack corrupted")

    @staticmethod
    def _append(target: List[CommEntry], entry: CommEntry) -> None:
        """Append, coalescing runs of identical (op, rounds, bytes) entries
        into one entry whose ``count`` is the true repetition count."""
        if target:
            last = target[-1]
            if (
                last.op == entry.op
                and last.rounds == entry.rounds
                and last.bytes_per_party == entry.bytes_per_party
            ):
                last.count += entry.count
                return
        target.append(entry)

    def log(self, op: str, rounds: int, bytes_per_party: int, payload=None) -> None:
        entry = CommEntry(op, rounds, bytes_per_party)
        if self._fuse_depth > 0:
            # the constituents of a fused round block ride one exchange,
            # fired payload-free when the merged entry lands
            self._append(self._fuse_buffer, entry)
        else:
            _exchange(entry, payload)
            self._append(self.entries, entry)

    @contextlib.contextmanager
    def fused(self, op: str, rounds: int):
        """Coalesce nested logs into one entry with the given round count."""
        self._fuse_depth += 1
        mark = len(self._fuse_buffer)
        try:
            yield
        finally:
            self._fuse_depth -= 1
            sub = self._fuse_buffer[mark:]
            del self._fuse_buffer[mark:]
            total_bytes = sum(e.bytes_per_party * e.count for e in sub)
            entry = CommEntry(op, rounds, total_bytes)
            if self._fuse_depth > 0:
                self._append(self._fuse_buffer, entry)
            else:
                _exchange(entry)
                self._append(self.entries, entry)

    def tally(self) -> Dict[str, int]:
        total_bytes = sum(e.bytes_per_party * e.count for e in self.entries)
        total_rounds = sum(e.rounds * e.count for e in self.entries)
        return {"bytes_per_party": total_bytes, "rounds": total_rounds}

    def by_op(self) -> Dict[str, Dict[str, int]]:
        """Per-op totals: rounds, bytes per party and true call counts."""
        agg: Dict[str, Dict[str, int]] = defaultdict(
            lambda: {"rounds": 0, "bytes_per_party": 0, "calls": 0}
        )
        for e in self.entries:
            agg[e.op]["rounds"] += e.rounds * e.count
            agg[e.op]["bytes_per_party"] += e.bytes_per_party * e.count
            agg[e.op]["calls"] += e.count
        return dict(agg)


def active_ledger() -> Optional[CommLedger]:
    stack = _stack()
    return stack[-1] if stack else None


def log_comm(op: str, rounds: int, bytes_per_party: int, payload=None) -> None:
    """Log one sync point on the active ledger (a no-op without one).
    ``payload`` (optional) is the canonical ``(3, ...)`` share tensor
    exchanged at this boundary: the tally ignores it, an exchange driver
    ships this party's slice of it and checks the peer's."""
    led = active_ledger()
    if led is not None:
        led.log(op, rounds, bytes_per_party, payload)


def fused_scope(op: str, rounds: int):
    """``active_ledger().fused(...)``, or a no-op when no ledger is active."""
    led = active_ledger()
    if led is None:
        return contextlib.nullcontext()
    return led.fused(op, rounds)


def batched_tally(per_slot: Dict[str, float], slots: int) -> Dict[str, float]:
    """Physical cost of a ``slots``-wide stacked pass from the per-slot tally
    the ledger recorded once: every slot's bytes move (bytes scale by
    ``slots``), the synchronous rounds are shared by the batch."""
    return {
        "bytes_per_party": per_slot.get("bytes_per_party", 0) * slots,
        "rounds": per_slot.get("rounds", 0),
    }


def _to_meta(x):
    if isinstance(x, torch.Tensor):
        return torch.empty(x.shape, dtype=x.dtype, device="meta")
    return x


# PyTorch's messages for a read of a meta tensor's values: ``.item()`` (and
# ``int()``, ``bool()``, ``float()``), a copy out (``.cpu()``, ``.tolist()``,
# ``.to("cpu")``), ``.numpy()``, and ``nonzero`` (a boolean mask's index),
# whose size depends on the values
_HOST_READS = (
    "Tensor.item() cannot be called on meta tensors",
    "Cannot copy out of meta tensor",
    "can't convert meta device type tensor to numpy",
    "correct data-independent implementation does not exist",
)


def measure_comm(fn, *args, **kwargs) -> Dict[str, int]:
    """The communication tally of ``fn(*args, **kwargs)`` without compute.

    Every tensor in ``args`` (pytree leaves: share triples, tables and
    public tensors alike) becomes a ``meta`` tensor of its shape and dtype;
    ``fn`` runs on them under a :class:`CommLedger`, whose tally is
    returned. Shapes alone set the cost. The PRF keys (a
    :class:`~repro_torch.core.prf.PRFSetup` is not a pytree node) stay
    where they are: key derivation is host arithmetic. A protocol that
    reads a value on the host (a Resizer's reveal, ``.item()``) cannot run
    on ``meta`` and raises, as ``jax.eval_shape`` raises on a concrete
    read; any other error passes through unchanged.
    """
    meta_args = pytree.tree_map(_to_meta, args)
    with CommLedger() as led:
        try:
            fn(*meta_args, **kwargs)
        except (RuntimeError, NotImplementedError, TypeError) as e:
            if not any(m in str(e) for m in _HOST_READS):
                raise
            raise RuntimeError(
                f"measure_comm: {getattr(fn, '__name__', fn)} reads a value on the host, which a meta tensor "
                f"does not hold ({type(e).__name__}: {e})"
            ) from e
    return led.tally()
