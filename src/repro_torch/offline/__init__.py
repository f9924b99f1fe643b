"""Offline/online phase split: correlated-randomness provisioning (DESIGN.md §15),
a port of ``repro.offline``.

The online phase of every query pays for its correlated randomness — PRF
folds, zero-sharings, shuffle-hop permutations, conversion material — on
the critical path. This package moves that work into a background offline
phase, keyed by the plan cache's template fingerprints:

* :class:`~repro_torch.offline.manifest.RandomnessPlanner` walks a compiled plan
  template and derives its randomness **manifest** (per node: PRF folds,
  shuffle control sets, a2b/bit2a conversion material, Resizer
  noise-counter reservations, as a function of pow2-bucketed shapes).
* :class:`~repro_torch.offline.pool.RandomnessPool` stores precomputed material
  keyed by (template fingerprint, shape bucket) with bounded memory and
  explicit counter-range ownership; its :class:`~repro_torch.offline.pool.PoolSource`
  plugs into the ambient hook in :mod:`repro_torch.core.material`.
* :class:`~repro_torch.offline.provisioner.Provisioner` sizes pool targets from
  observed admission rates and refills during idle windows (scheduler
  drain) or from a background thread.

Pooled and on-demand draws are bit-identical by construction: the pool is
a content-addressed cache in front of the same pure derivation functions
the online path calls on a miss. Fetch keys are the reference's (op names,
args, pair-key bytes), and pooled bytes are counted as the reference counts
them, so a pool's entries, depth and eviction order equal ``repro``'s for
the same executions.
"""
from .manifest import NodeManifest, RandomnessManifest, RandomnessPlanner
from .pool import PoolSource, RandomnessPool, Recipe
from .provisioner import Provisioner

__all__ = [
    "NodeManifest",
    "RandomnessManifest",
    "RandomnessPlanner",
    "PoolSource",
    "RandomnessPool",
    "Recipe",
    "Provisioner",
]
