"""How often the port's float32 primitives equal XLA CPU's, bit for bit.

``repro_torch.core.xla_beta`` reproduces the float32 arithmetic of
``jax.random.beta`` on the CPU: XLA's ``log``, ``log1p``, ``exp``,
``rsqrt`` and ``erf_inv``. This script draws float32 bit patterns
uniformly over all 2^32 (and over the domain the Beta sampler feeds each
primitive), runs them through the port's scalar function and through the
jitted ``jax.numpy`` / ``jax.lax`` op, and prints the share of equal bit
patterns (two NaNs count as equal). Run it on the CPU, from the repo root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/torch_xla_f32_match.py [--samples N] [--seed S]

It needs jax; the port itself never imports it.
"""
from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np

from repro_torch.core import xla_beta

PRIMITIVES = {
    # name: (port, jax, the domain the sampler feeds it as float32 bit ranges)
    "log": (xla_beta.log32, jnp.log, [(0x00000000, 0x7F800001)]),
    "log1p": (xla_beta.log1p32, jnp.log1p, [(0x80000000, 0xBF800001)]),
    "exp": (xla_beta.exp32, jnp.exp, [(0x80000000, 0xFF800001)]),
    "rsqrt": (xla_beta.rsqrt32, jax.lax.rsqrt, [(0x3F2AAAAA, 0x7F800000)]),
    "erf_inv": (xla_beta.erf_inv32, jax.lax.erf_inv, [(0x00000000, 0x3F800000), (0x80000000, 0xBF800000)]),
}


def _equal(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a.view(np.uint32) == b.view(np.uint32)) | (np.isnan(a) & np.isnan(b))


def _rate(port, ref, bits: np.ndarray, positive_normal_only: bool) -> tuple:
    x = bits.astype(np.uint32).view(np.float32)
    if positive_normal_only:  # rsqrt32 refines positive normals only
        x = x[(x >= np.float32(2.0**-126)) & np.isfinite(x)]
    want = np.asarray(jax.jit(ref)(jnp.asarray(x)))
    got = np.array([port(float(v)) for v in x], dtype=np.float32)
    eq = _equal(want, got)
    return int(eq.sum()), int(x.size)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=1 << 18, help="bit patterns per primitive and range")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    rng = np.random.default_rng(args.seed)
    rows = {}
    for name, (port, ref, domain) in PRIMITIVES.items():
        positive = name == "rsqrt"
        every = rng.integers(0, 1 << 32, args.samples, dtype=np.uint64)
        eq_all, n_all = _rate(port, ref, every, positive)
        eq_dom = n_dom = 0
        for lo, hi in domain:
            e, n = _rate(port, ref, rng.integers(lo, hi, args.samples, dtype=np.uint64), positive)
            eq_dom, n_dom = eq_dom + e, n_dom + n
        rows[name] = {
            "all_bit_patterns": {"equal": eq_all, "of": n_all, "rate": eq_all / max(n_all, 1)},
            "sampler_domain": {"equal": eq_dom, "of": n_dom, "rate": eq_dom / max(n_dom, 1)},
        }
        print(f"{name:8s} all patterns {eq_all}/{n_all} ({100 * eq_all / max(n_all, 1):.4f} %)   "
              f"sampler domain {eq_dom}/{n_dom} ({100 * eq_dom / max(n_dom, 1):.4f} %)")
    print(json.dumps({"jax": jax.__version__, "samples": args.samples, "seed": args.seed, "primitives": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
