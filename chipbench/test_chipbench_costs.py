"""The frozen kernel costs reproduce the bounds of PERF.md's kernel table,
the one measurement in the repository their formulas are known to match."""
import pytest
import torch

from chipbench.harness import spec


def _t(*shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


# (kernel, the launch function's arguments at the table's shape, bound in ms)
ROWS = [
    ("rss_gate", (_t(3, 33554432), _t(3, 33554432), _t(3, 33554432), True), 0.4808),
    ("rss_gate", (_t(3, 1 << 24, dtype=torch.int64), _t(3, 1 << 24, dtype=torch.int64),
                  _t(3, 1 << 24, dtype=torch.int64), False), 0.4808),
    ("shuffle_gather", ([_t(3, 1 << 24, 7), _t(3, 1 << 24, 7)], _t(1 << 24, dtype=torch.int64)), 1.7028),
    ("ks_prefix", (_t(3, 31612928), _t(3, 31612928), _t(3, 8, 31612928), (1, 2, 4, 8)), 1.2456),
    ("ks_prefix", (_t(3, 1 << 24, dtype=torch.int64), _t(3, 1 << 24, dtype=torch.int64),
                   _t(3, 12, 1 << 24, dtype=torch.int64), (1, 2, 4, 8, 16, 32)), 1.8029),
    ("and_fold", (_t(3, 1 << 24), _t(3, 5, 1 << 24), (16, 8, 4, 2, 1)), 0.4207),
    ("and_fold", (_t(3, 1 << 24, dtype=torch.int64), _t(3, 6, 1 << 24, dtype=torch.int64),
                  (32, 16, 8, 4, 2, 1)), 0.9616),
    ("a2b_fused", (_t(3, 31612928), _t(3, 22, 31612928), (1, 2, 4, 8, 16)), 2.7178),
    ("a2b_fused", (_t(3, 1 << 24, dtype=torch.int64), _t(3, 26, 1 << 24, dtype=torch.int64),
                   (1, 2, 4, 8, 16, 32)), 3.3655),
    ("bit2a_fused", (_t(3, 1 << 24), _t(3, 2, 1 << 24)), 0.2404),
    ("bit2a_fused", (_t(3, 1 << 24, dtype=torch.int64), _t(3, 2, 1 << 24, dtype=torch.int64)), 0.4808),
    ("bitonic_swap", (_t(3, 1 << 24), _t(3, 2, 1 << 24), _t(3, 2, 1 << 24), _t(3, 2, 1 << 24)), 0.5409),
    ("threefry_bits", (_t(3, 2), 63225856, "cuda"), 0.4133),
]


@pytest.mark.parametrize("kernel,args,bound_ms", ROWS, ids=[f"{r[0]}-{i}" for i, r in enumerate(ROWS)])
def test_cost_reproduces_the_kernel_table(kernel, args, bound_ms):
    peaks = spec.peaks()
    nbytes, nops = spec.kernel_costs()[kernel].cost(*args)
    least_ms = 1e3 * max(nbytes / peaks["hbm_bytes_per_s"], nops / peaks["int32_ops_per_s"])
    assert round(least_ms, 4) == bound_ms


def test_every_kernel_has_a_cost_file():
    from repro_torch.kernels import __doc__ as doc

    costs = spec.kernel_costs()
    assert set(costs) == {"rss_gate", "shuffle_gather", "ks_prefix", "and_fold", "a2b_fused", "bit2a_fused",
                          "bitonic_swap", "threefry_bits"}
    for name, module in costs.items():
        owner, attr = module.LAUNCHER
        assert callable(getattr(__import__(owner, fromlist=[attr]), attr)), name
        assert module.DEVICE_KERNELS and module.COUNTERS
    assert "threefry_bits" in doc
