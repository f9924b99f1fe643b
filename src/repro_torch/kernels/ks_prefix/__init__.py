from .ops import (
    and_fold,
    and_fold_fused,
    and_fold_plain,
    fold_shifts,
    ks_levels_fused,
    ks_prefix,
    ks_prefix_plain,
    ks_shifts,
)

__all__ = [
    "and_fold",
    "and_fold_fused",
    "and_fold_plain",
    "fold_shifts",
    "ks_levels_fused",
    "ks_prefix",
    "ks_prefix_plain",
    "ks_shifts",
]
