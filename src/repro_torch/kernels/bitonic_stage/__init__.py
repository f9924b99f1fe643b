from .ops import stage_swap, stage_swap_plain

__all__ = ["stage_swap", "stage_swap_plain"]
