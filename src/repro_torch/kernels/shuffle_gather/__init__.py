from .ops import shuffle_gather, shuffle_gather_plain

__all__ = ["shuffle_gather", "shuffle_gather_plain"]
