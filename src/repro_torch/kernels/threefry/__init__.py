from .ops import draw, draw_plain

__all__ = ["draw", "draw_plain"]
