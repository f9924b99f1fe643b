from .ops import a2b_fused, a2b_kernel, a2b_plain, bit2a_fused, bit2a_kernel, bit2a_plain

__all__ = ["a2b_fused", "a2b_kernel", "a2b_plain", "bit2a_fused", "bit2a_kernel", "bit2a_plain"]
