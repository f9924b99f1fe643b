from .ops import gate, gate_plain

__all__ = ["gate", "gate_plain"]
