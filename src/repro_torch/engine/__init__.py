from .executor import Engine, ExecutionReport, NodeStats

__all__ = ["Engine", "ExecutionReport", "NodeStats"]
