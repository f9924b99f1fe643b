from .filter import And, Or, Predicate
from .table import LazyGather, SecretTable

__all__ = ["And", "Or", "Predicate", "LazyGather", "SecretTable"]
