from .filter import And, Or, Predicate
from .join_sortmerge import oblivious_join_sortmerge
from .table import LazyGather, SecretTable

__all__ = ["And", "Or", "Predicate", "LazyGather", "SecretTable", "oblivious_join_sortmerge"]
