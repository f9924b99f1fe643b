from .aggregate import avg_column, count_distinct, count_valid, max_column, min_column, sum_column
from .distinct import oblivious_distinct
from .filter import And, Or, Predicate, oblivious_filter
from .groupby import oblivious_groupby_avg, oblivious_groupby_count, oblivious_groupby_sum
from .join import oblivious_join
from .join_sortmerge import oblivious_join_sortmerge
from .orderby import oblivious_orderby
from .table import LazyGather, SecretTable

__all__ = [
    "And",
    "Or",
    "Predicate",
    "LazyGather",
    "SecretTable",
    "oblivious_filter",
    "oblivious_join",
    "oblivious_join_sortmerge",
    "oblivious_groupby_count",
    "oblivious_groupby_sum",
    "oblivious_groupby_avg",
    "oblivious_orderby",
    "oblivious_distinct",
    "count_valid",
    "count_distinct",
    "sum_column",
    "avg_column",
    "min_column",
    "max_column",
]
