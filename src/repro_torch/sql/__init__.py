"""SQL front end of the port: dialect tokenizer and parser, optimizing
compiler, renderer and catalog, as ``repro.sql``.

``compile_query(q)`` turns a SQL string into a Resizer-placed physical
:class:`~repro_torch.plan.nodes.PlanNode` tree for the port's
:class:`~repro_torch.engine.Engine`: predicate pushdown, cost-based join
order, the join algorithm's choice (product or sort-merge) and Resizer
placement. The modules hold no tensors; ``python -m repro_torch.sql --help``
runs the front end and its checks.
"""
from ..errors import PlanSchemaError as SchemaError
from ..plan.registry import infer_schema
from .catalog import HEALTHLNK_CATALOG, Catalog
from .compile import (
    bind_params,
    compile_logical,
    compile_query,
    default_cost_model,
    plan_fingerprint,
    plan_params,
    plan_template,
    template_fingerprint,
)
from .lexer import SqlError, tokenize
from .parser import parse
from .render import render_sql

__all__ = [
    "Catalog",
    "HEALTHLNK_CATALOG",
    "SchemaError",
    "SqlError",
    "bind_params",
    "compile_query",
    "compile_logical",
    "default_cost_model",
    "infer_schema",
    "parse",
    "plan_fingerprint",
    "plan_params",
    "plan_template",
    "render_sql",
    "template_fingerprint",
    "tokenize",
]
