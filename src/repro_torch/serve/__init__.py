"""Serving: prefill, the prefill and serve step factories, and bucketed
batching (a port of ``repro.serve``)."""
from .batching import BucketedBatcher, next_bucket  # noqa: F401
from .serve_step import make_prefill_step, make_serve_step, prefill  # noqa: F401
