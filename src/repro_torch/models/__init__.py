"""The LM side's models: a port of ``repro.models`` (config, layers,
attention, MoE, recurrent mixers and the assembled LM)."""
from .config import ArchConfig  # noqa: F401
from .lm import (  # noqa: F401
    TransformerLM,
    abstract_params,
    count_params_analytic,
    decode_step,
    forward,
    init_caches,
    init_params,
    loss_fn,
)
