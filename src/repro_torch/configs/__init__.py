"""Architecture registry: one module per architecture (a port of
``repro.configs``; the ten modules hold the reference's configs verbatim)."""
from __future__ import annotations

from importlib import import_module
from typing import Dict, List

from ..models.config import ArchConfig

ARCH_IDS: List[str] = [
    "mixtral_8x7b",
    "arctic_480b",
    "xlstm_1_3b",
    "paligemma_3b",
    "recurrentgemma_9b",
    "stablelm_1_6b",
    "minicpm3_4b",
    "starcoder2_15b",
    "phi3_medium_14b",
    "musicgen_medium",
]

_ALIAS = {i.replace("_", "-"): i for i in ARCH_IDS}


def get_config(name: str) -> ArchConfig:
    """Accepts registry ids (stablelm_1_6b) and display names (stablelm-1.6b)."""
    mod_name = _ALIAS.get(name, name).replace("-", "_").replace(".", "_")
    return import_module(f"{__name__}.{mod_name}").CONFIG


def all_configs() -> Dict[str, ArchConfig]:
    return {i: get_config(i) for i in ARCH_IDS}


from .shapes import SHAPE_NAMES, input_specs, shape_applicable  # noqa: E402,F401
