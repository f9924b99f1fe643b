"""The LM side's training: a port of ``repro.train`` (AdamW, the train step
with gradient accumulation, atomic and asynchronous checkpoints)."""
from .optimizer import AdamWConfig, adamw_init, adamw_update, lr_schedule  # noqa: F401
from .train_step import make_train_step, place_train_state  # noqa: F401
from .checkpoint import Checkpointer  # noqa: F401
