"""Optimiser substrate: AdamW with clipping and decay masks, the LR
schedule, and int8 gradient compression for a data-parallel reduce over
``torch.distributed`` ranks (``compress``)."""

from .adamw import AdamWConfig, apply_updates, global_norm, init_opt_state
from .schedule import warmup_cosine
from . import compress

__all__ = ["AdamWConfig", "apply_updates", "global_norm", "init_opt_state",
           "warmup_cosine", "compress"]
