"""Optimiser substrate: AdamW with clipping and decay masks, and the LR
schedule.  The reference's gradient compression (``optim/compress.py``)
is cross-pod all-reduce work and waits for the multi-device slice."""

from .adamw import AdamWConfig, apply_updates, global_norm, init_opt_state
from .schedule import warmup_cosine

__all__ = ["AdamWConfig", "apply_updates", "global_norm", "init_opt_state",
           "warmup_cosine"]
