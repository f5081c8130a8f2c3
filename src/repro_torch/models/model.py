"""Model facade: init / prefill / decode per architecture.

The port of the reference's ``models/model.py`` — the public modelling
API the server, ``chip_smoke.py`` and the tests use.  ``loss_fn`` and
``input_specs`` wait for the training slice (ROADMAP: "Training").
"""

from __future__ import annotations

import torch

from . import transformer
from ..configs.base import ModelConfig


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device: str | torch.device | None = None) -> dict:
    """Random parameters from ``gen`` on ``device`` (default: the card)."""
    if cfg.mtp_depth > 0:
        raise NotImplementedError("multi-token-prediction heads wait for "
                                  "the training slice (ROADMAP: "
                                  "\"Training\")")
    return transformer.init_params(gen, cfg, device)


forward = transformer.forward
prefill = transformer.prefill
decode_step = transformer.decode_step
init_cache = transformer.init_cache
