"""Model facade: init / prefill / decode per architecture.

The port of the reference's ``models/model.py`` — the public modelling
API the server, ``chip_smoke.py`` and the tests use.  :func:`init_params`
builds DeepSeek-V3's multi-token-prediction head as the reference does,
so the model serves; the MTP loss, ``loss_fn`` and ``input_specs`` wait
for the training slice (ROADMAP: "Training").
"""

from __future__ import annotations

import torch

from . import layers, transformer
from .._device import get_device
from ..configs.base import ModelConfig

_TRAINING_LATER = ("waits for the training slice (ROADMAP: \"Training\")")


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device: str | torch.device | None = None) -> dict:
    """Random parameters from ``gen`` on ``device`` (default: the card),
    with the MTP head (projection, one layer of the last unit's kind,
    norm) when ``cfg.mtp_depth > 0``."""
    dev = get_device(device)
    params = transformer.init_params(gen, cfg, dev)
    if cfg.mtp_depth > 0:
        d = cfg.d_model
        params["mtp"] = {
            "proj": layers._dense_init(gen, 2 * d, d, cfg.torch_dtype, dev),
            "layer": transformer._layer_init(
                gen, cfg.segments[-1].unit[-1], cfg, dev),
            "norm": layers.rmsnorm_init(d, cfg.torch_dtype, dev),
        }
    return params


def loss_fn(params: dict, batch: dict, cfg: ModelConfig):
    """The next-token loss (+ MoE load balance + the MTP loss)."""
    what = "the LM loss and the MTP loss" if cfg.mtp_depth > 0 else \
        "the LM loss"
    raise NotImplementedError(f"{what} {_TRAINING_LATER}")


def input_specs(cfg: ModelConfig, shape):
    """The step inputs of a (config × input-shape) cell."""
    raise NotImplementedError(f"input_specs {_TRAINING_LATER}")


forward = transformer.forward
prefill = transformer.prefill
decode_step = transformer.decode_step
init_cache = transformer.init_cache
