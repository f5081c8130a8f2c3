"""Model zoo: config-driven dense / MoE / hybrid / SSM decoder LMs."""

from . import attention, layers, model, moe, ssm, transformer
from .model import (decode_step, forward, init_cache, init_params,
                    input_specs, loss_fn, prefill)

__all__ = ["attention", "layers", "model", "moe", "ssm", "transformer",
           "decode_step", "forward", "init_cache", "init_params",
           "input_specs", "loss_fn", "prefill"]
