"""Model zoo: the config-driven decoder LM, for the layer kinds the port
carries so far (dense GQA attention, dense MLP)."""

from . import attention, layers, model, transformer
from .model import decode_step, forward, init_cache, init_params, prefill

__all__ = ["attention", "layers", "model", "transformer", "decode_step",
           "forward", "init_cache", "init_params", "prefill"]
