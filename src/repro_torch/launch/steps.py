"""Step functions (train / prefill / decode) and the abstract train state.

The port of the reference's ``launch/steps.py``.  :func:`loss_and_grads`
is ``jax.value_and_grad(loss_fn, has_aux=True)`` by
``torch.autograd.grad`` over the params' flattened leaves, so the params
stay plain tensors and the grads come back as a tree of their structure.
The reference's ``train_state_shardings``, ``batch_shardings`` and
``lower_cell`` place state on a device mesh and lower a dry-run cell;
they wait for the multi-device slice (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .. import tree
from ..configs.base import ModelConfig
from ..models import model as M
from ..optim import adamw
from ..optim.schedule import warmup_cosine


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: dict
    step: torch.Tensor      # int32, 0-d, on the params' device


def loss_and_grads(params: Any, batch: dict, cfg: ModelConfig
                   ) -> tuple[tuple[torch.Tensor, dict], Any]:
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ((loss, metrics),
    grads), loss and metrics detached, grads a tree of the params'
    structure — zeros for a leaf the loss does not read, as in JAX."""
    leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
    with torch.enable_grad():
        loss, metrics = M.loss_fn(tree.unflatten(params, leaves), batch,
                                  cfg)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, got)]
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree.unflatten(params, grads))


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    *, total_steps: int = 10_000, warmup_steps: int = 200):
    """Pure train step: (state, batch) -> (state, metrics).  The state
    that goes in is not modified; metrics are detached 0-d tensors."""

    def train_step(state: TrainState, batch: dict
                   ) -> tuple[TrainState, dict]:
        (_, metrics), grads = loss_and_grads(state.params, batch, cfg)
        lr_scale = warmup_cosine(state.step, warmup_steps=warmup_steps,
                                 total_steps=total_steps)
        params, opt, info = adamw.apply_updates(
            state.params, grads, state.opt, opt_cfg, lr_scale)
        metrics.update(info)
        return TrainState(params, opt, state.step + 1), metrics

    return train_step


def abstract_train_state(cfg: ModelConfig,
                         opt_cfg: adamw.AdamWConfig) -> TrainState:
    """The train state's shapes and dtypes as ``meta`` tensors (no
    allocation)."""
    params = M.init_params(None, cfg, "meta")
    opt = adamw.init_opt_state(params, opt_cfg)
    return TrainState(params, opt,
                      torch.empty((), dtype=torch.int32, device="meta"))


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(params, inputs):
        return M.prefill(params, inputs, cfg, max_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, token, cache, length):
        return M.decode_step(params, token, cache, length, cfg)
    return decode_step


def make_forward(cfg: ModelConfig):
    def fwd(params, inputs):
        logits, _ = M.forward(params, inputs, cfg)
        return logits
    return fwd
