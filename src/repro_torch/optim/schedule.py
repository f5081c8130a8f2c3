"""LR schedules: linear warmup + cosine decay (the LM default)."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """The LR *scale* in [min_ratio, 1] for ``step`` (an int or a tensor,
    taken in fp32 on its device), as a 0-d fp32 tensor.

    Written in tensor ops throughout, the reference's ``jnp.maximum`` of
    two numbers included, so that a trace of the train step holds the
    reference's equations."""
    if isinstance(step, (int, float)):
        step = torch.tensor(step)
    step = step.to(torch.float32)
    warm = step / torch.maximum(step.new_tensor(1.0),
                                step.new_tensor(float(warmup_steps)))
    t = (step - warmup_steps) / torch.maximum(
        step.new_tensor(1.0), step.new_tensor(float(total_steps
                                                    - warmup_steps)))
    t = torch.clamp(t, 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, cos)
