"""LR schedules: linear warmup + cosine decay (the LM default)."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """The LR *scale* in [min_ratio, 1] for ``step`` (an int or a tensor,
    taken in fp32 on its device), as a 0-d fp32 tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(1.0, warmup_steps)
    t = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
    t = torch.clamp(t, 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, cos)
