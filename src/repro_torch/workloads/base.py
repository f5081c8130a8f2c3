"""The record every Table-I workload of the port fills in.

The fields the Fig. 5 harness reads are the reference benchmark's
``PaperKernel`` fields (``benchmarks/paper_kernels.py``): the loop body
and its example arguments, the window and full-scale traces, the
iteration counts, the ARM baseline's instructions per iteration and the
§III-A annotations.  The loop body is written in torch and closes over
tensors on ``device``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..core.simulator import MemAccess


@dataclasses.dataclass
class PaperWorkload:
    name: str
    loop_body: Callable          # (carry, *xs) -> carry
    carry_example: Any           # a tensor or a tuple of tensors
    body_args: tuple             # example xs for tracing
    traces: dict[str, MemAccess]       # the n_iters_sim window
    full_traces: dict[str, MemAccess]  # window generators, all iterations
    n_iters_full: int            # Table-I-scale iteration count
    n_iters_sim: int             # simulated window
    instrs_per_iter: float       # ARM baseline estimate
    device: torch.device         # where the body's closed-over tensors live
    data: dict[str, np.ndarray]  # the seeded numpy inputs
    mem_in_scc_regions: tuple = ()
    nonaliasing_carries: tuple = ()
    expected: np.ndarray | None = None


def i32(v: int, device: torch.device) -> torch.Tensor:
    """A 0-d int32 tensor: a loop index or scalar carry."""
    return torch.tensor(v, dtype=torch.int32, device=device)
