"""Table-I knapsack DP (W 3200, N 200, ≈5 MB) for the port.

The numpy parts are the reference benchmark's ``make_knapsack``
(``benchmarks/paper_kernels.py``) unchanged: the same seeded weights and
values, the same window traces over the full-scale 2-D DP table and the
same generated full-scale traces.  The loop body is one (i, j) inner
iteration, j descending, written in torch; the store is
:func:`~repro_torch.core.cdfg.at_set`, the port's ``dp.at[j].set``.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import get_device
from ..core.cdfg import at_set
from ..core.simulator import MemAccess
from .base import PaperWorkload, i32


def make_knapsack(scale: float = 0.25, seed: int = 1,
                  device: str | torch.device | None = None) -> PaperWorkload:
    """``scale=1.0`` is Table-I size; ``scale`` only shrinks the DP data
    (W, N), the traces are always full-scale."""
    dev = get_device(device)
    W = max(64, int(3200 * scale))
    N = max(8, int(200 * scale))
    rng = np.random.default_rng(seed)
    weights = rng.integers(1, 64, size=N).astype(np.int32)
    values = rng.integers(1, 100, size=N).astype(np.int32)
    w_t = torch.from_numpy(weights).to(dev)
    v_t = torch.from_numpy(values).to(dev)

    def loop_body(dp, ij):
        # one (i, j) inner iteration, j descending
        i, j = ij
        cur = dp[j]                       # load dp[j]
        take = dp[j - w_t[i]] + v_t[i]    # load dp[j-w]; the DP recurrence
        new = torch.maximum(cur, take)
        return at_set(dp, j, torch.where(j >= w_t[i], new, cur))  # store

    # FULL-scale 2-D DP table traces (W=3200, N=200 => ~5 MB, Table I):
    # row i reads row i-1 (two streams) and writes row i.
    n_sim = 40_000
    Wf = 3200
    t = np.arange(n_sim)
    ti = t // Wf
    tj = Wf - (t % Wf)
    wt = np.asarray(weights)[(ti % len(weights))].astype(np.int64)
    traces = {
        "dp_load": MemAccess("dp_load", ((ti - 1).clip(0) * Wf + tj) * 4),
        "dp_load2": MemAccess("dp_load2",
                              ((ti - 1).clip(0) * Wf
                               + np.maximum(0, tj - wt)) * 4),
        "dp_store": MemAccess("dp_store", (ti * Wf + tj) * 4,
                              is_store=True),
    }

    # full Table-I scale: all N=200 item rows over the W=3200 table
    Nf = 200
    n_full = Wf * Nf
    frng = np.random.default_rng(seed)
    wf = frng.integers(1, 64, size=Nf).astype(np.int64)

    def _kij(lo, hi):
        t = np.arange(lo, hi)
        return t // Wf, Wf - (t % Wf)

    def _g_load(lo, hi):
        fi, fj = _kij(lo, hi)
        return ((fi - 1).clip(0) * Wf + fj) * 4

    def _g_load2(lo, hi):
        fi, fj = _kij(lo, hi)
        return ((fi - 1).clip(0) * Wf
                + np.maximum(0, fj - wf[fi % Nf])) * 4

    def _g_store(lo, hi):
        fi, fj = _kij(lo, hi)
        return (fi * Wf + fj) * 4

    full_traces = {
        "dp_load": MemAccess("dp_load", gen=_g_load, length=n_full),
        "dp_load2": MemAccess("dp_load2", gen=_g_load2, length=n_full),
        "dp_store": MemAccess("dp_store", gen=_g_store, length=n_full,
                              is_store=True),
    }

    # reference: classic vectorized DP
    dp = np.zeros(W + 1, np.int64)
    for i in range(N):
        w, v = int(weights[i]), int(values[i])
        dp[w:] = np.maximum(dp[w:], dp[:-w] + v if w else dp[w:])
    return PaperWorkload(
        name="knapsack",
        loop_body=loop_body,
        carry_example=torch.zeros(W + 1, dtype=torch.int32, device=dev),
        body_args=((i32(0, dev), i32(1, dev)),),
        traces=traces,
        full_traces=full_traces,
        n_iters_full=n_full,
        n_iters_sim=n_sim,
        instrs_per_iter=11.0,
        device=dev,
        data={"weights": weights, "values": values},
        nonaliasing_carries=(0,),  # §III-A annotation: row i-1 -> row i
        expected=dp.astype(np.int64),
    )
