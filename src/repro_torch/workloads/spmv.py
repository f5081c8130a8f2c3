"""Table-I SpMV (CSR, dim 4096, density 0.25) for the port.

The numpy parts are the reference benchmark's ``make_spmv``
(``benchmarks/paper_kernels.py``) unchanged — the same seeded CSR matrix,
the same window traces and the same hash-generated full-scale traces —
so the port and the reference simulate identical address streams.  The
loop body is written in torch and closes over the CSR arrays on the
chosen device.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import get_device
from ..core.simulator import MemAccess
from .base import PaperWorkload
from .hashing import hash_ints

#: Table-I scale: dim 4096, density 0.25 → 4,194,304 nonzeros (≈16 MB)
FULL_DIM = 4096
DENSITY = 0.25


def make_spmv(scale: float = 0.125, seed: int = 0,
              device: str | torch.device | None = None) -> PaperWorkload:
    """The SpMV workload; ``scale=1.0`` is Table-I size.  ``scale`` only
    shrinks the correctness data: the traces are always full-scale, so
    the cache models see the real working set.  ``data`` holds the CSR
    matrix (``indptr``, int32 ``indices``, float32 ``values``) and the
    float32 vector ``x``; ``expected`` is A @ x in reduceat order."""
    dev = get_device(device)
    dim = max(64, int(FULL_DIM * scale))
    rng = np.random.default_rng(seed)
    nnz_per_row = np.maximum(1, rng.binomial(dim, DENSITY, size=dim))
    indptr = np.zeros(dim + 1, np.int64)
    indptr[1:] = np.cumsum(nnz_per_row)
    indices = np.concatenate([
        np.sort(rng.choice(dim, size=n, replace=False))
        for n in nnz_per_row]).astype(np.int32)
    data = rng.normal(size=int(indptr[-1])).astype(np.float32)
    x = rng.normal(size=dim).astype(np.float32)

    cols = torch.from_numpy(indices).to(dev)
    vals = torch.from_numpy(data).to(dev)
    xv = torch.from_numpy(x).to(dev)

    def loop_body(acc, j):
        c = cols[j]          # sequential index load
        v = vals[j]          # sequential value load
        xx = xv[c]           # data-dependent gather (the pathology)
        return acc + v * xx  # fp multiply feeding the accumulation SCC

    n_sim = 40_000
    trng = np.random.default_rng(seed + 100)
    traces = {
        "cols": MemAccess("cols", np.arange(n_sim) * 4),
        "vals": MemAccess("vals", np.arange(n_sim) * 4 + (1 << 24)),
        "x": MemAccess("x", trng.integers(0, FULL_DIM, n_sim).astype(
            np.int64) * 4 + (1 << 25)),
    }
    n_full = int(FULL_DIM * FULL_DIM * DENSITY)
    full_traces = {
        "cols": MemAccess("cols", gen=lambda lo, hi: np.arange(lo, hi) * 4,
                          length=n_full),
        "vals": MemAccess(
            "vals", gen=lambda lo, hi: np.arange(lo, hi) * 4 + (1 << 24),
            length=n_full),
        "x": MemAccess(
            "x", gen=lambda lo, hi: hash_ints(lo, hi, FULL_DIM, seed + 100)
            * 4 + (1 << 25), length=n_full),
    }
    expected = np.add.reduceat(data * x[indices],
                               indptr[:-1].astype(np.int64))
    return PaperWorkload(
        name="spmv",
        loop_body=loop_body,
        carry_example=torch.zeros((), dtype=torch.float32, device=dev),
        body_args=(torch.zeros((), dtype=torch.int32, device=dev),),
        traces=traces,
        full_traces=full_traces,
        n_iters_full=n_full,
        n_iters_sim=n_sim,
        instrs_per_iter=9.0,
        device=dev,
        data={"indptr": indptr, "indices": indices, "values": data, "x": x},
        expected=expected.astype(np.float32),
    )
