"""Table-I SpMV (CSR, dim 4096, density 0.25) for the port.

The numpy parts are the reference benchmark's ``make_spmv``
(``benchmarks/paper_kernels.py``) unchanged — the same seeded CSR matrix,
the same window traces and the same hash-generated full-scale traces —
so the port and the reference simulate identical address streams.  The
loop body is written in torch and closes over the CSR arrays on the
chosen device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .._device import get_device
from ..core.simulator import MemAccess

#: Table-I scale: dim 4096, density 0.25 → 4,194,304 nonzeros (≈16 MB)
FULL_DIM = 4096
DENSITY = 0.25


@dataclasses.dataclass
class SpmvWorkload:
    dim: int
    indptr: np.ndarray
    indices: np.ndarray          # int32 column ids
    data: np.ndarray             # float32 values
    x: np.ndarray                # float32 dense vector
    expected: np.ndarray         # float32 A @ x (reduceat order)
    device: torch.device
    tensors: dict[str, torch.Tensor]   # cols / vals / x on ``device``
    loop_body: Callable          # (acc, j) -> acc + vals[j] * x[cols[j]]
    carry_example: torch.Tensor
    body_args: tuple
    traces: dict[str, MemAccess]       # the n_iters_sim window
    full_traces: dict[str, MemAccess]  # window generators, all iterations
    n_iters_full: int
    n_iters_sim: int


def _mix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer: a pure hash of the iteration index, so any
    trace window can be generated independently and reproducibly."""
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _hash_ints(lo: int, hi: int, bound: int, salt: int) -> np.ndarray:
    """Uniform ints in [0, bound) for iterations [lo, hi)."""
    idx = np.arange(lo, hi, dtype=np.uint64)
    with np.errstate(over="ignore"):
        h = _mix64(idx + np.uint64(salt) * np.uint64(0xD1342543DE82EF95))
    return (h % np.uint64(bound)).astype(np.int64)


def make_spmv(scale: float = 0.125, seed: int = 0,
              device: str | torch.device | None = None) -> SpmvWorkload:
    """The SpMV workload; ``scale=1.0`` is Table-I size.  ``scale`` only
    shrinks the correctness data: the traces are always full-scale, so
    the cache models see the real working set."""
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
            "x", gen=lambda lo, hi: _hash_ints(lo, hi, FULL_DIM, seed + 100)
            * 4 + (1 << 25), length=n_full),
    }
    expected = np.add.reduceat(data * x[indices],
                               indptr[:-1].astype(np.int64))
    return SpmvWorkload(
        dim=dim, indptr=indptr, indices=indices, data=data, x=x,
        expected=expected.astype(np.float32), device=dev,
        tensors={"cols": cols, "vals": vals, "x": xv},
        loop_body=loop_body,
        carry_example=torch.zeros((), dtype=torch.float32, device=dev),
        body_args=(torch.zeros((), dtype=torch.int32, device=dev),),
        traces=traces, full_traces=full_traces,
        n_iters_full=n_full, n_iters_sim=n_sim)
