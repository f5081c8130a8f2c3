"""Table-I Floyd–Warshall (1024 nodes, ≈8 MB) for the port.

The numpy parts are the reference benchmark's ``make_floyd_warshall``
(``benchmarks/paper_kernels.py``) unchanged: the same seeded distance
matrix, the same window traces and the same shift/mask-generated
full-scale traces of the whole k/i/j triple loop.  The loop body is one
(k, i, j) relaxation, written in torch; the store is
:func:`~repro_torch.core.cdfg.at_set`, the port's ``dist.at[i*n+j].set``.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import get_device
from ..core.cdfg import at_set
from ..core.simulator import MemAccess
from .base import PaperWorkload, i32


def make_floyd_warshall(scale: float = 0.125, seed: int = 2,
                        device: str | torch.device | None = None
                        ) -> PaperWorkload:
    """``scale=1.0`` is Table-I size (n 1024); ``scale`` only shrinks the
    distance matrix, the traces are always full-scale."""
    dev = get_device(device)
    n = max(32, int(1024 * scale))
    rng = np.random.default_rng(seed)
    dist0 = rng.integers(1, 100, size=(n, n)).astype(np.float32)
    np.fill_diagonal(dist0, 0)

    def loop_body(dist, kij):
        k, i, j = kij
        d_ij = dist[i * n + j]            # load
        d_ik = dist[i * n + k]            # load
        d_kj = dist[k * n + j]            # load
        new = torch.minimum(d_ij, d_ik + d_kj)
        return at_set(dist, i * n + j, new)  # store

    n_sim = 40_000
    nf = 1024  # full Table-I scale for the memory model
    ks = np.zeros(n_sim, np.int64)
    iis = (np.arange(n_sim) // nf) % nf
    jjs = np.arange(n_sim) % nf
    traces = {
        "d_ij": MemAccess("d_ij", (iis * nf + jjs) * 4),
        "d_ik": MemAccess("d_ik", (iis * nf + ks) * 4),
        "d_kj": MemAccess("d_kj", (ks * nf + jjs) * 4),
        "d_store": MemAccess("d_store", (iis * nf + jjs) * 4,
                             is_store=True),
    }

    # full Table-I scale: the whole k/i/j triple loop, window-generated.
    # nf is a power of two, so the index splits are shifts/masks on int32.
    n_full = nf ** 3
    _shift = nf.bit_length() - 1
    _mask = nf - 1

    def _fkij(lo, hi):
        t = np.arange(lo, hi, dtype=np.int32)  # n_full = 2^30 fits
        return t >> (2 * _shift), (t >> _shift) & _mask, t & _mask

    def _g_ij(lo, hi):
        _, fi, fj = _fkij(lo, hi)
        return ((fi << _shift) + fj) << 2

    def _g_ik(lo, hi):
        fk, fi, _ = _fkij(lo, hi)
        return ((fi << _shift) + fk) << 2

    def _g_kj(lo, hi):
        fk, _, fj = _fkij(lo, hi)
        return ((fk << _shift) + fj) << 2

    full_traces = {
        "d_ij": MemAccess("d_ij", gen=_g_ij, length=n_full),
        "d_ik": MemAccess("d_ik", gen=_g_ik, length=n_full),
        "d_kj": MemAccess("d_kj", gen=_g_kj, length=n_full),
        "d_store": MemAccess("d_store", gen=_g_ij, length=n_full,
                             is_store=True),
    }

    d = dist0.copy()
    for k in range(n):
        d = np.minimum(d, d[:, k:k + 1] + d[k:k + 1, :])
    return PaperWorkload(
        name="floyd_warshall",
        loop_body=loop_body,
        carry_example=torch.from_numpy(dist0.reshape(-1)).to(dev),
        body_args=((i32(0, dev), i32(0, dev), i32(1, dev)),),
        traces=traces,
        full_traces=full_traces,
        n_iters_full=n_full,
        n_iters_sim=n_sim,
        instrs_per_iter=12.0,
        device=dev,
        data={"dist0": dist0},
        nonaliasing_carries=(0,),  # §III-A annotation: k-pass writes don't
                                   # feed row/col-k reads within the pass
        expected=d.astype(np.float32),
    )
