"""SpMV — the paper's flagship kernel, two ways: the port's main path.

Run:  ``python -m repro_torch.examples.spmv_dataflow [--device cpu]``

1. The HLS view: trace the CSR inner loop, let Algorithm 1 build the
   pipeline (index fetch → value fetch → x gather → FMA), simulate it on
   the Zynq memory model against the fused engine (Fig. 5, one kernel).
2. The GPU view: the same decoupling as the hand-written BSR kernel
   (``spmv_bsr``, ``csrc/spmv_bsr.cu``) — the block-column ids drive
   each x-tile fetch through a shared-memory ring — validated against
   the dense product.  On the CPU the kernel's plain version runs.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import _device
from ..core.simulator import MemAccess, acp
from ..dataflow import compile as dataflow_compile
from ..kernels import csr_to_bsr, spmv


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "repro_torch.examples.spmv_dataflow")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    dev = _device.get_device(ap.parse_args(argv).device)
    _device.set_device(dev)
    rng = np.random.default_rng(0)

    # ---- 1. HLS view -------------------------------------------------------
    dim, density = 512, 0.25
    dense = ((rng.random((dim, dim)) < density)
             * rng.normal(size=(dim, dim))).astype(np.float32)
    vals_np = dense[dense != 0]
    cols_np = np.nonzero(dense)[1].astype(np.int32)
    vals = torch.from_numpy(vals_np).to(dev)
    cols = torch.from_numpy(cols_np).to(dev)
    x_np = rng.normal(size=dim).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)

    def inner_loop(acc, j):
        c = cols[j]
        v = vals[j]
        return acc + v * x[c]

    # the driver in loop mode: carry back-edges recreate the cyclic CDFG,
    # Algorithm 1 builds index fetch -> value fetch -> x gather -> FMA
    compiled = dataflow_compile(
        inner_loop, torch.zeros((), device=dev),
        torch.zeros((), dtype=torch.int32, device=dev), loop=True)
    print(compiled.report())

    n = min(len(vals_np), 20_000)
    traces = [MemAccess("cols", np.arange(n) * 4),
              MemAccess("vals", np.arange(n) * 4 + (1 << 24)),
              MemAccess("x", cols_np[:n].astype(np.int64) * 4 + (1 << 25))]
    report = compiled.simulate(n_iters=n, traces=traces, mem=acp(),
                               fifo_depth=32)
    df, cv = report.dataflow, report.conventional
    print(f"\nZynq model, {n} nnz: conventional {cv.cycles_per_iter:.1f} "
          f"cyc/nnz vs dataflow {df.cycles_per_iter:.1f} cyc/nnz "
          f"→ {report.speedup:.1f}x\n")

    # ---- 2. GPU view -------------------------------------------------------
    indptr = np.zeros(dim + 1, np.int64)
    indptr[1:] = np.cumsum((dense != 0).sum(1))
    bvals, bcols = csr_to_bsr(indptr, cols_np, vals_np, (dim, dim),
                              bm=8, bk=128)
    y = spmv(torch.from_numpy(bvals).to(dev), torch.from_numpy(bcols).to(dev),
             x)
    np.testing.assert_allclose(y.cpu().numpy()[:dim], dense @ x_np,
                               rtol=1e-4, atol=1e-4)
    print(f"hand-written BSR SpMV (block-column ids drive the x-tile "
          f"fetches) on {dev.type}: OK — {bvals.shape[0]}x{bvals.shape[1]} "
          f"blocks of {bvals.shape[2]}x{bvals.shape[3]}")


if __name__ == "__main__":
    main()
