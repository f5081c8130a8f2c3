"""Public entry points of the port's kernels, with the reference's
``kernels/ops.py`` layout contract.

Dispatch lives in each kernel wrapper: a CPU tensor goes to the kernel's
plain PyTorch version, a CUDA tensor to the hand-written CUDA kernel
(which raises on inputs it does not take — there is no silent fallback).
"""

from __future__ import annotations

from . import ref as ref  # re-exported for tests/benchmarks
from .spmv import csr_to_bsr
from .spmv import spmv_bsr as spmv  # BSR SpMV (see kernels/spmv.py)

__all__ = ["csr_to_bsr", "ref", "spmv"]
