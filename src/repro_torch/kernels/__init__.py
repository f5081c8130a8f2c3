"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), a plain
PyTorch version of each (:mod:`.ref`), and the dispatching wrappers.

The names are the reference's ``repro.kernels``, from :mod:`.ops` as
there, plus the raw SpMV and running-max wrappers."""

from .ops import (csr_to_bsr, decode_attention, flash_attention, matmul,
                  rmsnorm, spmv)
from .decoupled_gather import (decoupled_gather, decoupled_gather_ref,
                               decoupled_gather_staged)
from . import ref
from .scan import running_max
from .spmv import spmv_bsr

__all__ = ["matmul", "flash_attention", "decode_attention", "rmsnorm",
           "spmv", "csr_to_bsr", "decoupled_gather",
           "decoupled_gather_ref", "decoupled_gather_staged", "ref",
           "running_max", "spmv_bsr"]
