"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), a plain
PyTorch version of each (:mod:`.ref`), and the dispatching wrappers."""

from .flash_attention import decode_attention, flash_attention
from .ops import csr_to_bsr, ref, spmv
from .scan import running_max
from .spmv import spmv_bsr

__all__ = ["csr_to_bsr", "decode_attention", "flash_attention", "ref",
           "running_max", "spmv", "spmv_bsr"]
