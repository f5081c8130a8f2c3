"""Public entry points of the port's kernels, with the reference's
``kernels/ops.py`` layout contract.

Dispatch lives in each kernel wrapper: a CPU tensor goes to the kernel's
plain PyTorch version, a CUDA tensor to the hand-written CUDA kernel
(which raises on inputs it does not take — there is no silent fallback).
The attention entry points keep the reference's padding policy; every
entry point hands its kernel contiguous tensors, so callers never see
layout constraints.  ``matmul`` and ``rmsnorm`` take no block sizes: the
reference's are the TPU's VMEM tiling, and the kernels bound their own
edges, so nothing is padded.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import ref as ref  # re-exported for tests/benchmarks
from .dataflow_matmul import dataflow_matmul as _matmul_kernel
from .flash_attention import decode_attention as _decode_kernel
from .flash_attention import flash_attention as _flash_kernel
from .rmsnorm import rmsnorm as _rmsnorm_kernel
from .spmv import csr_to_bsr
from .spmv import spmv_bsr as spmv  # BSR SpMV (see kernels/spmv.py)

__all__ = ["csr_to_bsr", "decode_attention", "flash_attention", "matmul",
           "ref", "rmsnorm", "spmv"]


#: the reference's default key block; keys are padded to a multiple of
#: ``min(BLOCK_K, ceil8(Sk))`` as there
BLOCK_K = 128


def _ceil_mult(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def matmul(x: torch.Tensor, w: torch.Tensor, *,
           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Decoupled-pipeline matmul with fp32 accumulation; any (M, K) ×
    (K, N), float32 or bfloat16, into ``out_dtype`` (default x's)."""
    return _matmul_kernel(x.contiguous(), w.contiguous(),
                          out_dtype=out_dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """(B, Hq, Sq, d) × (B, Hkv, Sk, d)² → (B, Hq, Sq, d), GQA-aware.

    As the reference: keys are zero-padded to the key block, where they
    sit in the causal future of every query before Sk, and non-causal
    attention that would need padded keys raises.  Queries are not
    padded: the kernel bounds its own rows, and the reference discards
    the padded rows' output.
    """
    Sk = k.shape[2]
    pad = (-Sk) % min(BLOCK_K, _ceil_mult(Sk, 8))
    if pad and not causal:
        raise ValueError("non-causal padding unsupported; pad upstream")
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    return _flash_kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                         causal=causal, scale=scale)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     scale: float | None = None) -> torch.Tensor:
    """(B, Hq, d) against (B, Hkv, S, d) caches with ragged lengths.

    The reference pads S to its block; positions at or past a length are
    masked anyway, so the port hands the caches over as they are.
    """
    return _decode_kernel(q.contiguous(), k_cache.contiguous(),
                          v_cache.contiguous(),
                          lengths.to(torch.int32).contiguous(), scale=scale)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis; any leading shape, flattened to rows
    as the reference does."""
    shape = x.shape
    out = _rmsnorm_kernel(x.reshape(-1, shape[-1]).contiguous(),
                          weight.contiguous(), eps=eps)
    return out.reshape(shape)
