"""Public entry points of the port's kernels, with the reference's
``kernels/ops.py`` layout contract.

Dispatch lives in each kernel wrapper: a CPU tensor goes to the kernel's
plain PyTorch version, a CUDA tensor to the hand-written CUDA kernel
(which raises on inputs it does not take — there is no silent fallback).
The attention entry points keep the reference's padding policy and hand
the kernels contiguous tensors, so models never see layout constraints.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import ref as ref  # re-exported for tests/benchmarks
from .flash_attention import decode_attention as _decode_kernel
from .flash_attention import flash_attention as _flash_kernel
from .spmv import csr_to_bsr
from .spmv import spmv_bsr as spmv  # BSR SpMV (see kernels/spmv.py)

__all__ = ["csr_to_bsr", "decode_attention", "flash_attention", "ref",
           "spmv"]


#: the reference's default key block; keys are padded to a multiple of
#: ``min(BLOCK_K, ceil8(Sk))`` as there
BLOCK_K = 128


def _ceil_mult(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


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
