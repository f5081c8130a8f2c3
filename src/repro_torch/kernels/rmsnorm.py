"""Fused RMSNorm as a hand-written CUDA kernel: one read and one write of
each element instead of the three passes of the plain version.

The reference tiles ``block_rows`` rows into VMEM per grid step; that is
the TPU's tiling and does not change the result, so the port takes no
such argument.  The kernel gives each row one warp (one block past 1024
columns) and keeps the row in registers.  See ``csrc/rmsnorm.cu``.
"""

from __future__ import annotations

import torch

from . import _lib, ref

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """``x·rsqrt(mean(x²)+eps)·w`` over the last axis of an (R, D) ``x``,
    computed in fp32 and returned in x's dtype.

    A CPU tensor takes the plain version (:func:`ref.rmsnorm_ref`); a
    CUDA tensor launches the kernel or raises.  x and weight are float32
    or bfloat16, in any pairing, contiguous.
    """
    if x.ndim != 2 or weight.shape != (x.shape[1],):
        raise ValueError(f"rmsnorm: x {tuple(x.shape)} is not (R, D) or "
                         f"weight {tuple(weight.shape)} is not (D,)")
    if x.device.type == "cpu":
        return ref.rmsnorm_ref(x, weight, eps)
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError("rmsnorm: x and weight must lie on one CUDA device "
                         "(or both on the CPU)")
    if x.dtype not in _SUFFIX or weight.dtype not in _SUFFIX:
        raise TypeError(f"rmsnorm kernel takes float32 or bfloat16 x and "
                        f"weight, got {x.dtype} and {weight.dtype}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rmsnorm kernel takes contiguous tensors")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    R, D = x.shape
    entry = f"rmsnorm_{_SUFFIX[x.dtype]}_{_SUFFIX[weight.dtype]}"
    with torch.cuda.device(x.device):
        err = getattr(_lib.lib("rmsnorm"), entry)(
            x.data_ptr(), weight.data_ptr(), out.data_ptr(), R, D,
            float(eps), _lib.stream())
        _lib.LAUNCHES["rmsnorm"] += 1
    _lib.check("rmsnorm", err)
    return out
