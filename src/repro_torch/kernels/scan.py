"""The wavefront solver's running maximum as a hand-written CUDA kernel.

``running_max`` is the exact inclusive max-scan the cycle simulator's
solver runs per stage and chunk (``start[i] = max(b[i], start[i-1] +
c[i])`` becomes a running max over ``b - cumsum(c)``).  See
``csrc/running_max.cu`` for the three-pass design.
"""

from __future__ import annotations

import torch

from . import _lib, ref

_ENTRY = {torch.int64: "running_max_i64", torch.int32: "running_max_i32"}


def running_max(x: torch.Tensor) -> torch.Tensor:
    """Inclusive running maximum of a 1-D int64 or int32 tensor.

    A CPU tensor takes the plain version (:func:`ref.running_max_ref`);
    a CUDA tensor launches the kernel or raises.
    """
    if x.ndim != 1 or x.dtype not in _ENTRY:
        raise TypeError(f"running_max takes a 1-D int64 or int32 tensor, "
                        f"got {x.dtype} of shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return ref.running_max_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"running_max: unsupported device {x.device}")
    if not x.is_contiguous():
        raise ValueError("running_max kernel takes a contiguous tensor")
    n = x.shape[0]
    out = torch.empty_like(x)
    if n == 0:
        return out
    ntiles = -(-n // ref.SCAN_TILE)
    scratch = torch.empty(2 * ntiles, dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = getattr(_lib.lib("running_max"), _ENTRY[x.dtype])(
            x.data_ptr(), out.data_ptr(), scratch.data_ptr(), n,
            _lib.stream())
        _lib.LAUNCHES["running_max"] += 1
    _lib.check("running_max", err)
    return out
