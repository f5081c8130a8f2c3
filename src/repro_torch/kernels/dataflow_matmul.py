"""The template's tile pipeline as a matmul, hand-written in CUDA.

As in the reference's Pallas kernel, tiles of x and w stream through a
two-slot buffer (the access stage and its FIFO) into an fp32 accumulator
(the execute stage), cast to the output dtype at the last k.  On the card
the two slots are an explicit shared-memory ring filled by ``cp.async``
while the previous tile is multiplied; see ``csrc/dataflow_matmul.cu``.
The kernel bounds its own edges, so no shape needs padding, and it takes
no block sizes: the reference's ``block_m/n/k`` are the TPU's VMEM tiling
and do not change the result.
"""

from __future__ import annotations

import torch

from . import _lib, ref

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: rows of x the kernel's grid reaches (65,535 tiles of 128)
MAX_ROWS = 65535 * 128


def dataflow_matmul(x: torch.Tensor, w: torch.Tensor, *,
                    out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ w`` with fp32 accumulation.  x: (M, K), w: (K, N), both
    float32 or both bfloat16; the result is in ``out_dtype`` (float32 or
    bfloat16; default x's dtype).

    A CPU tensor takes the plain version (:func:`ref.matmul_ref`); a CUDA
    tensor launches the kernel or raises.
    """
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"dataflow_matmul: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not (M, K) and (K, N)")
    if x.device.type == "cpu":
        return ref.matmul_ref(x, w, out_dtype)
    out_dtype = out_dtype or x.dtype
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError("dataflow_matmul: x and w must lie on one CUDA "
                         "device (or both on the CPU)")
    if x.dtype not in _SUFFIX or w.dtype != x.dtype \
            or out_dtype not in _SUFFIX:
        raise TypeError(f"dataflow_matmul kernel takes float32 x float32 or "
                        f"bfloat16 x bfloat16 into float32 or bfloat16, got "
                        f"{x.dtype} x {w.dtype} into {out_dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("dataflow_matmul kernel takes contiguous tensors")
    (M, K), N = x.shape, w.shape[1]
    if M > MAX_ROWS:
        raise ValueError(f"dataflow_matmul kernel takes at most {MAX_ROWS} "
                         f"rows, got {M}")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    entry = f"dataflow_matmul_{_SUFFIX[x.dtype]}_{_SUFFIX[out_dtype]}"
    with torch.cuda.device(x.device):
        err = getattr(_lib.lib("dataflow_matmul"), entry)(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
            _lib.stream())
        _lib.LAUNCHES["dataflow_matmul"] += 1
    _lib.check("dataflow_matmul", err)
    return out
