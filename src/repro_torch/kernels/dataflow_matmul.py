"""The template's tile pipeline as a matmul, hand-written in CUDA.

As in the reference's Pallas kernel, tiles of x and w stream through a
buffered ring (the access stage and its FIFO) into an fp32 accumulator
(the execute stage), cast to the output dtype at the last k.  Two designs
on the card, see ``csrc/dataflow_matmul.cu``; :func:`route` picks one
from the shapes, the dtypes and the alignment, before the launch:

* ``"wgmma+tma"`` — bf16 × bf16 whose rows TMA can address (K and N
  multiples of 8, 16-byte-aligned bases): a TMA producer warp fills a
  four-stage mbarrier ring that two warpgroups consume with ``wgmma`` on
  the tensor cores;
* ``"cuda-core fp32"`` — everything else (every fp32 call, and bf16 rows
  TMA cannot take): a two-slot ``cp.async`` ring into fp32 FMAs.

Either kernel bounds its own edges, so no shape needs padding, and the
wrapper takes no block sizes: the reference's ``block_m/n/k`` are the
TPU's VMEM tiling and do not change the result.
"""

from __future__ import annotations

import dataclasses

import torch

from . import _lib, ref

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
#: rows of x the kernels' grids reach (65,535 tiles of 128)
MAX_ROWS = 65535 * 128

WGMMA = "wgmma+tma"
CUDA_CORE = "cuda-core fp32"
#: output tile widths of the wgmma route, widest first (its tiles are 128
#: rows: two consumer warpgroups of 64)
BLOCK_NS = (256, 192, 128, 64)
BLOCK_M = 128
#: streaming multiprocessors of the H100 SXM, for a route planned without
#: a card
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class Route:
    """The kernel a launch takes: its design, and the wgmma route's output
    tile width."""

    design: str
    block_n: int | None = None


def route(x: torch.Tensor, w: torch.Tensor, *,
          sms: int = H100_SMS) -> Route:
    """The design ``x @ w`` takes on the card, from the shapes, dtypes and
    alignment alone (x, w contiguous).

    bf16 × bf16 with K > 0, K and N multiples of 8 and both bases 16-byte
    aligned takes ``"wgmma+tma"`` (TMA's rows must be 16-byte multiples);
    everything else takes ``"cuda-core fp32"`` — fp32 because TF32 would
    miss the fp32 tolerance.  The wgmma route's tile width is the one whose
    tiles, in waves of ``sms`` (one tile per SM), take the least time: the
    number of waves times the width, the widest on a tie.
    """
    (M, K), N = x.shape, w.shape[1]
    if not (x.dtype == w.dtype == torch.bfloat16 and K > 0 and K % 8 == 0
            and N % 8 == 0 and x.data_ptr() % 16 == 0
            and w.data_ptr() % 16 == 0):
        return Route(CUDA_CORE)
    m_tiles = -(-M // BLOCK_M)  # ceiling divisions, here and below

    def cost(bn: int) -> int:
        tiles = m_tiles * -(-N // bn)
        return -(-tiles // sms) * bn   # waves x width
    return Route(WGMMA, min(BLOCK_NS, key=cost))


def dataflow_matmul(x: torch.Tensor, w: torch.Tensor, *,
                    out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``x @ w`` with fp32 accumulation.  x: (M, K), w: (K, N), both
    float32 or both bfloat16; the result is in ``out_dtype`` (float32 or
    bfloat16; default x's dtype).

    A CPU tensor takes the plain version (:func:`ref.matmul_ref`); a CUDA
    tensor launches the kernel of its :func:`route` or raises.
    """
    _lib.forbid_autograd("dataflow_matmul", x, w)
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
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"dataflow_matmul kernel takes at most {MAX_ROWS} "
                         f"rows, got {x.shape[0]}")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return _launch(x, w, out_dtype, route(x, w, sms=sms))


def _launch(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype,
            r: Route) -> torch.Tensor:
    """Launch the kernel of route ``r`` on checked CUDA tensors."""
    (M, K), N = x.shape, w.shape[1]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = _lib.lib("dataflow_matmul")
    with torch.cuda.device(x.device):
        if r.design == WGMMA:
            err = getattr(lib, f"dataflow_matmul_wgmma_bf16_"
                               f"{_SUFFIX[out_dtype]}")(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
                r.block_n, _lib.stream())
        else:
            err = getattr(lib, f"dataflow_matmul_{_SUFFIX[x.dtype]}_"
                               f"{_SUFFIX[out_dtype]}")(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), M, N, K,
                _lib.stream())
        _lib.LAUNCHES["dataflow_matmul"] += 1
        _lib.ROUTES["dataflow_matmul"][r.design] += 1
    _lib.check("dataflow_matmul", err)
    return out
