"""SpMV — the paper's first benchmark kernel, as a hand-written CUDA kernel.

The paper's CSR SpMV decouples into (1) index fetch → (2) value/x gather
→ (3) FMA.  As in the reference package, the matrix is re-blocked into
BSR (block-sparse rows) once on the host (:func:`csr_to_bsr`), and
:func:`spmv_bsr` runs the three stages per block row on the card.  Two
designs, see ``csrc/spmv_bsr.cu``; :func:`spmv_route` picks one from the
shape and the alignment, before the launch:

* ``"bulk-copy ring"`` — the template itself: a producer warp reads the
  column ids (index fetch) and issues bulk copies of each slot's value
  block and the x tile it names (gather) into an mbarrier-guarded ring in
  shared memory (the FIFO), which consumer warps drain into fp32 sums
  (FMA); a persistent grid keeps the ring running across block rows;
* ``"scalar loads"`` — every shape the ring cannot take (bk not a
  multiple of 4, bases not 16-byte aligned, two stages too large for
  shared memory): a block per block row, warps walking the slots.

Neither limits bm or the slots per block row, as the reference does not.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _lib, ref


RING = "bulk-copy ring"
SCALAR = "scalar loads"
#: shared memory one block may use on the H100 (232,448 bytes)
MAX_SMEM = 227 * 1024


def spmv_route(values: torch.Tensor, x: torch.Tensor) -> str:
    """The design ``spmv_bsr`` takes on the card, from the shape and the
    alignment alone (values, x contiguous).

    The bulk-copy ring needs whole 16-byte rows (bk a multiple of 4),
    16-byte-aligned ``values`` and ``x``, and two stages (each up to
    16 KB of value blocks, or one larger block, with their x tiles), the
    ring's header and the lanes' row sums in a block's shared memory;
    everything else takes the scalar loads.
    """
    bm, bk = values.shape[2], values.shape[3]
    tile = 4 * bm * bk
    slots = max(1, min(32, 16384 // tile)) if tile else 1
    stage = slots * (tile + 4 * bk)
    fits = 2 * stage + 128 * bm + 256 <= MAX_SMEM  # + 32 lane sums a row
    if bk % 4 == 0 and values.data_ptr() % 16 == 0 \
            and x.data_ptr() % 16 == 0 and fits:
        return RING
    return SCALAR


def spmv_bsr(values: torch.Tensor, col_ids: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Block-sparse-row SpMV.

    values : (n_block_rows, nnz_blocks, bm, bk) float32
    col_ids: (n_block_rows, nnz_blocks) int32, −1 = padding; ids past
             the last block column read the last x tile, as the
             reference's indexing clamps them
    x      : (K,) float32 with K divisible by bk
    returns (n_block_rows * bm,) float32

    A CPU tensor takes the plain version (:func:`ref.spmv_bsr_ref`); a
    CUDA tensor launches the kernel of its :func:`spmv_route` or raises.
    """
    _lib.forbid_autograd("spmv_bsr", values, x)
    nbr, nnz, bm, bk = values.shape
    if x.shape[0] % bk:
        raise ValueError(f"x length {x.shape[0]} is not a multiple of "
                         f"bk={bk}")
    if col_ids.shape != (nbr, nnz):
        raise ValueError(f"col_ids shape {tuple(col_ids.shape)} != "
                         f"{(nbr, nnz)}")
    if values.device.type == "cpu":
        return ref.spmv_bsr_ref(values, col_ids, x, nbr * bm)
    if values.device.type != "cuda" or {col_ids.device, x.device} \
            != {values.device}:
        raise ValueError("spmv_bsr: values, col_ids and x must all lie on "
                         "one CUDA device (or all on the CPU)")
    if values.dtype != torch.float32 or x.dtype != torch.float32 \
            or col_ids.dtype != torch.int32:
        raise TypeError("spmv_bsr kernel takes float32 values and x and "
                        "int32 col_ids")
    if not (values.is_contiguous() and col_ids.is_contiguous()
            and x.is_contiguous()):
        raise ValueError("spmv_bsr kernel takes contiguous tensors")
    return _launch(values, col_ids, x, spmv_route(values, x))


def _launch(values: torch.Tensor, col_ids: torch.Tensor, x: torch.Tensor,
            design: str) -> torch.Tensor:
    """Launch the kernel of ``design`` on checked CUDA tensors."""
    nbr, nnz, bm, bk = values.shape
    y = torch.empty(nbr * bm, dtype=torch.float32, device=values.device)
    if y.numel() == 0:
        return y
    entry = "spmv_bsr_ring_f32" if design == RING else "spmv_bsr_f32"
    with torch.cuda.device(values.device):
        err = getattr(_lib.lib("spmv_bsr"), entry)(
            values.data_ptr(), col_ids.data_ptr(), x.data_ptr(),
            y.data_ptr(), nbr, nnz, bm, bk, x.shape[0] // bk, _lib.stream())
        _lib.LAUNCHES["spmv_bsr"] += 1
        _lib.ROUTES["spmv_bsr"][design] += 1
    _lib.check("spmv_bsr", err)
    return y


def csr_to_bsr(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray,
               shape: tuple[int, int], bm: int = 8, bk: int = 128
               ) -> tuple[np.ndarray, np.ndarray]:
    """Host-side re-blocking of CSR into the kernel's BSR layout.

    Returns (values, col_ids) with values (nbr, nnz_max, bm, bk) and
    col_ids (nbr, nnz_max) int32 (−1 padding): each block row's touched
    block columns in ascending order.  Output is identical to the
    reference package's ``csr_to_bsr``; this version is vectorized so
    Table-I size (4M nonzeros) re-blocks in well under a second.
    """
    M, K = shape
    nbr = (M + bm - 1) // bm
    indptr = np.asarray(indptr, dtype=np.int64)
    lo, hi = int(indptr[0]), int(indptr[M])
    rows = np.repeat(np.arange(M, dtype=np.int64), np.diff(indptr[:M + 1]))
    cols = np.asarray(indices[lo:hi], dtype=np.int64)
    br, rr = np.divmod(rows, bm)
    bc, cc = np.divmod(cols, bk)
    nbc = max((K + bk - 1) // bk, int(bc.max(initial=-1)) + 1)
    key = br * nbc + bc
    touched = np.unique(key)                      # sorted by (row, column)
    t_row, t_col = np.divmod(touched, nbc)
    per_row = np.bincount(t_row, minlength=nbr)
    nnz_max = max(1, int(per_row.max(initial=1)))
    first = np.concatenate([[0], np.cumsum(per_row)[:-1]])
    t_slot = np.arange(len(touched)) - first[t_row]
    values = np.zeros((nbr, nnz_max, bm, bk), dtype=data.dtype)
    col_ids = np.full((nbr, nnz_max), -1, dtype=np.int32)
    col_ids[t_row, t_slot] = t_col
    slot = t_slot[np.searchsorted(touched, key)]
    values[br, slot, rr, cc] = np.asarray(data)[lo:hi]
    return values, col_ids
