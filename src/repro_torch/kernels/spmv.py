"""SpMV — the paper's first benchmark kernel, as a hand-written CUDA kernel.

The paper's CSR SpMV decouples into (1) index fetch → (2) value/x gather
→ (3) FMA.  As in the reference package, the matrix is re-blocked into
BSR (block-sparse rows) once on the host (:func:`csr_to_bsr`), and
:func:`spmv_bsr` runs the three stages per block row on the card: the
block loads its row of block-column ids (index fetch), gathers the x
tile each id names (data-dependent gather) and accumulates the
``(bm, bk)`` block products in fp32 (FMA).  See ``csrc/spmv_bsr.cu``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _lib, ref


def spmv_bsr(values: torch.Tensor, col_ids: torch.Tensor,
             x: torch.Tensor) -> torch.Tensor:
    """Block-sparse-row SpMV.

    values : (n_block_rows, nnz_blocks, bm, bk) float32
    col_ids: (n_block_rows, nnz_blocks) int32, −1 = padding
    x      : (K,) float32 with K divisible by bk
    returns (n_block_rows * bm,) float32

    A CPU tensor takes the plain version (:func:`ref.spmv_bsr_ref`); a
    CUDA tensor launches the kernel or raises.
    """
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
    if not 1 <= bm <= 32 or nnz * 4 > 48 * 1024:
        raise ValueError(f"spmv_bsr kernel needs 1 <= bm <= 32 and at most "
                         f"12288 slots per block row (bm={bm}, nnz={nnz})")
    y = torch.empty(nbr * bm, dtype=torch.float32, device=values.device)
    with torch.cuda.device(values.device):
        err = _lib.lib("spmv_bsr").spmv_bsr_f32(
            values.data_ptr(), col_ids.data_ptr(), x.data_ptr(),
            y.data_ptr(), nbr, nnz, bm, bk, _lib.stream())
        _lib.LAUNCHES["spmv_bsr"] += 1
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
