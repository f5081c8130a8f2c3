"""Plain PyTorch versions of the port's CUDA kernels.

Each function is the semantic ground truth its kernel is held against:
the CPU tests run it against the JAX reference, ``chip_smoke.py``
compares each kernel with it on the card, and a kernel wrapper uses it
for a tensor that lies on the CPU.  Only tensor ops here, no kernels.
"""

from __future__ import annotations

import math

import torch


def matmul_ref(x: torch.Tensor, w: torch.Tensor,
               out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain matmul with fp32 accumulation, cast to ``out_dtype`` (else
    x's dtype).  Call it with ``allow_tf32`` off for a full-fp32 product
    on the card."""
    out = torch.matmul(x.float(), w.float())
    return out.to(out_dtype or x.dtype)


def spmv_bsr_ref(values: torch.Tensor, col_ids: torch.Tensor,
                 x: torch.Tensor, nrows: int) -> torch.Tensor:
    """Block-sparse-row SpMV.

    values : (n_block_rows, nnz_blocks, bm, bk) stored blocks
    col_ids: (n_block_rows, nnz_blocks) int32 — block-column of each stored
             block; −1 marks padding blocks (contribute zero); an id past
             the last block column reads the last x tile, as the
             reference's jnp indexing clamps it.
    x      : (K,) dense vector; K = n_block_cols * bk
    returns: (nrows,) = A @ x with fp32 accumulation.
    """
    bk = values.shape[3]
    xb = x.reshape(-1, bk)                            # (n_block_cols, bk)
    valid = col_ids >= 0
    cols = torch.where(valid, col_ids.clamp(max=xb.shape[0] - 1), 0)
    gathered = xb[cols.long()]                        # (nbr, nnz, bk)
    gathered = torch.where(valid[..., None], gathered, 0)
    y = torch.einsum("rnmk,rnk->rm", values.float(), gathered.float())
    return y.reshape(-1)[:nrows].to(x.dtype)


#: tile width of the plain version's blocked scan
SCAN_TILE = 1024


def _doubling_max_scan(t: torch.Tensor) -> torch.Tensor:
    """Inclusive max-scan along the last axis by Hillis–Steele doubling
    (the shuffle scan the kernel runs inside a tile)."""
    t = t.clone()
    d = 1
    while d < t.shape[-1]:
        t[..., d:] = torch.maximum(t[..., d:], t[..., :-d].clone())
        d *= 2
    return t


def running_max_ref(x: torch.Tensor,
                    carry: torch.Tensor | None = None) -> torch.Tensor:
    """Inclusive running maximum of a 1-D integer tensor, blocked: per-tile
    maxima, an exclusive scan of them into each tile's prefix (what the
    kernel's look-back computes), then a scan of each tile folded with its
    prefix.  ``carry`` (one value of x's dtype, or None) is folded in front
    of x.  Exact."""
    n = x.shape[0]
    low = torch.iinfo(x.dtype).min
    nt = -(-n // SCAN_TILE)
    tiles = torch.full((nt * SCAN_TILE,), low, dtype=x.dtype, device=x.device)
    tiles[:n] = x
    tiles = tiles.reshape(nt, SCAN_TILE)
    head = tiles.new_full((1,), low) if carry is None \
        else carry.reshape(1).to(x.dtype)
    incl = _doubling_max_scan(torch.cat([head, tiles.amax(dim=1)]))
    out = torch.maximum(_doubling_max_scan(tiles), incl[:-1, None])
    return out.reshape(-1)[:n]


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: float | None = None) -> torch.Tensor:
    """GQA prefill attention as the kernel computes it.

    q: (B, Hq, Sq, d); k, v: (B, Hkv, Sk, d) with Hq % Hkv == 0; query
    head h reads kv head ``h // (Hq // Hkv)``.  The causal mask aligns
    query and key positions from 0 (query i sees keys 0..i), as the
    reference's Pallas kernel does.  fp32 math, output in q's dtype.
    """
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.float().reshape(B, Hkv, Hq // Hkv, Sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    if causal:
        visible = (torch.arange(Sk, device=q.device)[None, :]
                   <= torch.arange(Sq, device=q.device)[:, None])
        s = s.masked_fill(~visible, float("-inf"))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", w, v.float())
    return out.reshape(B, Hq, Sq, d).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, lengths: torch.Tensor,
                         *, scale: float | None = None) -> torch.Tensor:
    """One-token GQA decode attention over a ragged cache.

    q: (B, Hq, d); caches: (B, Hkv, S, d); lengths: (B,) int — the valid
    prefix of each sequence's cache, in [0, S].  A sequence of length 0
    gives zeros, as the kernel does.  fp32 math, output in q's dtype.
    """
    B, Hq, d = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.float().reshape(B, Hkv, Hq // Hkv, d)
    s = torch.einsum("bhgd,bhsd->bhgs", qf, k_cache.float()) * scale
    valid = (torch.arange(S, device=q.device)[None, :]
             < lengths.to(q.device).long()[:, None])          # (B, S)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    w = torch.softmax(s, dim=-1)
    w = torch.where(valid.any(dim=1)[:, None, None, None], w, 0.0)
    out = torch.einsum("bhgs,bhsd->bhgd", w, v_cache.float())
    return out.reshape(B, Hq, d).to(q.dtype)


def rmsnorm_ref(x: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis in fp32: ``x·rsqrt(mean(x²)+eps)·w``,
    output in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)
