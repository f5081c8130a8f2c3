"""Int8 gradient compression for a data-parallel gradient reduce.

The port of the reference's ``optim/compress.py``, meant there for the
reduce that crosses the slow link between pods: quantize each
contribution to int8 with a per-chunk fp32 scale and sum the int8
payloads in int32 — exact integer addition, so the only error is the
initial per-element quantization (≤ scale/2 per contributor).

As in the reference's code, the codes are summed by a ``psum`` of int32
words: one ``all_reduce`` of as many 4-byte words as the fp32 reduce it
replaces, plus a max-reduce of one fp32 word per chunk.  So the
collectives carry no fewer bytes than the fp32 ``all_reduce`` (the
reference's docstring counts ≈4× fewer; its code sums int32 too), and
their cost does not grow with the number of ranks.

Error behaviour: symmetric stochastic-free quantization with per-chunk
max-abs scaling; worst-case relative error per element 1/127 per chunk,
zero-mean in aggregate.  An optional error-feedback buffer (residual
carry) makes the compression unbiased over steps (Seide et al., 1-bit
SGD lineage).
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from .. import tree
from ..core.collectives import Collectives


def _chunks(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """``x`` flattened to fp32, zero-padded to whole chunks, one per row."""
    flat = x.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % chunk
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, chunk)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax / 127, 1e-12)``.  The divisor is a tensor on ``amax``'s
    device: CUDA divides by a Python scalar as a multiply by its
    reciprocal, one ulp off the reference's division."""
    return (amax / torch.full_like(amax, 127.0)).clamp_min(1e-12)


def _codes(c: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Round half to even, as ``jnp.round``; then clip to ±127."""
    return torch.clamp(torch.round(c / scale[:, None]), -127, 127
                       ).to(torch.int8)


def quantize_int8(x: torch.Tensor, chunk: int = 256
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-chunk symmetric int8 quantization.  Returns (q, scales)."""
    c = _chunks(x, chunk)
    scale = _scale(c.abs().amax(dim=1))
    return _codes(c, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape: tuple,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    c = q.to(torch.float32) * scale[:, None]
    n = 1
    for s in shape:
        n *= s
    return c.reshape(-1)[:n].reshape(shape).to(dtype)


def _psum_chunks(c: torch.Tensor, comm: Collectives) -> torch.Tensor:
    """The sum over ``comm``'s ranks of the fp32 chunks ``c`` (one per
    row): (1) agree on one scale per chunk, a max-reduce of 1/chunk of the
    values; (2) quantize with the shared scale and sum the codes in
    int32."""
    scale = _scale(comm.pmax(c.abs().amax(dim=1)))
    qsum = comm.psum(_codes(c, scale).to(torch.int32))
    return qsum.to(torch.float32) * scale[:, None]


def _unchunk(c: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return c.reshape(-1)[:like.numel()].reshape(like.shape).to(like.dtype)


def compressed_psum(x: torch.Tensor,
                    group: dist.ProcessGroup | None = None,
                    chunk: int = 256) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks (default: the initialised
    world) with an int8 payload; every rank calls it (SPMD) and gets the
    same result.

    Two phases: (1) a tiny fp32 max-reduce agrees on one scale per chunk,
    (2) every rank quantizes with the *shared* scale and the int8 codes
    are summed in int32 — exact, so the only error is the initial
    per-element quantization (≤ scale/2 per contributor)."""
    return _unchunk(_psum_chunks(_chunks(x, chunk),
                                 Collectives(group, x.device)), x)


def compress_tree_psum(grads: Any,
                       group: dist.ProcessGroup | None = None,
                       chunk: int = 256) -> Any:
    """:func:`compressed_psum` of every leaf of ``grads`` (one device), in
    one bucket: the leaves' chunks side by side, each leaf padded to
    whole chunks as :func:`compressed_psum` pads it, so every chunk — and
    so every value — is the one :func:`compressed_psum` of its leaf
    gives, and the ranks make two collectives in all, not two a leaf."""
    leaves = tree.leaves(grads)
    if not leaves:
        return grads
    blocks = [_chunks(g, chunk) for g in leaves]
    summed = _psum_chunks(torch.cat(blocks),
                          Collectives(group, leaves[0].device))
    rows = torch.tensor([b.shape[0] for b in blocks]).cumsum(0).tolist()
    return tree.unflatten(grads, [
        _unchunk(summed[end - b.shape[0]:end], g)
        for g, b, end in zip(leaves, blocks, rows)])


class ErrorFeedback:
    """Residual carry for unbiased long-run compression."""

    @staticmethod
    def init(params: Any) -> Any:
        return tree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)

    @staticmethod
    def apply(grads: Any, residual: Any) -> tuple[Any, Any]:
        """Add carried residual; return (corrected_grads, new_residual_fn)
        — caller computes new residual as corrected - quantized."""
        corrected = tree.tree_map(
            lambda g, r: g.to(torch.float32) + r, grads, residual)
        return corrected, corrected
