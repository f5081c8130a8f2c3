"""Shared model layers: norms, rotary embeddings, MLPs, embeddings.

The port of the reference's ``models/layers.py``.  Plain functions over
a params dict whose keys mirror the reference's tree: every layer is
``apply(params, x, ...) -> y`` with a matching ``init(gen, ...) ->
params``.  Inits draw from an explicit ``torch.Generator`` (on the
generator's device) and place the result on ``device``.
"""

from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

from ..kernels.ref import rmsnorm_ref
from ..runtime.sharding import is_dtensor as _is_dtensor


def _normal(gen: torch.Generator | None,
            shape: tuple[int, ...]) -> torch.Tensor:
    """Standard normal fp32 draws from ``gen``; with no generator, a
    ``meta`` tensor of the shape (the inits then build shapes only, as
    the reference's under ``jax.eval_shape``)."""
    if gen is None:
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device)


def _dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
                dtype: torch.dtype, device: torch.device,
                scale: float | None = None) -> torch.Tensor:
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    return (_normal(gen, (in_dim, out_dim)) * scale).to(device, dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype: torch.dtype, device: torch.device) -> dict:
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def rmsnorm_apply(params: dict, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    return rmsnorm_ref(x, params["scale"], eps)


def layernorm_init(d: int, dtype: torch.dtype, device: torch.device) -> dict:
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


def layernorm_apply(params: dict, x: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    out = (xf - mu) * torch.rsqrt(var + eps)
    if "scale" in params:
        out = out * params["scale"].float()
    if "bias" in params:
        out = out + params["bias"].float()
    return out.to(x.dtype)


def nonparametric_ln_apply(x: torch.Tensor, eps: float = 1e-5
                           ) -> torch.Tensor:
    """OLMo-style LayerNorm without learnable affine [arXiv:2402.00838]."""
    return layernorm_apply({}, x, eps)


def make_norm(kind: str):
    """Returns (init(d, dtype, device) -> params, apply(params, x) -> y)."""
    if kind == "rmsnorm":
        return rmsnorm_init, rmsnorm_apply
    if kind == "layernorm":
        return layernorm_init, layernorm_apply
    if kind == "nonparametric_ln":
        return (lambda d, dtype, device: {}), (
            lambda params, x: nonparametric_ln_apply(x))
    raise ValueError(f"unknown norm {kind!r}")


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 1e4,
               device: torch.device | None = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x: (..., S, d) with d even; positions: broadcastable to (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (d/2,)
    ang = positions[..., None].float() * freqs             # (..., S, d/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d: int, d_ff: int, act: str,
             dtype: torch.dtype, device: torch.device) -> dict:
    p = {"w_up": _dense_init(gen, d, d_ff, dtype, device),
         "w_down": _dense_init(gen, d_ff, d, dtype, device)}
    if act == "silu":  # SwiGLU: separate gate
        p["w_gate"] = _dense_init(gen, d, d_ff, dtype, device)
    return p


def mlp_apply(params: dict, x: torch.Tensor,
              act: str = "silu") -> torch.Tensor:
    up = x @ params["w_up"]
    if act == "silu":
        gate = F.silu((x @ params["w_gate"]).float())
        h = (gate * up.float()).to(x.dtype)
    elif act == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(up.float(), approximate="tanh").to(x.dtype)
    else:
        raise ValueError(act)
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------

def embedding_init(gen: torch.Generator, vocab: int, d: int,
                   dtype: torch.dtype, device: torch.device) -> dict:
    return {"table": (_normal(gen, (vocab, d)) * 0.02).to(device, dtype)}


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` with the reference's read semantics: a negative index
    wraps once, and an index still out of range reads the nearest row
    (the jaxpr's gather clamps).  Plain torch indexing raises instead (a
    device-side assert on the card).  On a DTensor table the read is
    vocab-parallel (:func:`_take_sharded`)."""
    if _is_dtensor(x):
        return _take_sharded(x, idx)
    n = x.shape[0]
    return x[torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)]


def embedding_apply(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The table's rows at ``tokens``; an id out of range reads as in the
    reference (a negative id wraps once, then ids clamp to the table)."""
    return take(params["table"], tokens)


def unembed_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits in fp32 (loss numerics)."""
    return torch.einsum("...d,vd->...v", x.float(), params["table"].float())


# ---------------------------------------------------------------------------
# Sharded steps (``launch/steps.lower_cell``): explicit redistributes
# ---------------------------------------------------------------------------
#
# The model code runs unchanged on DTensors.  Where DTensor has no
# sharding strategy for an op, or its strategy differs between torch
# versions (a view that flattens two sharded dims, an indexed read of a
# sharded table), the code below redistributes explicitly and runs the
# op on each rank's local tensors.  On plain tensors each helper is the
# plain op.  PERF.md §3 lists every use.

def _as_dtensor(t: torch.Tensor, mesh) -> Any:
    """A plain tensor the model made, as a replicated DTensor."""
    if _is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _take_sharded(x, idx):
    """Vocab-parallel ``take``: the table's rows stay split over the mesh
    dims that split them (its other dims gathered), the ids are
    gathered whole, each rank reads the rows it holds and zeroes the
    others, and the result is a partial sum over those mesh dims (the
    next op's redistribute adds the ranks' reads)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = x.device_mesh
    rows = [isinstance(p, Shard) and p.dim == 0 for p in x.placements]
    xp = [Shard(0) if r else Replicate() for r in rows]
    xl = x.redistribute(mesh, xp).to_local()
    il = _as_dtensor(idx, mesh).redistribute(
        mesh, [Replicate()] * mesh.ndim).to_local()
    n = x.shape[0]
    il = torch.where(il < 0, il + n, il).clamp(0, n - 1)
    _, offset = compute_local_shape_and_global_offset(x.shape, mesh, xp)
    rel = il - offset[0]
    hit = (rel >= 0) & (rel < xl.shape[0])
    got = xl[rel.clamp(0, xl.shape[0] - 1)]
    got = got * hit.reshape(hit.shape + (1,) * (got.ndim - hit.ndim)).to(
        got.dtype)
    return DTensor.from_local(got, mesh, [Partial() if r else Replicate()
                                          for r in rows], run_check=False)


def on_replicas(fn, *args):
    """``fn(*args)``; where an argument is a DTensor, ``fn`` on whole
    replicas: each tensor argument is redistributed to replicated on the
    mesh (an explicit all-gather), ``fn`` runs on the local tensors, and
    its results (a tensor or a tuple of them) are wrapped as replicated.
    For the MoE's routing, scatter and gather, which must see every
    token (the capacity count runs over all of them)."""
    meshes = [a.device_mesh for a in args if _is_dtensor(a)]
    if not meshes:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate
    mesh = meshes[0]
    rep = [Replicate()] * mesh.ndim
    out = fn(*(_as_dtensor(a, mesh).redistribute(mesh, rep).to_local()
               if isinstance(a, torch.Tensor) else a for a in args))
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(o, mesh, rep, run_check=False)
                     for o in out)
    return DTensor.from_local(out, mesh, rep, run_check=False)


def write_at(cache: torch.Tensor, dim: int, index: int,
             value: torch.Tensor) -> None:
    """``cache.select(dim, index).copy_(value)``: a decode step's write
    into its cache, in place.  On a DTensor cache the rank that holds
    position ``index`` of ``dim`` writes it into its own shard (``value``
    redistributed to the cache's layout over the other dims): DTensor's
    ``cache[..., index] = value`` on a split ``dim`` would write into a
    gathered copy and lose the write."""
    if not _is_dtensor(cache):
        cache.select(dim, index).copy_(value)
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = cache.device_mesh
    vp = []
    for p in cache.placements:
        d = p.dim if isinstance(p, Shard) else None
        vp.append(Replicate() if d is None or d == dim
                  else Shard(d if d < dim else d - 1))
    v = _as_dtensor(value, mesh).redistribute(mesh, vp).to_local()
    shape, offset = compute_local_shape_and_global_offset(
        cache.shape, mesh, cache.placements)
    if offset[dim] <= index < offset[dim] + shape[dim]:
        cache.to_local().select(dim, index - offset[dim]).copy_(v)


def _heads_reshape(x: torch.Tensor, shape: tuple, heads: int, dim: int
                   ) -> torch.Tensor:
    """``x.reshape(shape)`` where ``heads`` heads sit at ``x``'s dim
    ``dim`` (merged) or come out of it (split).  On a DTensor whose
    ``model``-like mesh dims cannot split ``heads`` evenly (Qwen2.5's 40
    heads, SmolLM's 9, over 16 ranks), that dim is first gathered, and
    the result's layout is pinned, so the backward's reshape also meets
    whole heads (explicit redistributes: DTensor cannot unflatten an
    uneven split, where the reference's GSPMD reshards)."""
    if not _is_dtensor(x) or all(heads % x.device_mesh.size(i) == 0
                                 for i in range(x.device_mesh.ndim)):
        return x.reshape(shape)
    from torch.distributed.tensor import Replicate
    mesh = x.device_mesh
    x = x.redistribute(mesh, [Replicate() if getattr(p, "dim", None) == dim
                              else p for p in x.placements])
    y = x.reshape(shape)
    return y.redistribute(mesh, y.placements)


def split_last(x: torch.Tensor, *sizes: int) -> torch.Tensor:
    """``x.reshape(*x.shape[:-1], *sizes)``: the last dim split into
    ``sizes[0]`` heads (:func:`_heads_reshape` on DTensors)."""
    return _heads_reshape(x, (*x.shape[:-1], *sizes), sizes[0], x.ndim - 1)


def merge_last(x: torch.Tensor) -> torch.Tensor:
    """``x.reshape(*x.shape[:-2], -1)``: heads and head dim merged
    (:func:`_heads_reshape` on DTensors)."""
    return _heads_reshape(x, (*x.shape[:-2], x.shape[-2] * x.shape[-1]),
                          x.shape[-2], x.ndim - 2)


def local_map(fn, args: tuple, dims: list, out_dims: list | tuple):
    """``fn(*args)``; on DTensors, ``fn`` on each rank's shards.

    For work whose steps are independent across a batch dim and a
    channel (head) dim: attention, and the RWKV and Mamba scans.
    ``dims[i]`` names ``args[i]``'s (batch dim, channel dim), ``None``
    where it has none (a ``None`` argument passes through); ``out_dims``
    names the outputs' (one pair: ``fn`` returns a tensor; a list of
    pairs: a tuple).  The mesh dims that split the first argument's batch
    dim keep splitting it; each other mesh dim splits the channel dims if
    every argument's channel dim divides evenly, else nothing.  Every
    tensor argument is redistributed to that layout (an explicit
    redistribute; each other dim gathered), ``fn`` runs on the local
    tensors — its ops then touch no other rank, where DTensor would
    dispatch each of them — and the outputs are wrapped in the same
    layout."""
    tensors = [a for a in args if _is_dtensor(a)]
    if not tensors:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = tensors[0].device_mesh
    first = _as_dtensor(args[0], mesh)
    role: list = []
    split = {0: 1, 1: 1}
    for m, p in enumerate(first.placements):
        n = mesh.size(m)
        if (dims[0][0] is not None and isinstance(p, Shard)
                and p.dim == dims[0][0]
                and first.shape[dims[0][0]] % (split[0] * n) == 0):
            split[0] *= n
            role.append(0)
        elif n > 1 and all(
                d[1] is None or a.shape[d[1]] % (split[1] * n) == 0
                for a, d in zip(args, dims) if a is not None) and any(
                d[1] is not None for d in dims):
            split[1] *= n
            role.append(1)
        else:
            role.append(None)

    def layout(d: tuple) -> list:
        return [Shard(d[r]) if r is not None and d[r] is not None
                else Replicate() for r in role]

    local = [_as_dtensor(a, mesh).redistribute(mesh, layout(d)).to_local()
             if isinstance(a, torch.Tensor) else a
             for a, d in zip(args, dims)]
    outs = fn(*local)
    if isinstance(out_dims, tuple):
        return DTensor.from_local(outs, mesh, layout(out_dims),
                                  run_check=False)
    return tuple(None if o is None else
                 DTensor.from_local(o, mesh, layout(d), run_check=False)
                 for o, d in zip(outs, out_dims))
