"""Shared model layers: norms, rotary embeddings, MLPs, embeddings.

The port of the reference's ``models/layers.py``.  Plain functions over
a params dict whose keys mirror the reference's tree: every layer is
``apply(params, x, ...) -> y`` with a matching ``init(gen, ...) ->
params``.  Inits draw from an explicit ``torch.Generator`` (on the
generator's device) and place the result on ``device``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.ref import rmsnorm_ref


def _normal(gen: torch.Generator, shape: tuple[int, ...]) -> torch.Tensor:
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


def embedding_apply(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def unembed_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Logits in fp32 (loss numerics)."""
    return torch.einsum("...d,vd->...v", x.float(), params["table"].float())
