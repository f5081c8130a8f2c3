"""Attention: GQA/MHA/MQA with RoPE and a KV cache.

The port of the GQA half of the reference's ``models/attention.py``.
Three implementations, selected by ``cfg.attn_impl``:

* ``"full"``    — materialized S×S logits (oracle; small configs only);
* ``"chunked"`` — online softmax streamed over KV chunks in plain
  PyTorch, memory O(S·d) per step;
* ``"pallas"``  — the hand-written CUDA kernels of
  ``kernels/flash_attention.py`` (the reference's Pallas kernels' name
  is kept so a config selects the same path in both packages).

The KV-cache decode step is the canonical "memory operation" of the
paper's classification: a data-dependent HBM stream (the cache) feeding
a small amount of compute.  Unlike the reference's functional update,
:func:`gqa_decode` appends the new key and value to the cache in place
and returns the same tensors, so decoding allocates no new cache.

MLA and the int8 KV cache wait for a later slice (ROADMAP: "The rest of
the model stack").
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import layers
from ..kernels import ops as kops

def _check_supported(cfg) -> None:
    if cfg.kv_cache_dtype == "int8":
        raise NotImplementedError(
            "the int8 KV cache (kv_cache_dtype='int8') is not ported yet "
            "(ROADMAP: \"The rest of the model stack\")")


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------

def gqa_init(gen: torch.Generator, cfg, device: torch.device) -> dict:
    d, hd, dt = cfg.d_model, cfg.head_dim, cfg.torch_dtype
    p = {
        "w_q": layers._dense_init(gen, d, cfg.num_heads * hd, dt, device),
        "w_k": layers._dense_init(gen, d, cfg.num_kv_heads * hd, dt, device),
        "w_v": layers._dense_init(gen, d, cfg.num_kv_heads * hd, dt, device),
        "w_o": layers._dense_init(gen, cfg.num_heads * hd, d, dt, device),
    }
    if cfg.qkv_bias:
        for name, n in (("b_q", cfg.num_heads), ("b_k", cfg.num_kv_heads),
                        ("b_v", cfg.num_kv_heads)):
            p[name] = torch.zeros(n * hd, dtype=dt, device=device)
    return p


def _project_qkv(params, x, cfg, positions):
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = x @ params["w_q"]
    k = x @ params["w_k"]
    v = x @ params["w_v"]
    if cfg.qkv_bias:
        q = q + params["b_q"]
        k = k + params["b_k"]
        v = v + params["b_v"]
    q = q.reshape(B, S, cfg.num_heads, hd).transpose(1, 2)
    k = k.reshape(B, S, cfg.num_kv_heads, hd).transpose(1, 2)
    v = v.reshape(B, S, cfg.num_kv_heads, hd).transpose(1, 2)
    q = layers.apply_rope(q, positions[:, None, :], cfg.rope_theta)
    k = layers.apply_rope(k, positions[:, None, :], cfg.rope_theta)
    return q, k, v


def _chunked_attention(q, k, v, *, causal: bool, chunk: int = 1024):
    """Online softmax over KV chunks (flash attention in plain PyTorch)."""
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = H // Hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    qi = torch.arange(Sq, device=q.device)
    m = torch.full((B, H, Sq), -1e30, device=q.device)
    l = torch.zeros((B, H, Sq), device=q.device)
    acc = torch.zeros((B, H, Sq, v.shape[-1]), device=q.device)
    for c0 in range(0, Sk, chunk):
        kb = k[:, :, c0:c0 + chunk].repeat_interleave(group, dim=1).float()
        vb = v[:, :, c0:c0 + chunk].repeat_interleave(group, dim=1).float()
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb) * scale
        if causal:
            ki = torch.arange(c0, c0 + kb.shape[2], device=q.device)
            s = s.masked_fill(ki[None, :] > qi[:, None], -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_new
    return (acc / l.clamp_min(1e-20)[..., None]).to(q.dtype)


def _full_attention(q, k, v, *, causal: bool):
    group = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    Sq, d = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None]
        ki = torch.arange(Sk, device=q.device)[None, :]
        s = s.masked_fill(ki > qi, -1e30)
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)


def _attend(q, k, v, cfg):
    """Causal attention of the prompt by ``cfg.attn_impl``."""
    impl = cfg.attn_impl
    if impl == "auto":
        impl = "chunked" if q.shape[2] > 2048 else "full"
    if impl == "pallas":
        return kops.flash_attention(q, k, v, causal=True)
    if impl == "chunked":
        return _chunked_attention(q, k, v, causal=True)
    return _full_attention(q, k, v, causal=True)


def gqa_apply(params: dict, x: torch.Tensor, cfg, *,
              positions: torch.Tensor | None = None) -> torch.Tensor:
    """Training / prefill forward (causal)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(params, x, cfg, positions)
    out = _attend(q, k, v, cfg).transpose(1, 2).reshape(B, S, -1)
    return out @ params["w_o"]


def gqa_prefill(params: dict, x: torch.Tensor, cfg, max_len: int
                ) -> tuple[torch.Tensor, dict]:
    """Forward over the prompt AND build the decode cache in one pass."""
    _check_supported(cfg)
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(params, x, cfg, positions)
    out = _attend(q, k, v, cfg).transpose(1, 2).reshape(B, S, -1)
    pad = (0, 0, 0, max_len - S)
    cache = {"k": F.pad(k, pad).to(cfg.torch_dtype).contiguous(),
             "v": F.pad(v, pad).to(cfg.torch_dtype).contiguous()}
    return out @ params["w_o"], cache


def gqa_init_cache(cfg, batch: int, max_len: int,
                   device: torch.device) -> dict:
    _check_supported(cfg)
    shape = (batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


def gqa_decode(params: dict, x: torch.Tensor, cache: dict, length: int,
               cfg) -> tuple[torch.Tensor, dict]:
    """One-token decode: append to the cache, attend over the valid prefix.

    x: (B, 1, d); length: tokens already in the cache.  The new key and
    value are written into ``cache`` in place at ``length``.
    """
    _check_supported(cfg)
    B = x.shape[0]
    positions = torch.full((B, 1), length, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions)
    lengths = torch.full((B,), length + 1, dtype=torch.int32,
                         device=x.device)
    # append new k/v at `length` (the decoupled cache write stage)
    cache["k"][:, :, length] = k[:, :, 0].to(cache["k"].dtype)
    cache["v"][:, :, length] = v[:, :, 0].to(cache["v"].dtype)
    if cfg.attn_impl == "pallas":
        out = kops.decode_attention(q[:, :, 0], cache["k"], cache["v"],
                                    lengths)
    else:
        out = _decode_chunked(q[:, :, 0], cache["k"], cache["v"], lengths)
    out = out.reshape(B, 1, -1)
    return out @ params["w_o"], cache


def _decode_chunked(q, k_cache, v_cache, lengths, chunk: int = 2048):
    """(B,H,d) vs (B,Hkv,S,d) ragged cache — streamed online softmax."""
    S = k_cache.shape[2]
    return _decode_masked_scan(q, k_cache, v_cache, lengths,
                               chunk=min(chunk, S))


def _decode_masked_scan(q, k_cache, v_cache, lengths, chunk: int):
    B, H, d = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    group = H // Hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    m = torch.full((B, H), -1e30, device=q.device)
    l = torch.zeros((B, H), device=q.device)
    acc = torch.zeros((B, H, d), device=q.device)
    for c0 in range(0, S, chunk):
        kb = k_cache[:, :, c0:c0 + chunk].repeat_interleave(group, 1).float()
        vb = v_cache[:, :, c0:c0 + chunk].repeat_interleave(group, 1).float()
        s = torch.einsum("bhd,bhkd->bhk", qf, kb) * scale
        ki = torch.arange(c0, c0 + kb.shape[2], device=q.device)
        mask = ki[None, None, :] < lengths[:, None, None]
        s = torch.where(mask, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bhk,bhkd->bhd", p, vb)
        m = m_new
    return (acc / l.clamp_min(1e-20)[..., None]).to(q.dtype)
