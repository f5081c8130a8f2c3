"""Attention: GQA/MHA/MQA with RoPE + KV cache, and MLA (DeepSeek-V3).

The port of the reference's ``models/attention.py``.  Three
implementations of GQA attention, selected by ``cfg.attn_impl``:

* ``"full"``    — materialized S×S logits (oracle; small configs only);
* ``"chunked"`` — online softmax streamed over KV chunks in plain
  PyTorch, memory O(S·d) per step;
* ``"pallas"``  — the hand-written CUDA kernels of
  ``kernels/flash_attention.py`` (the reference's Pallas kernels' name
  is kept so a config selects the same path in both packages).

The KV-cache decode step is the canonical "memory operation" of the
paper's classification: a data-dependent HBM stream (the cache) feeding
a small amount of compute.  Unlike the reference's functional update,
:func:`gqa_decode` and :func:`mla_decode` append the new entries (and,
in an int8 cache, their scales) to the cache in place and return the
same tensors, so decoding allocates no new cache.

``kv_cache_dtype="int8"`` stores the GQA cache as per-vector symmetric
int8 codes with float16 scales; its decode dequantizes chunk by chunk in
plain PyTorch, as the reference's does outside its Pallas kernel.  MLA
never calls a kernel, in the reference or here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import layers
from ..kernels import ops as kops


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


def _chunked_attention(q, k, v, *, causal: bool, chunk: int = 1024,
                       q_offset: int = 0):
    """Online softmax over KV chunks (flash attention in plain PyTorch).
    Head dims may differ between q/k (d) and v (dv) — MLA uses 192/128."""
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    group = H // Hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    qi = torch.arange(Sq, device=q.device) + q_offset
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


def _full_attention(q, k, v, *, causal: bool, q_offset: int = 0):
    group = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    Sq, d = q.shape[2], q.shape[3]
    Sk = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + q_offset
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
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(params, x, cfg, positions)
    out = _attend(q, k, v, cfg).transpose(1, 2).reshape(B, S, -1)
    pad = (0, 0, 0, max_len - S)
    if cfg.kv_cache_dtype == "int8":
        kq, ks = _kv_quantize(k)
        vq, vs = _kv_quantize(v)
        cache = {"k": F.pad(kq, pad).contiguous(),
                 "v": F.pad(vq, pad).contiguous(),
                 "k_scale": F.pad(ks, pad).contiguous(),
                 "v_scale": F.pad(vs, pad).contiguous()}
    else:
        cache = {"k": F.pad(k, pad).to(cfg.torch_dtype).contiguous(),
                 "v": F.pad(v, pad).to(cfg.torch_dtype).contiguous()}
    return out @ params["w_o"], cache


def _kv_quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-vector symmetric int8: x (..., hd) → (int8, f16 scale (..., 1)).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = scale.clamp_min(1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float16)


def _kv_dequantize(q: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale.float()).to(dtype)


def gqa_init_cache(cfg, batch: int, max_len: int,
                   device: torch.device) -> dict:
    shape = (batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        # int8 halves decode's dominant HBM stream (the cache read);
        # per-vector f16 scales add 2 bytes per vector
        sshape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, dtype=torch.float16,
                                       device=device),
                "v_scale": torch.zeros(sshape, dtype=torch.float16,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


def gqa_decode(params: dict, x: torch.Tensor, cache: dict, length: int,
               cfg) -> tuple[torch.Tensor, dict]:
    """One-token decode: append to the cache, attend over the valid prefix.

    x: (B, 1, d); length: tokens already in the cache.  The new key and
    value (int8 codes and their scales in an int8 cache) are written into
    ``cache`` in place at ``length``, or into its last slot once the
    cache is full, where the reference's ``dynamic_update_slice`` clamps
    its start; the position and the attended length stay ``length``.
    """
    B = x.shape[0]
    positions = torch.full((B, 1), length, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions)
    lengths = torch.full((B,), length + 1, dtype=torch.int32,
                         device=x.device)
    slot = min(length, cache["k"].shape[2] - 1)
    if cfg.kv_cache_dtype == "int8":
        for name, t in (("k", k), ("v", v)):
            codes, scale = _kv_quantize(t)
            cache[name][:, :, slot] = codes[:, :, 0]
            cache[name + "_scale"][:, :, slot] = scale[:, :, 0]
        out = _decode_chunked(q[:, :, 0], cache["k"], cache["v"], lengths,
                              k_scale=cache["k_scale"],
                              v_scale=cache["v_scale"])
        return out.reshape(B, 1, -1) @ params["w_o"], cache
    # append new k/v at `length` (the decoupled cache write stage)
    cache["k"][:, :, slot] = k[:, :, 0].to(cache["k"].dtype)
    cache["v"][:, :, slot] = v[:, :, 0].to(cache["v"].dtype)
    if cfg.attn_impl == "pallas":
        out = kops.decode_attention(q[:, :, 0], cache["k"], cache["v"],
                                    lengths)
    else:
        out = _decode_chunked(q[:, :, 0], cache["k"], cache["v"], lengths)
    out = out.reshape(B, 1, -1)
    return out @ params["w_o"], cache


def _decode_chunked(q, k_cache, v_cache, lengths, chunk: int = 2048,
                    k_scale=None, v_scale=None):
    """(B,H,d) vs (B,Hkv,S,d) ragged cache — streamed online softmax.
    Optional per-vector scales dequantize an int8 cache chunk by chunk."""
    S = k_cache.shape[2]
    return _decode_masked_scan(q, k_cache, v_cache, lengths,
                               chunk=min(chunk, S), k_scale=k_scale,
                               v_scale=v_scale)


def _decode_masked_scan(q, k_cache, v_cache, lengths, chunk: int,
                        k_scale=None, v_scale=None):
    B, H, d = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    group = H // Hkv
    scale = 1.0 / math.sqrt(d)
    qf = q.float()
    m = torch.full((B, H), -1e30, device=q.device)
    l = torch.zeros((B, H), device=q.device)
    acc = torch.zeros((B, H, d), device=q.device)
    for c0 in range(0, S, chunk):
        kb = k_cache[:, :, c0:c0 + chunk]
        vb = v_cache[:, :, c0:c0 + chunk]
        if k_scale is not None:
            kb = _kv_dequantize(kb, k_scale[:, :, c0:c0 + chunk],
                                torch.float32)
            vb = _kv_dequantize(vb, v_scale[:, :, c0:c0 + chunk],
                                torch.float32)
        kb = kb.repeat_interleave(group, 1).float()
        vb = vb.repeat_interleave(group, 1).float()
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


# ---------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (DeepSeek-V2/V3, arXiv:2412.19437)
# ---------------------------------------------------------------------------
#
# The cache stores only the compressed latent c_kv (kv_lora_rank) and the
# decoupled RoPE key (rope_head_dim): the memory stage shrinks by about an
# order of magnitude, the paper's "customize the memory interface per
# access stream" (§III-B2) applied to the KV cache.

def mla_init(gen: torch.Generator, cfg, device: torch.device) -> dict:
    m, d, H, dt = cfg.mla, cfg.d_model, cfg.num_heads, cfg.torch_dtype
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    return {
        "w_dq": layers._dense_init(gen, d, m.q_lora_rank, dt, device),
        "q_norm": layers.rmsnorm_init(m.q_lora_rank, dt, device),
        "w_uq": layers._dense_init(gen, m.q_lora_rank, H * qk_head, dt,
                                   device),
        "w_dkv": layers._dense_init(
            gen, d, m.kv_lora_rank + m.qk_rope_head_dim, dt, device),
        "kv_norm": layers.rmsnorm_init(m.kv_lora_rank, dt, device),
        "w_ukv": layers._dense_init(
            gen, m.kv_lora_rank, H * (m.qk_nope_head_dim + m.v_head_dim),
            dt, device),
        "w_o": layers._dense_init(gen, H * m.v_head_dim, d, dt, device),
    }


def _mla_qkv(params, x, cfg, positions):
    m = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    # query path
    cq = layers.rmsnorm_apply(params["q_norm"], x @ params["w_dq"])
    q = (cq @ params["w_uq"]).reshape(
        B, S, H, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_pe = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    q_pe = layers.apply_rope(q_pe.transpose(1, 2), positions[:, None, :],
                             cfg.rope_theta).transpose(1, 2)
    # kv latent path
    ckv_full = x @ params["w_dkv"]
    c_kv, k_pe = ckv_full.split([m.kv_lora_rank, m.qk_rope_head_dim], -1)
    c_kv = layers.rmsnorm_apply(params["kv_norm"], c_kv)
    k_pe = layers.apply_rope(k_pe[:, None], positions[:, None, :],
                             cfg.rope_theta)[:, 0]
    return q_nope, q_pe, c_kv, k_pe


def _mla_attend(params, q_nope, q_pe, c_kv, k_pe, cfg, *, causal,
                q_offset: int = 0):
    m = cfg.mla
    B, Sq, H, _ = q_nope.shape
    kv = (c_kv @ params["w_ukv"]).reshape(
        c_kv.shape[0], c_kv.shape[1], H, m.qk_nope_head_dim + m.v_head_dim)
    k_nope, v = kv.split([m.qk_nope_head_dim, m.v_head_dim], -1)
    qh = torch.cat([q_nope, q_pe], -1).transpose(1, 2)
    kh = torch.cat(
        [k_nope, k_pe[:, :, None].expand(*k_nope.shape[:2], H,
                                         m.qk_rope_head_dim)],
        -1).transpose(1, 2)
    vh = v.transpose(1, 2)
    if cfg.attn_impl in ("chunked", "auto") and qh.shape[2] > 2048:
        out = _chunked_attention(qh, kh, vh, causal=causal,
                                 q_offset=q_offset)
    else:
        out = _full_attention(qh, kh, vh, causal=causal, q_offset=q_offset)
    out = out.transpose(1, 2).reshape(B, Sq, H * m.v_head_dim)
    return out @ params["w_o"]


def mla_apply(params: dict, x: torch.Tensor, cfg, *,
              positions: torch.Tensor | None = None) -> torch.Tensor:
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device).expand(B, S)
    q_nope, q_pe, c_kv, k_pe = _mla_qkv(params, x, cfg, positions)
    return _mla_attend(params, q_nope, q_pe, c_kv, k_pe, cfg, causal=True)


def mla_prefill(params: dict, x: torch.Tensor, cfg, max_len: int
                ) -> tuple[torch.Tensor, dict]:
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q_nope, q_pe, c_kv, k_pe = _mla_qkv(params, x, cfg, positions)
    out = _mla_attend(params, q_nope, q_pe, c_kv, k_pe, cfg, causal=True)
    pad = (0, 0, 0, max_len - S)
    cache = {"c_kv": F.pad(c_kv, pad).to(cfg.torch_dtype).contiguous(),
             "k_pe": F.pad(k_pe, pad).to(cfg.torch_dtype).contiguous()}
    return out, cache


def mla_init_cache(cfg, batch: int, max_len: int,
                   device: torch.device) -> dict:
    m, dt = cfg.mla, cfg.torch_dtype
    return {"c_kv": torch.zeros((batch, max_len, m.kv_lora_rank), dtype=dt,
                                device=device),
            "k_pe": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                                dtype=dt, device=device)}


def mla_decode(params: dict, x: torch.Tensor, cache: dict, length: int,
               cfg) -> tuple[torch.Tensor, dict]:
    """One-token decode; the latent and RoPE key are written into
    ``cache`` in place at ``length`` (the last slot once the cache is
    full, as in :func:`gqa_decode`)."""
    B = x.shape[0]
    positions = torch.full((B, 1), length, device=x.device)
    q_nope, q_pe, c_kv, k_pe = _mla_qkv(params, x, cfg, positions)
    slot = min(length, cache["c_kv"].shape[1] - 1)
    cache["c_kv"][:, slot] = c_kv[:, 0].to(cache["c_kv"].dtype)
    cache["k_pe"][:, slot] = k_pe[:, 0].to(cache["k_pe"].dtype)
    if cfg.mla_absorbed:
        out = _mla_decode_absorbed(params, q_nope, q_pe, cache["c_kv"],
                                   cache["k_pe"], length, cfg)
    else:
        # naive: decompress the whole cache and attend (baseline)
        out = _mla_attend(params, q_nope, q_pe, cache["c_kv"],
                          cache["k_pe"], cfg, causal=True, q_offset=length)
    return out, cache


def _mla_decode_absorbed(params, q_nope, q_pe, c_cache, p_cache,
                         length: int, cfg) -> torch.Tensor:
    """Absorbed MLA decode (DeepSeek-V2 §Inference): W_uk folds into the
    query and W_uv into the output, so attention runs in the compressed
    latent space and the per-step decompression of the cache disappears.
    The same linear algebra as the naive path, reassociated."""
    m = cfg.mla
    B, _, H, _ = q_nope.shape
    S = c_cache.shape[1]
    r = m.kv_lora_rank
    w_ukv = params["w_ukv"].reshape(r, H, m.qk_nope_head_dim + m.v_head_dim)
    w_uk = w_ukv[:, :, :m.qk_nope_head_dim]          # (r, H, nope)
    w_uv = w_ukv[:, :, m.qk_nope_head_dim:]          # (r, H, v)
    # absorb: q_lat (B, H, r) = q_nope · W_uk^T
    q_lat = torch.einsum("bqhn,rhn->bhr", q_nope.float(), w_uk.float())
    cf = c_cache.float()                             # (B, S, r)
    pf = p_cache.float()                             # (B, S, rope)
    scale = 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)
    logits = (torch.einsum("bhr,bsr->bhs", q_lat, cf)
              + torch.einsum("bqhp,bsp->bhs", q_pe.float(), pf)) * scale
    mask = torch.arange(S, device=cf.device)[None, None, :] <= length
    logits = torch.where(mask, logits, -1e30)
    w = torch.softmax(logits, dim=-1)                # (B, H, S)
    o_lat = torch.einsum("bhs,bsr->bhr", w, cf)      # (B, H, r)
    out = torch.einsum("bhr,rhv->bhv", o_lat, w_uv.float())
    out = out.reshape(B, 1, H * m.v_head_dim).to(q_nope.dtype)
    return out @ params["w_o"]
