"""Streaming attention (prefill + decode) as hand-written CUDA kernels.

Attention is the model stack's dominant "memory operation" in the
paper's sense: at decode time the KV cache read is a long HBM stream
feeding little compute.  The kernels stream K/V tiles through shared
memory (the access stage) into an online softmax in fp32 (the execute
stage): prefill reads each KV head once per query head of its group,
decode once per group.  See ``csrc/flash_attention.cu``.

Prefill has two designs, chosen by :func:`prefill_route` from the dtype:
bf16 multiplies on the tensor cores (``"mma.sync"``, P rounded to bf16
before P·V, as SDPA does), fp32 on the CUDA cores (``"cuda-core fp32"``,
the serving path's exactness check).

Decode runs one thread-block cluster per (sequence, kv head): its C CTAs
split the valid keys into C contiguous ranges, stream each range's K and
V through a bulk-copy ring once for the query heads of the group (the
whole group up to 4 heads, else 8 at a time), and each rank pushes its
(m, l, acc) into rank 0's shared memory (distributed shared memory),
where rank 0 combines them, all in one launch.  :func:`decode_split`
chooses C before the launch, from the shapes and the SM count.

A CPU tensor takes the plain version (:func:`ref.flash_attention_ref`,
:func:`ref.decode_attention_ref`); a CUDA tensor launches the kernel or
raises.  Padding to blocks is the caller's (:mod:`.ops`).
"""

from __future__ import annotations

import math

import torch

from . import _lib, ref

_SUFFIX = {torch.bfloat16: "bf16", torch.float32: "f32"}

MMA = "mma.sync"
CUDA_CORE = "cuda-core fp32"

#: keys per stage of the decode kernel's ring (``kDecodeTile``)
DECODE_TILE = 64
#: the most CTAs of one cluster that every Hopper card schedules
MAX_CLUSTER = 8


def prefill_route(dtype: torch.dtype) -> str:
    """The prefill design a CUDA launch takes: every bf16 shape the kernels
    take (d a multiple of 8 in [8, 128]) runs on the tensor cores, fp32 on
    the CUDA cores."""
    return MMA if dtype == torch.bfloat16 else CUDA_CORE


def decode_split(B: int, Hkv: int, S: int, sm_count: int) -> int:
    """CTAs per cluster of the decode kernel (one cluster per sequence and
    kv head): the fewest, in powers of two, whose ``B * Hkv * C`` CTAs
    fill ``sm_count`` SMs, while each CTA keeps at least one tile of
    ``S`` (``C * DECODE_TILE <= S``), and never more than ``MAX_CLUSTER``.
    The lengths stay on the card, so the split sees the cache's capacity
    ``S``, not the valid keys."""
    c = 1
    while c < MAX_CLUSTER and B * Hkv * c < sm_count:
        c *= 2
    while c > 1 and c * DECODE_TILE > S:
        c //= 2
    return c


def decode_design(c: int) -> str:
    """The name ``_lib.ROUTES`` counts a decode launch under."""
    return f"cluster split-S ×{c}"


def _check_cuda(name: str, tensors: dict[str, torch.Tensor],
                d: int) -> None:
    """Raise unless the kernel takes these CUDA tensors as they are."""
    first = next(iter(tensors.values()))
    if first.device.type != "cuda" or any(
            t.device != first.device for t in tensors.values()):
        raise ValueError(f"{name}: {', '.join(tensors)} must all lie on one "
                         f"CUDA device (or all on the CPU)")
    if first.dtype not in _SUFFIX or any(
            t.dtype != first.dtype for t in tensors.values()):
        raise TypeError(f"{name} kernel takes bfloat16 or float32 tensors of "
                        f"one dtype, got "
                        f"{[str(t.dtype) for t in tensors.values()]}")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors.values()):
        raise ValueError(f"{name} kernel takes contiguous, 16-byte-aligned "
                         f"tensors")
    if d % 8 or not 8 <= d <= 128:
        raise ValueError(f"{name} kernel takes a head dim that is a multiple "
                         f"of 8 in [8, 128], got {d}")


def _check_heads(name: str, hq: int, hkv: int) -> None:
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{name}: {hq} query heads are not a multiple of "
                         f"{hkv} kv heads")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """GQA prefill attention.

    q: (B, Hq, Sq, d); k, v: (B, Hkv, Sk, d); returns (B, Hq, Sq, d) in
    q's dtype.  Query head h reads kv head ``h // (Hq // Hkv)``; the
    causal mask aligns query and key positions from 0.
    """
    _lib.forbid_autograd("flash_attention", q, k, v)
    B, Hq, Sq, d = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not match")
    Hkv, Sk = k.shape[1], k.shape[2]
    _check_heads("flash_attention", Hq, Hkv)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)
    _check_cuda("flash_attention", {"q": q, "k": k, "v": v}, d)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    design = prefill_route(q.dtype)
    entry = "flash_attention_bf16" if design == MMA else \
        "flash_attention_f32"
    with torch.cuda.device(q.device):
        err = getattr(_lib.lib("flash_attention"), entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            Hkv, Sq, Sk, d, scale, int(causal), _lib.stream())
        _lib.LAUNCHES["flash_attention"] += 1
        _lib.ROUTES["flash_attention"][design] += 1
    _lib.check("flash_attention", err)
    return out


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     scale: float | None = None) -> torch.Tensor:
    """One-token GQA decode attention over a ragged cache.

    q: (B, Hq, d); caches: (B, Hkv, S, d); lengths: (B,) int32 on the
    caches' device, each in [0, S].  Positions at or past a sequence's
    length are masked; a length of 0 gives zeros.  Returns (B, Hq, d).
    """
    _lib.forbid_autograd("decode_attention", q, k_cache, v_cache)
    B, Hq, d = q.shape
    if k_cache.ndim != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != B or k_cache.shape[3] != d \
            or lengths.shape != (B,):
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)} / {tuple(v_cache.shape)}, "
                         f"lengths {tuple(lengths.shape)} do not match")
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    _check_heads("decode_attention", Hq, Hkv)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, lengths,
                                        scale=scale)
    _check_cuda("decode_attention", {"q": q, "k_cache": k_cache,
                                     "v_cache": v_cache}, d)
    if lengths.device != q.device or lengths.dtype != torch.int32 \
            or not lengths.is_contiguous():
        raise TypeError("decode_attention kernel takes contiguous int32 "
                        "lengths on the caches' device")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    c = decode_split(B, Hkv, S, sms)
    with torch.cuda.device(q.device):
        err = getattr(_lib.lib("decode_attention"),
                      f"decode_attention_{_SUFFIX[q.dtype]}")(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, Hq, Hkv, S, d, scale, c,
            _lib.stream())
        _lib.LAUNCHES["decode_attention"] += 1
        _lib.ROUTES["decode_attention"][decode_design(c)] += 1
    _lib.check("decode_attention", err)
    return out
