"""State-space sequence mixers: Mamba-1 (Jamba) and RWKV-6 "Finch".

The port of the reference's ``models/ssm.py``.  Both recurrences are
loop-carried SCCs in the paper's terms: the state update
``h_t = f(h_{t-1}, x_t)`` is a dependence cycle that Algorithm 1 keeps
inside one stage.  The reference computes them outside any Pallas
kernel, so plain PyTorch is their port: loops over time (or chunks) of
tensor ops on the port's device.  The WKV recurrence and Mamba's
sequential scan are the reference's ``jax.lax.scan`` over the time-major
inputs as :func:`repro_torch.core.cdfg.scan` (a Python loop on tensors;
one ``scan`` equation, its body a sub-graph, when a train step is
traced and differentiated).

Two Mamba scans, by ``cfg.ssm.scan_impl``:

* ``sequential`` — a scan over time with O(B·d_inner·N) state; the
  default and the decode path;
* ``chunked``    — a scan over chunks with an in-chunk parallel prefix
  (materializes (B, chunk, chunk, d_inner, N) per chunk), the
  reference's ``jax.lax.scan`` over the chunk-major inputs as
  :func:`repro_torch.core.cdfg.scan`.

Prompts are padded on the right by the server, so the state a prefill
hands to decode has seen the padding, as the reference's does.
"""

from __future__ import annotations

import functools

import torch
import torch.fx as fx
import torch.nn.functional as F

from . import layers
from ..core import cdfg
from ..runtime.sharding import constrain_residual


# ---------------------------------------------------------------------------
# Mamba-1 (selective SSM) — arXiv:2312.00752 as used by Jamba (2403.19887)
# ---------------------------------------------------------------------------

def mamba_init(gen: torch.Generator, cfg, device: torch.device) -> dict:
    s, d, dt = cfg.ssm, cfg.d_model, cfg.torch_dtype
    d_in = s.d_inner
    A = torch.arange(1, s.d_state + 1, dtype=torch.float32,
                     device=device).expand(d_in, s.d_state)
    return {
        "w_in": layers._dense_init(gen, d, 2 * d_in, dt, device),
        "conv_w": (layers._normal(gen, (s.d_conv, d_in)) * 0.1).to(device,
                                                                    dt),
        "conv_b": torch.zeros(d_in, dtype=dt, device=device),
        "w_x": layers._dense_init(gen, d_in, s.dt_rank + 2 * s.d_state, dt,
                                  device),
        "w_dt": layers._dense_init(gen, s.dt_rank, d_in, dt, device),
        "dt_bias": torch.zeros(d_in, dtype=torch.float32, device=device),
        "A_log": torch.log(A).contiguous(),
        "D": torch.ones(d_in, dtype=torch.float32, device=device),
        "w_out": layers._dense_init(gen, d_in, d, dt, device),
    }


def _causal_conv1d(x, w, b, state=None):
    """x: (B, L, d_in); w: (K, d_in) depthwise.  state: (B, K-1, d_in)
    carries the last K−1 inputs for decode."""
    K = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(K))
    new_state = xp[:, -(K - 1):, :] if K > 1 else None
    return out + b, new_state


def _conv(x, params, state=None):
    """:func:`_causal_conv1d` with the layer's weights; channels are
    independent, so on DTensors each rank convolves its own (the pad
    along the sequence is local)."""
    return layers.local_map(
        _causal_conv1d, (x, params["conv_w"], params["conv_b"], state),
        [(0, 2), (None, 1), (None, 0), (0, 2)], [(0, 2), (0, 2)])


def _selective_step(dt_t, A, b_t, c_t, x_t, h):
    """One step of the selective scan.  dt_t,x_t: (B,dI); A: (dI,N);
    b_t,c_t: (B,N); h: the state (B,dI,N).  Returns y (B,dI) and h."""
    da = torch.exp(dt_t[:, :, None] * A)                   # (B, dI, N)
    h = da * h + (dt_t * x_t)[..., None] * b_t[:, None, :]
    return (h * c_t[:, None, :]).sum(-1), h


def _selective_scan_seq(dt, A, Bc, Cc, x):
    """Sequential scan.  dt,x: (B,L,dI); A: (dI,N); Bc,Cc: (B,L,N).  The
    reference's ``jax.lax.scan`` over the time-major inputs, the state
    the carry (:func:`repro_torch.core.cdfg.scan`: a loop over time on
    tensors, one ``scan`` equation when traced)."""
    B, _, dI = x.shape
    h0 = torch.zeros((B, dI, A.shape[1]), dtype=torch.float32,
                     device=x.device)

    def step(consts, carry, row):
        dt_t, b_t, c_t, x_t = row
        y, h = _selective_step(dt_t, consts[0], b_t, c_t, x_t, carry[0])
        return (h,), (y,)
    (h,), (ys,) = cdfg.scan(step, (h0,), (dt.transpose(0, 1),
                                          Bc.transpose(0, 1),
                                          Cc.transpose(0, 1),
                                          x.transpose(0, 1)), (A,))
    # batch-major in memory too: ``y @ w_out`` then folds the batch into
    # one product, as it did on the loop's stack (a strided ``y`` takes a
    # batched product, which rounds otherwise on the card)
    return ys.transpose(0, 1).contiguous(), h              # (B,L,dI), h


def _decayed_carry(decay: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The carried state decayed to each position of the chunk: the
    reference's ``jnp.einsum("bcin,bin->bcin", decay, h)``, a product
    over no contracted axis, which a traced step lowers as ``jnp.einsum``
    does; on tensors the broadcast product it equals (``torch.einsum``
    might take a batched product, which rounds otherwise on the card)."""
    if isinstance(decay, fx.Proxy):
        return torch.einsum("bcin,bin->bcin", decay, h)
    return decay * h[:, None]


def _chunk_step(consts, carry, row):
    """One chunk of the chunked scan: the reference's ``chunk_step``,
    the state the carry and ``A`` a const.  dtc,xc: (B,c,dI); bcc,ccc:
    (B,c,N); h: (B,dI,N)."""
    A, = consts
    h, = carry
    dtc, bcc, ccc, xc = row
    chunk = dtc.shape[1]
    # log-decay prefix within the chunk
    cum = torch.cumsum(dtc[..., None] * A, dim=1)          # (B,c,dI,N)
    # the carried state's contribution to each position
    h_part = _decayed_carry(torch.exp(cum), h)
    # pairwise within-chunk contributions j → i (j <= i):
    # decay(i, j) = exp(cum_i − cum_j)
    contrib = (dtc * xc)[..., None] * bcc[:, :, None, :]
    dec = torch.exp(cum[:, :, None] - cum[:, None])        # (B,c,c,dI,N)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=dtc.device))
    dec = torch.where(mask[None, :, :, None, None], dec, 0.0)
    hs = h_part + torch.einsum("bijdn,bjdn->bidn", dec, contrib)
    y = torch.einsum("bcdn,bcn->bcd", hs, ccc)
    return (hs[:, -1],), (y,)


def _selective_scan_chunked(dt, A, Bc, Cc, x, chunk: int = 16):
    """Chunked scan: sequential over L/chunk, parallel inside the chunk via
    materialized decay products (the SSD-style formulation).  The
    reference's ``jax.lax.scan`` of ``chunk_step`` over the chunk-major
    inputs (nc, B, chunk, ·), the state the carry
    (:func:`repro_torch.core.cdfg.scan`)."""
    B, L, dI = x.shape
    N = A.shape[1]
    if L % chunk:
        raise ValueError(f"chunked scan: length {L} is not a multiple of "
                         f"the chunk {chunk}")
    nc = L // chunk
    dt_c = dt.reshape(B, nc, chunk, dI)
    Bc_c = Bc.reshape(B, nc, chunk, N)
    Cc_c = Cc.reshape(B, nc, chunk, N)
    x_c = x.reshape(B, nc, chunk, dI)
    h0 = torch.zeros((B, dI, N), dtype=torch.float32, device=x.device)
    (h,), (ys,) = cdfg.scan(_chunk_step, (h0,), (
        dt_c.transpose(0, 1), Bc_c.transpose(0, 1), Cc_c.transpose(0, 1),
        x_c.transpose(0, 1)), (A,))
    return ys.transpose(0, 1).reshape(B, L, dI), h


def mamba_apply(params: dict, x: torch.Tensor, cfg,
                return_cache: bool = False):
    s = cfg.ssm
    L = x.shape[1]
    xz = x @ params["w_in"]
    xin_raw, z = xz.chunk(2, dim=-1)
    xin, _ = _conv(xin_raw, params)
    xin = F.silu(xin.float())
    proj = (xin.to(x.dtype) @ params["w_x"]).float()
    dt, Bc, Cc = proj.split([s.dt_rank, s.d_state, s.d_state], dim=-1)
    # the product's sum over ranks settles before the per-channel bias is
    # added (on DTensors, as in the RWKV decay)
    dt = F.softplus(constrain_residual(dt @ params["w_dt"].float())
                    + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    if s.scan_impl == "chunked" and L % s.chunk == 0 and L > s.chunk:
        scan = functools.partial(_selective_scan_chunked, chunk=s.chunk)
    else:
        scan = _selective_scan_seq
    y, h_final = layers.local_map(
        scan, (dt, A, Bc, Cc, xin),
        [(0, 2), (None, 0), (0, None), (0, None), (0, 2)], [(0, 2), (0, 1)])
    y = y + params["D"] * xin
    y = y * F.silu(z.float())
    out = y.to(x.dtype) @ params["w_out"]
    if return_cache:
        K = s.d_conv
        conv_state = xin_raw[:, -(K - 1):, :].to(cfg.torch_dtype)
        return out, {"h": h_final, "conv": conv_state.contiguous()}
    return out


def mamba_init_cache(cfg, batch: int, device: torch.device) -> dict:
    s = cfg.ssm
    return {"h": torch.zeros((batch, s.d_inner, s.d_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, s.d_conv - 1, s.d_inner),
                                dtype=cfg.torch_dtype, device=device)}


def mamba_decode(params: dict, x: torch.Tensor, cache: dict,
                 cfg) -> tuple[torch.Tensor, dict]:
    """One-token step.  x: (B, 1, d)."""
    s = cfg.ssm
    xz = x @ params["w_in"]
    xin, z = xz.chunk(2, dim=-1)
    xin, conv_state = _conv(xin, params, cache["conv"])
    xin = F.silu(xin.float())[:, 0]                         # (B, dI)
    proj = (xin.to(x.dtype) @ params["w_x"]).float()
    dt, Bc, Cc = proj.split([s.dt_rank, s.d_state, s.d_state], dim=-1)
    # the product's sum over ranks settles before the per-channel bias is
    # added (on DTensors, as in the RWKV decay)
    dt = F.softplus(constrain_residual(dt @ params["w_dt"].float())
                    + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y, h = layers.local_map(
        _selective_step, (dt, A, Bc, Cc, xin, cache["h"]),
        [(0, 1), (None, 0), (0, None), (0, None), (0, 1), (0, 1)],
        [(0, 1), (0, 1)])
    y = y + params["D"] * xin
    y = y * F.silu(z.float()[:, 0])
    out = (y.to(x.dtype) @ params["w_out"])[:, None, :]
    return out, {"h": h, "conv": conv_state}


# ---------------------------------------------------------------------------
# RWKV-6 "Finch" — arXiv:2404.05892 (data-dependent decay)
# ---------------------------------------------------------------------------

def rwkv6_init(gen: torch.Generator, cfg, device: torch.device) -> dict:
    d, H, dt = cfg.d_model, cfg.rwkv_heads, cfg.torch_dtype
    hd = d // H
    lora = cfg.rwkv_decay_lora

    def half():
        return torch.full((d,), 0.5, dtype=dt, device=device)

    return {
        # token-shift mix coefficients (per channel)
        "mu_r": half(), "mu_k": half(), "mu_v": half(), "mu_w": half(),
        "mu_g": half(),
        "w_r": layers._dense_init(gen, d, d, dt, device),
        "w_k": layers._dense_init(gen, d, d, dt, device),
        "w_v": layers._dense_init(gen, d, d, dt, device),
        "w_g": layers._dense_init(gen, d, d, dt, device),
        "w_o": layers._dense_init(gen, d, d, dt, device),
        # data-dependent decay LoRA: w_t = exp(-exp(w0 + tanh(x A) B))
        "decay_w0": torch.full((d,), -6.0, dtype=torch.float32,
                               device=device),
        "decay_A": layers._dense_init(gen, d, lora, dt, device),
        "decay_B": layers._dense_init(gen, lora, d, dt, device),
        "bonus_u": (layers._normal(gen, (H, hd)) * 0.1).to(device),
        "ln_x": layers.layernorm_init(d, dt, device),
    }


def _token_shift(x, prev=None):
    """RWKV token shift: x_{t-1} (zeros / carried state at t=0)."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _rwkv_mix(x, xs, mu):
    return x + (xs - x) * mu


def _rwkv_projections(params, x, xs):
    """Receptance, key, value, gate and the fp32 decay of ``x`` shifted
    by ``xs``."""
    r = _rwkv_mix(x, xs, params["mu_r"]) @ params["w_r"]
    k = _rwkv_mix(x, xs, params["mu_k"]) @ params["w_k"]
    v = _rwkv_mix(x, xs, params["mu_v"]) @ params["w_v"]
    g = _rwkv_mix(x, xs, params["mu_g"]) @ params["w_g"]
    xw = _rwkv_mix(x, xs, params["mu_w"])
    # the LoRA's sum over ranks settles before the per-channel offset is
    # added (on DTensors: torch 2.11 cannot add a sharded offset to a
    # partial sum)
    lora = constrain_residual(torch.tanh((xw @ params["decay_A"]).float())
                              @ params["decay_B"].float())
    w = params["decay_w0"] + lora
    return r, k, v, g, torch.exp(-torch.exp(w))


def _rwkv_out(params, y, g, x):
    y = layers.layernorm_apply(params["ln_x"], y.to(x.dtype))
    y = y * F.silu(g.float()).to(x.dtype)
    return y @ params["w_o"]


def _rwkv_step(r_t, k_t, v_t, w_t, u, S):
    """One step of the WKV recurrence.  r,k,v,w: (B, H, hd) (r,k,v fp32);
    u: (H, hd); S: the state (B, H, hd, hd).  Returns y (B, H, hd) and
    the new state."""
    kv = k_t[..., None] * v_t[..., None, :]                 # (B,H,hd,hd)
    y = torch.einsum("bhk,bhkv->bhv", r_t, S + u[..., None] * kv)
    return y, w_t[..., None] * S + kv


def _rwkv_scan(rh, kh, vh, wh, u):
    """The WKV recurrence over L from a zero state.  r,k,v,w: (B, L, H,
    hd); u: (H, hd).  Returns y (B, L, H, hd) and the final state: the
    reference's ``jax.lax.scan`` over the time-major inputs, ``u`` a
    const (:func:`repro_torch.core.cdfg.scan`)."""
    B, _, H, hd = rh.shape
    S0 = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=rh.device)

    def step(consts, carry, row):
        y, S = _rwkv_step(*row, consts[0], carry[0])
        return (S,), (y,)
    (S,), (ys,) = cdfg.scan(step, (S0,), tuple(
        t.transpose(0, 1) for t in (rh, kh, vh, wh)), (u,))
    return ys.transpose(0, 1).contiguous(), S    # batch-major, as Mamba's


def rwkv6_apply(params: dict, x: torch.Tensor, cfg,
                return_cache: bool = False):
    B, L, d = x.shape
    H = cfg.rwkv_heads
    hd = d // H
    r, k, v, g, w = _rwkv_projections(params, x, _token_shift(x))
    rh = r.reshape(B, L, H, hd).float()
    kh = k.reshape(B, L, H, hd).float()
    vh = v.reshape(B, L, H, hd).float()
    wh = w.reshape(B, L, H, hd)
    y, S = layers.local_map(_rwkv_scan, (rh, kh, vh, wh, params["bonus_u"]),
                            [(0, 2)] * 4 + [(None, 0)], [(0, 2), (0, 1)])
    y = y.reshape(B, L, d)
    out = _rwkv_out(params, y, g, x)
    if return_cache:
        return out, {"S": S, "x_prev": x[:, -1:, :]}
    return out


def rwkv6_init_cache(cfg, batch: int, device: torch.device) -> dict:
    d, H = cfg.d_model, cfg.rwkv_heads
    hd = d // H
    return {"S": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                             device=device),
            "x_prev": torch.zeros((batch, 1, d), dtype=cfg.torch_dtype,
                                  device=device)}


def rwkv6_decode(params: dict, x: torch.Tensor, cache: dict,
                 cfg) -> tuple[torch.Tensor, dict]:
    B, _, d = x.shape
    H = cfg.rwkv_heads
    hd = d // H
    r, k, v, g, w = _rwkv_projections(params, x, cache["x_prev"])
    y, S = layers.local_map(
        _rwkv_step, (r.reshape(B, H, hd).float(), k.reshape(B, H, hd).float(),
                     v.reshape(B, H, hd).float(), w.reshape(B, H, hd),
                     params["bonus_u"], cache["S"]),
        [(0, 1)] * 4 + [(None, 0), (0, 1)], [(0, 1), (0, 1)])
    return _rwkv_out(params, y.reshape(B, 1, d), g, x), {"S": S,
                                                         "x_prev": x}
