"""Mixture-of-Experts with top-k routing, shared experts, capacity dispatch.

The port of the reference's ``models/moe.py``.  MoE dispatch is the
model stack's second "memory operation" in the paper's taxonomy: a
data-dependent scatter (tokens → expert buffers), the expert GEMMs as
the long-latency compute stage, then a gather (expert outputs → token
order).

Dispatch is sort-free: each (token, choice) pair takes the next slot of
its expert, counted in token-major ``(T, k)`` order, up to the capacity
``C = ceil(k·T/E · capacity_factor)``; pairs past it are dropped (their
residual passes through) and the combine re-weights by the router
weights.  A dropped pair's slot ``expert·C + position`` can lie in the
next expert's range or past ``E·C``.  The reference scatter-adds a zero
row there (JAX drops the out-of-range writes) and clamps the gather;
PyTorch's indexing would raise, so the port scatters through
``core/cdfg.at_add`` (the port's ``x.at[idx].add(v)``: an out-of-range
write lands in a spare row that is cut off) and gathers through
``layers.take``, which clamps; the zero combine weight of a dropped pair
cancels its read.  Traced, each is the reference's equations
(``scatter-add``, ``gather``), as are the top-k (one ``top_k``), the
one-hot and the slot count (``jit _one_hot``, ``jit cumsum``, in int32).

Top-k keeps the lower expert index first among equal scores, as
``jax.lax.top_k`` does (device-limited routing zeroes whole groups, so
ties at 0 are common): a stable descending sort, not ``torch.topk``,
whose order among ties is unspecified on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import layers
from ..core import cdfg


def _expert_stack(gen: torch.Generator, E: int, rows: int, cols: int,
                  dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """(E, rows, cols) normal / sqrt(rows) in ``dtype``, drawn one expert
    at a time: one fp32 draw of a whole DeepSeek-V3 stack would take 15
    GB of transient memory."""
    out = torch.empty((E, rows, cols), dtype=dtype, device=device)
    if gen is None:                      # shapes only (``meta``)
        return out
    for e in range(E):
        out[e] = (layers._normal(gen, (rows, cols))
                  / math.sqrt(rows)).to(device, dtype)
    return out


def moe_init(gen: torch.Generator, cfg, device: torch.device) -> dict:
    m, d, dt = cfg.moe, cfg.d_model, cfg.torch_dtype
    E = m.num_experts
    p = {
        "router": layers._dense_init(gen, d, E, torch.float32, device,
                                     scale=0.02),
        "w_gate": _expert_stack(gen, E, d, m.d_ff, dt, device),
        "w_up": _expert_stack(gen, E, d, m.d_ff, dt, device),
        "w_down": _expert_stack(gen, E, m.d_ff, d, dt, device),
    }
    if m.num_shared > 0:
        p["shared"] = layers.mlp_init(gen, d, m.d_ff * m.num_shared, cfg.act,
                                      dt, device)
    return p


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the k largest, lower index
    first among ties, and their int32 indices.  A trace keeps the call as
    one ``top_k`` equation."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


_top_k.primitive = "top_k"
torch.fx.wrap("_top_k")


def _one_hot(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    """``jax.nn.one_hot(x, num_classes, dtype=jnp.int32)``.  A trace
    keeps the call as one ``jit`` equation, as the reference's jaxpr
    does."""
    return (x[..., None] == torch.arange(num_classes,
                                         device=x.device)).to(torch.int32)


_one_hot.jit_name = "_one_hot"
_one_hot.jit_arity = 1
torch.fx.wrap("_one_hot")


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax(x, axis=-1)``: traced, the reference's equations
    — ``exp`` of ``x`` less its maximum (at least ``-inf``, kept dims,
    not differentiated: ``stop_gradient``) over their sum; on tensors
    ``torch.softmax``."""
    if not isinstance(x, torch.fx.Proxy):
        return torch.softmax(x, dim=-1)
    top = x.amax(-1).clamp_min(-math.inf)[..., None].detach()
    e = torch.exp(x - top)
    return e / e.sum(-1, keepdim=True)


def moe_apply(params: dict, x: torch.Tensor, cfg
              ) -> tuple[torch.Tensor, dict]:
    """x: (B, S, d) → (y, aux) with the load-balance loss and the share of
    dropped (token, choice) pairs in aux."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = m.num_experts, m.top_k
    xt = x.reshape(T, d)

    # --- router (fp32 for numerics) ---------------------------------------
    logits = xt.float() @ params["router"]                 # (T, E)
    # on DTensors the routing sees every token (the capacity count runs
    # over all of them): on replicas
    cap = int(math.ceil(k * T / E * m.capacity_factor))
    scores, top_w, top_ids, onehot, keep, slot = layers.on_replicas(
        lambda lg: _route(lg, m, T, cap), logits)

    # --- scatter (dispatch: the memory stage) ------------------------------
    src = xt[:, None, :].repeat_interleave(k, 1)           # (T, k, d)
    src = torch.where(keep[..., None], src, 0)

    if m.dispatch_dtype == "int8":
        # quantize the token payload before the scatter; per-token f16
        # scales ride along (a dropped pair's 1e-8 is 0 in f16)
        s8 = (src.float().abs().amax(-1, keepdim=True) / 127.0
              ).clamp_min(1e-8)
        src_q = torch.clamp(torch.round(src.float() / s8),
                            -127, 127).to(torch.int8)
        xe_q = layers.on_replicas(
            cdfg.at_add, torch.zeros((E * cap, d), dtype=torch.int8,
                                 device=x.device),
            slot.reshape(-1), src_q.reshape(T * k, d))
        se = layers.on_replicas(
            cdfg.at_add, torch.zeros((E * cap, 1), dtype=torch.float16,
                                 device=x.device),
            slot.reshape(-1), s8.reshape(T * k, 1).to(torch.float16))
        xe = (xe_q.float() * se.float()).to(x.dtype)
    else:
        xe = torch.zeros((E * cap, d), dtype=x.dtype, device=x.device)
        xe = layers.on_replicas(cdfg.at_add, xe, slot.reshape(-1),
                                src.reshape(T * k, d))
    xe = xe.reshape(E, cap, d)

    # --- expert FFN (the long-latency stage) -------------------------------
    gate = torch.bmm(xe, params["w_gate"])
    up = torch.bmm(xe, params["w_up"])
    h = (F.silu(gate.float()) * up.float()).to(x.dtype)
    ye = torch.bmm(h, params["w_down"])                    # (E, cap, d)

    # --- gather (combine: the second memory stage) --------------------------
    # a dropped pair's slot reads a clamped row; its zero weight cancels it
    yk = layers.on_replicas(
        lambda ye, slot: layers.take(ye.reshape(E * cap, d),
                                     slot.reshape(-1)).reshape(T, k, d),
        ye, slot)
    yk = yk * (top_w * keep).float()[..., None]
    y = yk.sum(dim=1).to(x.dtype)

    # --- shared experts (always-on streaming partition) ---------------------
    if m.num_shared > 0:
        y = y + layers.mlp_apply(params["shared"], xt, cfg.act)

    # --- aux: load-balance loss (Switch-style) ------------------------------
    me = scores.mean(dim=0)                                # (E,)
    ce = onehot.sum(dim=1, dtype=torch.int32).float().mean(dim=0) * (E / k)
    # ``keep.mean()`` of the reference: bool to int32, then to fp32
    aux = {"lb_loss": (me * ce).sum() * E,
           "dropped_frac": 1.0 - keep.to(torch.int32).float().mean()}
    return y.reshape(B, S, d), aux


def _route(logits: torch.Tensor, m, T: int, cap: int) -> tuple:
    """Router logits → (scores, top-k weights and ids, their one-hot,
    keep, slot): each (token, choice) pair takes the next slot of its
    expert in token-major order, up to the capacity ``cap``; integers in
    int32, as the reference's."""
    E, k = m.num_experts, m.top_k
    if m.router_fn == "sigmoid":   # DeepSeek-V3 style
        scores = torch.sigmoid(logits)
    else:
        scores = _softmax(logits)
    if m.route_groups > 1 and m.route_device_limit > 0:
        # device-limited routing: keep only each token's top-M expert
        # groups before the top-k
        G = m.route_groups
        gs = scores.reshape(T, G, E // G).amax(-1)          # (T, G)
        _, top_g = _top_k(gs, m.route_device_limit)
        gmask = _one_hot(top_g, G).to(scores.dtype).sum(1)
        scores = (scores.reshape(T, G, E // G)
                  * gmask[..., None]).reshape(T, E)
    top_w, top_ids = _top_k(scores, k)                     # (T, k)
    if m.normalize_weights:
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)

    # --- position within expert --------------------------------------------
    onehot = _one_hot(top_ids, E)                          # (T, k, E)
    flat = onehot.reshape(T * k, E)
    pos = flat.cumsum(0, dtype=torch.int32) - flat         # pos in expert
    pos = (pos * flat).sum(-1, dtype=torch.int32).reshape(T, k)
    keep = pos < cap
    slot = top_ids * cap + pos                             # may pass E*cap
    return scores, top_w, top_ids, onehot, keep, slot
