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
PyTorch's indexing would raise, so the port routes out-of-range writes
to a spare row that is cut off, and clamps the gather, which the zero
combine weight of a dropped pair then cancels.

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
    first among ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


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
    scores, top_w, top_ids, onehot, keep, slot, spare = layers.on_replicas(
        lambda lg: _route(lg, m, T, cap), logits)

    # --- scatter (dispatch: the memory stage) ------------------------------
    src = torch.where(keep[..., None], xt[:, None, :], 0)  # (T, k, d)
    src = src.reshape(T * k, d)

    def scatter(spare, src):
        # a spare row past E·cap takes the out-of-range writes
        return torch.zeros((E * cap + 1,) + src.shape[1:], dtype=src.dtype,
                           device=src.device).index_add_(0, spare, src)

    if m.dispatch_dtype == "int8":
        # quantize the token payload before the scatter; per-token f16
        # scales ride along (a dropped pair's 1e-8 is 0 in f16)
        s8 = (src.float().abs().amax(-1, keepdim=True) / 127.0
              ).clamp_min(1e-8)
        src_q = torch.clamp(torch.round(src.float() / s8),
                            -127, 127).to(torch.int8)
        xe_q = layers.on_replicas(scatter, spare, src_q)
        se = layers.on_replicas(scatter, spare, s8.to(torch.float16))
        xe = (xe_q[:-1].float() * se[:-1].float()).to(x.dtype)
    else:
        xe = layers.on_replicas(scatter, spare, src)[:-1]
    xe = xe.reshape(E, cap, d)

    # --- expert FFN (the long-latency stage) -------------------------------
    gate = torch.bmm(xe, params["w_gate"])
    up = torch.bmm(xe, params["w_up"])
    h = (F.silu(gate.float()) * up.float()).to(x.dtype)
    ye = torch.bmm(h, params["w_down"])                    # (E, cap, d)

    # --- gather (combine: the second memory stage) --------------------------
    yk = layers.on_replicas(
        lambda ye, slot: ye.reshape(E * cap, d)[
            slot.clamp(max=E * cap - 1)].reshape(T, k, d), ye, slot)
    yk = yk * (top_w * keep).float()[..., None]
    y = yk.sum(dim=1).to(x.dtype)

    # --- shared experts (always-on streaming partition) ---------------------
    if m.num_shared > 0:
        y = y + layers.mlp_apply(params["shared"], xt, cfg.act)

    # --- aux: load-balance loss (Switch-style) ------------------------------
    me = scores.mean(dim=0)                                # (E,)
    ce = onehot.sum(dim=1).float().mean(dim=0) * (E / k)
    aux = {"lb_loss": (me * ce).sum() * E,
           "dropped_frac": 1.0 - keep.float().mean()}
    return y.reshape(B, S, d), aux


def _route(logits: torch.Tensor, m, T: int, cap: int) -> tuple:
    """Router logits → (scores, top-k weights and ids, their one-hot,
    keep, slot, spare-row slot): each (token, choice) pair takes the next
    slot of its expert in token-major order, up to the capacity ``cap``."""
    E, k = m.num_experts, m.top_k
    if m.router_fn == "sigmoid":   # DeepSeek-V3 style
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    if m.route_groups > 1 and m.route_device_limit > 0:
        # device-limited routing: keep only each token's top-M expert
        # groups before the top-k
        G = m.route_groups
        gs = scores.reshape(T, G, E // G).amax(-1)          # (T, G)
        _, top_g = _top_k(gs, m.route_device_limit)
        gmask = F.one_hot(top_g, G).to(scores.dtype).sum(1)
        scores = (scores.reshape(T, G, E // G)
                  * gmask[..., None]).reshape(T, E)
    top_w, top_ids = _top_k(scores, k)                     # (T, k)
    if m.normalize_weights:
        top_w = top_w / top_w.sum(-1, keepdim=True).clamp_min(1e-9)

    # --- position within expert --------------------------------------------
    onehot = F.one_hot(top_ids, E)                         # (T, k, E)
    flat = onehot.reshape(T * k, E)
    pos = flat.cumsum(0) - flat                            # pos in expert
    pos = (pos * flat).sum(-1).reshape(T, k)               # (T, k)
    keep = pos < cap
    slot = (top_ids * cap + pos).reshape(-1)               # may pass E*cap
    spare = torch.where(slot < E * cap, slot, E * cap)     # the cut-off row
    return scores, top_w, top_ids, onehot, keep, slot, spare
