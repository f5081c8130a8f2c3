"""AdamW with gradient clipping and weight-decay masks.

The port of the reference's ``optim/adamw.py``, with its formula: clip
by the global fp32 norm of the raw grads, ``m`` and ``v`` in
``state_dtype``, ``update = (m/b1c)/(sqrt(v/b2c)+eps) + wd·p``, and
``p ← (p32 − lr·update)`` rounded back to the parameter's dtype (no fp32
master copy, as in the reference).  ``torch.optim.AdamW`` is another
update: it places eps differently, decays multiplicatively and does not
clip.  The optimiser state is a tree congruent with the params; every
function here is pure (new tensors out, nothing updated in place), and
the per-leaf arithmetic is grouped by ``torch._foreach_*`` calls, which
launch a few kernels for all leaves instead of one per leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .. import tree

#: parameter names never decayed: norms, biases and the SSMs' per-channel
#: constants (the reference's list)
NO_DECAY = ("scale", "bias", "dt_bias", "A_log", "D", "decay_w0", "bonus_u")


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip_norm: float = 1.0
    #: keep m/v (and the update math) in fp32 even for bf16 params
    state_dtype: torch.dtype = torch.float32


def _decay_mask(path: tuple, leaf: torch.Tensor) -> bool:
    """No weight decay on norms, biases and 1-D params.

    The reference decides on the rank of its *stacked* leaves, where a
    leaf under ``segment_<i>`` carries a leading repeats axis; here each
    repeat has its own leaves, so such a leaf counts one axis more.
    Qwen2.5's ``b_q``/``b_k``/``b_v``, Jamba's ``conv_b`` and RWKV-6's
    ``mu_*`` are 1-D here and decayed, as there.  ``embed``, ``unembed``,
    ``final_norm`` and the ``mtp`` head are not stacked in either."""
    if any(str(n) in NO_DECAY for n in path):
        return False
    stacked = bool(path) and str(path[0]).startswith("segment_")
    return leaf.ndim + stacked >= 2


def init_opt_state(params: Any, cfg: AdamWConfig) -> dict:
    """Zero moments in ``cfg.state_dtype`` beside each param, and the
    step count (int32, on the params' device)."""
    flat = tree.leaves(params)

    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)

    return {"mu": tree.tree_map(zeros, params),
            "nu": tree.tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=flat[0].device if flat else None)}


def _norm(leaves32: list[torch.Tensor]) -> torch.Tensor:
    if not leaves32:
        return torch.zeros(())
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm(leaves32)))


def global_norm(tree_: Any) -> torch.Tensor:
    """The fp32 L2 norm over every leaf of the tree."""
    return _norm([leaf.float() for leaf in tree.leaves(tree_)])


def apply_updates(params: Any, grads: Any, state: dict, cfg: AdamWConfig,
                  lr_scale: torch.Tensor | float = 1.0
                  ) -> tuple[Any, dict, dict]:
    """One AdamW step.  Returns (new_params, new_state, info), info holding
    the raw grads' global norm and the step's LR (0-d fp32 tensors)."""
    paths = tree.flatten_with_paths(params)
    flat_p = [leaf for _, leaf in paths]
    g32 = [g.float() for g in tree.leaves(grads)]
    gnorm = _norm(g32)
    dev = gnorm.device
    clip = torch.clamp(cfg.grad_clip_norm / (gnorm + 1e-9), max=1.0)
    count = state["count"] + 1
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32, device=dev)

    sd = cfg.state_dtype
    g = torch._foreach_mul([x.to(sd) for x in g32], clip)
    m = torch._foreach_mul(tree.leaves(state["mu"]), cfg.b1)
    torch._foreach_add_(m, torch._foreach_mul(g, 1 - cfg.b1))
    v = torch._foreach_mul(tree.leaves(state["nu"]), cfg.b2)
    sq = torch._foreach_mul(g, g)
    torch._foreach_mul_(sq, 1 - cfg.b2)
    torch._foreach_add_(v, sq)
    den = torch._foreach_div(v, b2c)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, cfg.eps)
    update = torch._foreach_div(torch._foreach_div(m, b1c), den)
    p32 = [p.to(sd) for p in flat_p]
    decayed = [i for i, (path, p) in enumerate(paths)
               if _decay_mask(path, p)]
    if cfg.weight_decay and decayed:
        torch._foreach_add_([update[i] for i in decayed], torch._foreach_mul(
            [p32[i] for i in decayed], cfg.weight_decay))
    new_p = torch._foreach_sub(p32, torch._foreach_mul(update, lr))

    params_out = tree.unflatten(params, [x.to(p.dtype)
                                         for x, p in zip(new_p, flat_p)])
    state_out = {"mu": tree.unflatten(params, m),
                 "nu": tree.unflatten(params, v),
                 "count": count}
    return params_out, state_out, {"grad_norm": gnorm, "lr": lr}
