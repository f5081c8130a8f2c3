"""AdamW with gradient clipping and weight-decay masks.

The port of the reference's ``optim/adamw.py``, with its formula: clip
by the global fp32 norm of the raw grads, ``m`` and ``v`` in
``state_dtype``, ``update = (m/b1c)/(sqrt(v/b2c)+eps) + wd·p``, and
``p ← (p32 − lr·update)`` rounded back to the parameter's dtype (no fp32
master copy, as in the reference).  ``torch.optim.AdamW`` is another
update: it places eps differently, decays multiplicatively and does not
clip.  The optimiser state is a tree congruent with the params; every
function here is pure (new tensors out, nothing updated in place).  The
update runs leaf by leaf in the reference's operations and order, so a
trace of the train step on the reference's stacked layout lowers to the
reference's equations (the dry run's train census,
``launch/dryrun.dataflow_census``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .. import tree as tree_util
from ..runtime.sharding import is_dtensor as _is_dtensor

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
    leaf under ``segment_<i>`` carries a leading repeats axis; the
    port's params give each repeat its own leaves, so such a leaf counts
    one axis more (a stacked leaf, as the census traces, does not).
    Qwen2.5's ``b_q``/``b_k``/``b_v``, Jamba's ``conv_b`` and RWKV-6's
    ``mu_*`` are 1-D here and decayed, as there.  ``embed``, ``unembed``,
    ``final_norm`` and the ``mtp`` head are not stacked in either."""
    if any(str(n) in NO_DECAY for n in path):
        return False
    return leaf.ndim + _per_repeat(path) >= 2


def _per_repeat(path: tuple) -> bool:
    """A leaf of one repeat of a segment (``segment_<i>/<repeat>/<unit>
    /...``), as the port's params hold them; a stacked leaf
    (``segment_<i>/<unit>/...``, as the dry run's census traces them)
    already carries the repeats axis."""
    return (len(path) > 2 and str(path[0]).startswith("segment_")
            and isinstance(path[1], int) and isinstance(path[2], int))


def init_opt_state(params: Any, cfg: AdamWConfig) -> dict:
    """Zero moments in ``cfg.state_dtype`` beside each param, and the
    step count (int32, on the params' device)."""
    flat = tree_util.leaves(params)

    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)

    return {"mu": tree_util.tree_map(zeros, params),
            "nu": tree_util.tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32,
                                 device=flat[0].device if flat else None)}


def global_norm(tree: Any) -> torch.Tensor:
    """The fp32 L2 norm over every leaf of the tree: the reference's sum
    of each leaf's summed squares, then the square root."""
    return torch.sqrt(sum(torch.square(leaf.float()).sum()
                          for leaf in tree_util.leaves(tree)))


def apply_updates(params: Any, grads: Any, state: dict, cfg: AdamWConfig,
                  lr_scale: torch.Tensor | float = 1.0
                  ) -> tuple[Any, dict, dict]:
    """One AdamW step.  Returns (new_params, new_state, info), info holding
    the raw grads' global norm and the step's LR (0-d fp32 tensors).

    The update runs leaf by leaf in the reference's operations and order,
    on the tree as it is given: the port's params (one entry per repeat
    of a segment) or the reference's stacked layout
    (``launch/steps.make_train_step`` stacks a segment's repeats so that
    a segment costs a few launches a unit path, not a repeat, and the dry
    run's census traces that layout).  On sharded (DTensor) leaves each
    rank updates its own shards."""
    flat_p = tree_util.leaves(params)
    gnorm = global_norm(grads)
    gn = _whole(gnorm)
    clip = torch.minimum(gn.new_tensor(1.0), cfg.grad_clip_norm / (gn + 1e-9))
    count = state["count"] + 1
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()
    if isinstance(lr_scale, (int, float)):
        lr_scale = gn.new_tensor(lr_scale)
    lr = cfg.lr * lr_scale

    # elementwise from here: param, gradient and moments share a layout
    b1c, b2c, lr_l = _whole(b1c), _whole(b2c), _whole(lr)
    sd = cfg.state_dtype
    new_p, new_m, new_v = [], [], []
    for (path, p), g, m, v in zip(tree_util.flatten_with_paths(params),
                                  tree_util.leaves(grads),
                                  tree_util.leaves(state["mu"]),
                                  tree_util.leaves(state["nu"]), strict=True):
        pl, gl, ml, vl = (_local(t) for t in (p, g, m, v))
        g32 = gl.to(sd) * clip
        m = cfg.b1 * ml + (1 - cfg.b1) * g32
        v = cfg.b2 * vl + (1 - cfg.b2) * torch.square(g32)
        update = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay and _decay_mask(path, p):
            update = update + cfg.weight_decay * pl.to(sd)
        new_p.append((pl.to(sd) - lr_l * update).to(pl.dtype))
        new_m.append(m)
        new_v.append(v)

    def out(new: list) -> Any:
        return tree_util.unflatten(params, _like(new, flat_p))

    state_out = {"mu": out(new_m), "nu": out(new_v), "count": count}
    return out(new_p), state_out, {"grad_norm": gnorm, "lr": lr}


def _local(t):
    """A DTensor's local shard, else the tensor."""
    return t.to_local() if _is_dtensor(t) else t


def _whole(t):
    """A scalar's value on every rank (a DTensor's, gathered)."""
    return t.full_tensor() if _is_dtensor(t) else t


def _like(new: list, old: list) -> list:
    """New local shards in the layouts of ``old``'s DTensor leaves."""
    from torch.distributed.tensor import DTensor
    return [DTensor.from_local(n, o.device_mesh, o.placements,
                               run_check=False, shape=o.shape,
                               stride=o.stride())
            if _is_dtensor(o) else n for n, o in zip(new, old)]
