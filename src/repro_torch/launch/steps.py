"""Step functions (train / prefill / decode) and the abstract train state.

The port of the reference's ``launch/steps.py``.  :func:`loss_and_grads`
is ``jax.value_and_grad(loss_fn, has_aux=True)`` by
``torch.autograd.grad`` over the params' flattened leaves, so the params
stay plain tensors and the grads come back as a tree of their structure.
:func:`train_state_shardings` and :func:`batch_shardings` give the
rules of ``runtime/sharding.py`` as trees of ``NamedSharding`` (a mesh
and DTensor placements), which ``Checkpointer.restore(shardings=)`` and
``prefetched(sharding=)`` take;
:func:`lower_cell` runs one dry-run cell's step on DTensors over a
``DeviceMesh`` (the production mesh on a fake process group,
``launch/mesh.py``) with ``meta`` shards and records what one rank
holds, computes and moves (``launch/census.py``) — the reference lowers
and compiles the step for 256 or 512 placeholder devices instead.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import torch

from .. import tree
from ..configs.base import SHAPES, InputShape, ModelConfig
from ..models import model as M
from ..optim import adamw
from ..optim.schedule import warmup_cosine
from ..runtime import sharding as shr


@dataclasses.dataclass
class TrainState:
    params: Any
    opt: dict
    step: torch.Tensor      # int32, 0-d, on the params' device


def loss_and_grads(params: Any, batch: dict, cfg: ModelConfig
                   ) -> tuple[tuple[torch.Tensor, dict], Any]:
    """``jax.value_and_grad(loss_fn, has_aux=True)``: ((loss, metrics),
    grads), loss and metrics detached, grads a tree of the params'
    structure — zeros for a leaf the loss does not read, as in JAX."""
    leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
    with torch.enable_grad():
        loss, metrics = M.loss_fn(tree.unflatten(params, leaves), batch,
                                  cfg)
        got = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else _like(g, p)
             for p, g in zip(leaves, got)]
    return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
            tree.unflatten(params, grads))


def _unstacked(params: dict, batch: dict, cfg: ModelConfig) -> dict:
    """The tree the loss reads of ``params`` whose segment leaves are
    stacked on a leading repeats axis (as the reference holds them, and
    the dry run's train census traces them): the params themselves, each
    segment one scan over its stacked leaves."""
    return params


# what a trace inside ``cdfg.leaves(grad=[(steps, "loss_and_grads")])``
# differentiates (``core/autodiff.py``), and the tree it reads
loss_and_grads.value_fn = M.loss_fn
loss_and_grads.unstacked = _unstacked


def stack_train_state(state: TrainState) -> TrainState:
    """A train state in the reference's layout and leaf order: params and
    moments by ``transformer.stack_repeats``, the optimiser state's keys
    sorted (``count``, ``mu``, ``nu``)."""
    stack = M.transformer.stack_repeats
    return TrainState(stack(state.params),
                      {"count": state.opt["count"],
                       "mu": stack(state.opt["mu"]),
                       "nu": stack(state.opt["nu"])}, state.step)


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A sharded leaf's gradient in its param's layout (ZeRO: the
    gradient reduce-scatters into the param's shards), so the optimiser
    meets param, gradient and moments in one layout."""
    if shr.is_dtensor(p) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    *, total_steps: int = 10_000, warmup_steps: int = 200):
    """Pure train step: (state, batch) -> (state, metrics).  The state
    that goes in is not modified; metrics are detached 0-d tensors."""

    def train_step(state: TrainState, batch: dict
                   ) -> tuple[TrainState, dict]:
        (_, metrics), grads = loss_and_grads(state.params, batch, cfg)
        lr_scale = warmup_cosine(state.step, warmup_steps=warmup_steps,
                                 total_steps=total_steps)
        params, opt, info = _apply_updates(state.params, grads, state.opt,
                                           opt_cfg, lr_scale)
        metrics.update(info)
        return TrainState(params, opt, state.step + 1), metrics

    return train_step


#: the mean size, in elements, of a segment's leaves (one repeat's) up to
#: which AdamW updates the segments stacked.  A leaf's update is ~20
#: elementwise launches: below ~2.5 M elements each costs its launch
#: (~6 µs of host), above it its passes over the leaf at the card's
#: memory rate (~8 B an element a pass at 3.35 TB/s).  Stacking saves
#: the launches and costs copies of params, grads and moments: SmolLM-135M
#: (0.39 M) gains ~100 ms a step, OLMo-1B (9.6 M) none, for 15 GiB of
#: peak (PERF.md §6, PR 27).
STACK_BELOW = 1 << 21


def _apply_updates(params: Any, grads: Any, opt: dict,
                   opt_cfg: adamw.AdamWConfig, lr_scale: torch.Tensor
                   ) -> tuple[Any, dict, dict]:
    """``adamw.apply_updates``, for segments of small leaves (a mean
    below :data:`STACK_BELOW`) on the reference's stacked layout: the
    port's per-repeat tree of plain tensors is stacked first (one leaf a
    unit path, so a segment's update costs a few launches a unit path,
    not a repeat; the stacked copies of params, grads and moments live
    for the update) and unstacked after, the new leaves views of the
    stacked ones.  Larger leaves, a stacked tree (the census's) and
    sharded (DTensor) leaves go as they are."""
    T = M.transformer
    seg = [t for k, v in params.items() if k.startswith("segment_")
           for t in tree.leaves(v)]
    if (not T.has_repeats(params) or any(map(shr.is_dtensor, seg))
            or sum(t.numel() for t in seg) > STACK_BELOW * len(seg)):
        return adamw.apply_updates(params, grads, opt, opt_cfg, lr_scale)
    S = T.stack_repeats
    new_p, new_o, info = adamw.apply_updates(
        S(params), S(grads), {"mu": S(opt["mu"]), "nu": S(opt["nu"]),
                              "count": opt["count"]}, opt_cfg, lr_scale)

    def back(t: dict) -> Any:
        return T.unstack_repeats(t, params)
    return back(new_p), {"mu": back(new_o["mu"]), "nu": back(new_o["nu"]),
                         "count": new_o["count"]}, info


def abstract_train_state(cfg: ModelConfig,
                         opt_cfg: adamw.AdamWConfig) -> TrainState:
    """The train state's shapes and dtypes as ``meta`` tensors (no
    allocation)."""
    params = M.init_params(None, cfg, "meta")
    opt = adamw.init_opt_state(params, opt_cfg)
    return TrainState(params, opt,
                      torch.empty((), dtype=torch.int32, device="meta"))


# ---------------------------------------------------------------------------
# Serving steps
# ---------------------------------------------------------------------------

def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(params, inputs):
        return M.prefill(params, inputs, cfg, max_len)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, token, cache, length):
        return M.decode_step(params, token, cache, length, cfg)
    return decode_step


def make_forward(cfg: ModelConfig):
    def fwd(params, inputs):
        logits, _ = M.forward(params, inputs, cfg)
        return logits
    return fwd


# ---------------------------------------------------------------------------
# Placements, argument bytes and the sharded step of one dry-run cell
# ---------------------------------------------------------------------------

def train_state_specs(mesh: Any, state: TrainState) -> TrainState:
    """The train layout of a train state: the moments shard as their
    params (ZeRO for free); ``count`` and ``step`` are replicated."""
    psp = shr.params_specs(mesh, state.params)
    return TrainState(psp, {"mu": psp, "nu": psp, "count": ()}, ())


def batch_specs(mesh: Any, batch: dict) -> dict:
    """Token batches by :func:`~repro_torch.runtime.sharding.batch_pspec`,
    a decode cell's ``cache`` by ``cache_pspec``."""
    return {k: (shr.tree_specs(mesh, v, shr.cache_pspec) if k == "cache"
                else shr.batch_pspec(mesh, v.shape))
            for k, v in batch.items()}


_batch_pspecs = batch_specs


def _spec_map(fn, specs: Any) -> Any:
    """``fn`` over a spec tree's specs, in its structure (a spec is a
    tuple, which ``tree`` would walk into)."""
    if isinstance(specs, TrainState):
        return TrainState(*(_spec_map(fn, getattr(specs, f.name))
                            for f in dataclasses.fields(specs)))
    if isinstance(specs, dict):
        return {k: _spec_map(fn, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [_spec_map(fn, v) for v in specs]
    return fn(specs)


def _spec_leaves(specs: Any) -> list:
    """A spec tree's specs, in ``tree.leaves`` order of its tensors."""
    out: list = []
    _spec_map(out.append, specs)
    return out


def _shardings(mesh: Any, specs: Any) -> Any:
    return _spec_map(lambda sp: shr.NamedSharding(
        mesh, shr.to_placements(mesh, sp)), specs)


def train_state_shardings(mesh: Any, state: TrainState) -> TrainState:
    """:func:`train_state_specs` as a tree of
    :class:`~repro_torch.runtime.sharding.NamedSharding` on ``mesh`` (a
    ``DeviceMesh``), one leaf per tensor of ``state``."""
    return _shardings(mesh, train_state_specs(mesh, state))


def batch_shardings(mesh: Any, batch_specs: dict) -> dict:
    """The specs of the batch ``batch_specs`` (its tensors, or their
    ``meta`` twins) as a tree of
    :class:`~repro_torch.runtime.sharding.NamedSharding` on ``mesh``: the
    reference's keywords."""
    return _shardings(mesh, _batch_pspecs(mesh, batch_specs))


def _param_bytes(params: Any) -> int:
    return sum(p.numel() * p.element_size() for p in tree.leaves(params))


def cell_inputs(cfg: ModelConfig, shape: InputShape | str, mesh: Any, *,
                opt_cfg: adamw.AdamWConfig | None = None,
                ep_serve: bool = False,
                hbm_bytes: int = shr.HBM_BYTES_PER_CHIP
                ) -> tuple[str, tuple, list]:
    """The step kind of a cell, its arguments as ``meta`` tensors and
    their specs (a list, one spec tree an argument), by the rules alone
    (``mesh`` may be a ``{name: size}`` mapping).  A decode step's
    ``length`` is an int32 scalar, replicated, as the reference's."""
    if isinstance(shape, str):
        shape = SHAPES[shape]
    specs = M.input_specs(cfg, shape)
    if shape.kind == "train":
        state = abstract_train_state(cfg, opt_cfg or adamw.AdamWConfig())
        return ("train", (state, specs),
                [train_state_specs(mesh, state), batch_specs(mesh, specs)])
    params = M.init_params(None, cfg, "meta")
    psp = shr.params_specs_serve(mesh, params, _param_bytes(params),
                                 ep_serve=ep_serve and shape.kind == "decode",
                                 hbm_bytes=hbm_bytes)
    if shape.kind == "prefill":
        inp = specs.get("tokens", specs.get("embeds"))
        return "prefill", (params, inp), [psp, shr.batch_pspec(mesh,
                                                                inp.shape)]
    if shape.kind == "decode":
        b = batch_specs(mesh, {"token": specs["token"],
                               "cache": specs["cache"]})
        return ("decode", (params, specs["token"], specs["cache"],
                           specs["length"]),
                [psp, b["token"], b["cache"], ()])
    raise ValueError(shape.kind)


def argument_bytes(args: tuple, specs: list, mesh: Any) -> int:
    """One rank's bytes of the arguments: each leaf's shape divided by
    its spec's axis sizes (the reference's ``mem_argument_size_in_bytes``
    follows from the PartitionSpecs and shapes alone)."""
    return sum(
        torch.Size(shr.local_shape(mesh, t.shape, sp)).numel()
        * t.element_size()
        for t, sp in zip(tree.leaves(args), _spec_leaves(specs)))


def lower_cell(cfg: ModelConfig, shape: InputShape | str, mesh: Any, *,
               opt_cfg: adamw.AdamWConfig | None = None,
               ep_serve: bool = False, inputs: Any = None) -> dict:
    """Run one cell's step once on this rank of ``mesh`` (a
    ``DeviceMesh``) and record what the rank holds, computes and moves.

    The step is the port's own (:func:`make_train_step`,
    :func:`make_forward`, :func:`make_decode_step`), run unchanged on
    DTensors: params, state, cache and inputs are built on ``meta`` and
    placed by the rules with ``src_data_rank=None`` (each rank takes its
    chunk; nothing is communicated), so every shard is a ``meta`` tensor
    — shapes and dtypes, no storage, the counterpart of the reference's
    placeholder devices — and so is everything the model computes from
    them; plain tensors the model creates count as replicated
    (``implicit_replication``).  (Not ``FakeTensorMode``: under it
    DTensor's planning of a strided-shard redistribution calls
    ``.tolist()`` on a fake index tensor and fails.)  A decode step runs
    at ``length = seq_len - 1``.  The record holds ``kind``,
    ``mem_argument_size_in_bytes`` (the local shards of every input),
    ``mem_output_size_in_bytes``, ``peak_bytes``, ``coll`` (the
    collectives' kinds, counts and result bytes), ``rank_flops``,
    ``rank_bytes``, ``trace_s`` and ``local_shapes`` (each argument
    leaf's local shape, in :func:`cell_inputs` order).  A missing
    sharding strategy raises.

    ``inputs`` (the arguments of :func:`cell_inputs`' structure, whole
    and the same on every rank) runs the step on their shards instead,
    on a real process group; the record then also holds ``outputs``.
    """
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from .census import RankCensus
    if isinstance(shape, str):
        shape = SHAPES[shape]
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    kind, meta_args, specs = cell_inputs(cfg, shape, mesh, opt_cfg=opt_cfg,
                                         ep_serve=ep_serve)
    whole = meta_args if inputs is None else inputs
    census = RankCensus(tree.leaves(whole)[0].device.type)

    def local(t: Any) -> torch.Tensor:
        return t.to_local() if isinstance(t, DTensor) else t

    args = tree.unflatten(whole, [
        sh.distribute(t) for t, sh in zip(
            tree.leaves(whole), _spec_leaves(_shardings(mesh, specs)),
            strict=True)])
    locals_ = [local(t) for t in tree.leaves(args)]
    census.hold(*locals_)
    if kind == "train":
        step = make_train_step(cfg, opt_cfg)
    elif kind == "prefill":
        step = make_forward(cfg)
    else:
        dstep = make_decode_step(cfg)
        length = shape.seq_len - 1

        def step(params, token, cache, _length):
            return dstep(params, token, cache, length)
    t0 = time.perf_counter()
    with census, implicit_replication():
        out = step(*args)
    trace_s = time.perf_counter() - t0
    out_bytes = sum(local(t).numel() * local(t).element_size()
                    for t in tree.leaves(out) if isinstance(t, torch.Tensor))
    rec = {"kind": kind,
           "mem_argument_size_in_bytes": sum(
               t.numel() * t.element_size() for t in locals_),
           "mem_output_size_in_bytes": out_bytes,
           "local_shapes": [tuple(t.shape) for t in locals_],
           "trace_s": trace_s}
    rec.update(census.record())
    if inputs is not None:
        rec["outputs"] = out
    return rec
