"""Dataflow pipeline executors — the template realized over ranks.

Two executors, as in the reference:

* :class:`SystolicPipeline` (heterogeneous stages) runs a
  :class:`~repro_torch.core.decouple.DecoupledProgram` over microbatches:
  stage *s* processes microbatch *m* at tick ``t = m + s`` and hands its
  channel payload, packed into one fixed-width int32 word, to stage
  *s+1* for the next tick — the paper's Fig. 2 schedule, where a stall in
  one stage does not halt the others.  :meth:`~SystolicPipeline.run_emulated`
  runs every stage on one device; :meth:`~SystolicPipeline.build_sharded`
  runs stage *s* on rank *s* and shifts the word one rank per tick.

* :func:`pipeline_apply` (homogeneous stages — classic pipeline
  parallelism): one stage function, per-stage parameters stacked along a
  leading ``S`` axis, GPipe's fill/drain schedule over ``M`` microbatches
  (bubble fraction ``(S-1)/(M+S-1)``).  Differentiable: its backward runs
  the ticks in reverse and shifts each activation gradient one rank back.
  :func:`pipeline_apply_emulated` is its one-device, schedule-exact
  oracle.

The multi-rank executors are SPMD over ``torch.distributed`` ranks (the
reference's are ``shard_map`` over a mesh axis in one process): every
rank calls them with the same arguments and gets the same replicated
result; :mod:`repro_torch.core.collectives` moves the tensors, and
:func:`repro_torch.launch.mesh.spawn` or ``torchrun`` starts the ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from .. import tree
from .._device import get_device
from .channels import WORD, ChannelSpec
from .collectives import Collectives
from .decouple import DecoupledProgram


@dataclasses.dataclass
class _BoundarySpec:
    vars: list[Any]
    spec: ChannelSpec


class SystolicPipeline:
    """Execute a decoupled program as a systolic pipeline over microbatches.

    Channels between non-adjacent stages are linearized: boundary *b* carries
    every var produced by stages ``<= b`` and still needed by stages ``> b``
    (intermediate stages forward them).  All boundaries are padded to one
    transport width so a single word per tick suffices.

    ``stream_argnums`` are the positions of the original function's arguments
    that vary per microbatch (leading axis = microbatch); the remaining
    arguments are per-stage constants, available to every stage.
    """

    def __init__(self, prog: DecoupledProgram,
                 stream_argnums: Sequence[int] = (0,)):
        self.prog = prog
        self.stream_argnums = tuple(stream_argnums)
        self.num_stages = len(prog.stages)
        self._build_boundaries()

    # -- static analysis ----------------------------------------------------

    def _build_boundaries(self) -> None:
        prog = self.prog
        S = self.num_stages
        produced_at: dict[Any, int] = {}
        for sp in prog.stages:
            for v in sp.out_vars:
                produced_at[v] = sp.stage_id
        needed_from: dict[Any, int] = {}
        for sp in prog.stages:
            for (tag, ref), v in zip(sp.in_from, sp.in_vars):
                if tag == "chan":
                    needed_from[v] = max(needed_from.get(v, -1), sp.stage_id)
        # final outputs must survive to the last boundary
        for tag, ref in prog.out_sources:
            if tag == "chan":
                needed_from[ref] = max(needed_from.get(ref, -1), S - 1)

        self.boundaries: list[_BoundarySpec] = []
        for b in range(S):  # boundary b sits after stage b
            vars_b = [v for v, p in produced_at.items()
                      if p <= b and needed_from.get(v, -1) > b
                      or (p <= b and b == S - 1 and any(
                          t == "chan" and r is v
                          for t, r in prog.out_sources))]
            # deterministic order
            vars_b = sorted(set(vars_b), key=lambda v: (produced_at[v],
                                                        str(v)))
            self.boundaries.append(_BoundarySpec(
                vars_b, ChannelSpec.from_avals([v.aval for v in vars_b])))
        self.width = max([1] + [b.spec.width for b in self.boundaries])

    # -- per-stage wrapped function ------------------------------------------

    def _stage_fn(self, s: int, device: torch.device) -> Callable:
        prog = self.prog
        sp = prog.stages[s]
        in_spec = self.boundaries[s - 1] if s > 0 else None
        out_spec = self.boundaries[s]
        consts = prog.partition.cdfg.graph.consts

        def fn(word_in: torch.Tensor, stream_args: tuple,
               const_args: dict[int, Any]):
            env: dict[Any, Any] = {}
            if in_spec is not None and in_spec.vars:
                payload = in_spec.spec.unpack(word_in[:in_spec.spec.width])
                env.update(zip(in_spec.vars, payload))
            args_map = dict(zip(self.stream_argnums, stream_args))
            ins = []
            for (tag, ref), v in zip(sp.in_from, sp.in_vars):
                if tag == "arg":
                    ins.append(args_map[ref] if ref in args_map
                               else const_args[ref])
                elif tag == "const":
                    ins.append(consts[ref])
                else:
                    ins.append(env[v])
            env.update(zip(sp.out_vars, sp.fn(*ins)))
            word_out = out_spec.spec.pack(
                [env[v] for v in out_spec.vars], pad_to=self.width,
                device=device)
            y = None
            if s == self.num_stages - 1:
                res = []
                for tag, ref in prog.out_sources:
                    if tag == "chan":
                        res.append(env[ref])
                    elif tag == "arg":
                        res.append(args_map[ref] if ref in args_map
                                   else const_args[ref])
                    elif tag == "const":
                        res.append(consts[ref])
                    else:
                        res.append(torch.as_tensor(ref, device=device))
                y = tuple(res)
            return word_out, y

        return fn

    # -- emulated execution (single device, schedule-exact) -------------------

    def run_emulated(self, *args: Any) -> tuple:
        """Run the exact tick-by-tick schedule (one device).

        Stage ``s`` at tick ``t`` reads the word stage ``s-1`` wrote at
        tick ``t-1`` (double-buffered boundary words), so the per-tick
        occupancy is the Fig. 2 grid.  Outputs are stacked along a
        leading microbatch axis.
        """
        S = self.num_stages
        stream = [args[i] for i in self.stream_argnums]
        T = int(stream[0].shape[0])
        device = stream[0].device
        const_args = {j: a for j, a in enumerate(args)
                      if j not in self.stream_argnums}
        fns = [self._stage_fn(s, device) for s in range(S)]

        def zero_word() -> torch.Tensor:
            return torch.zeros(self.width, dtype=WORD, device=device)

        words = [zero_word() for _ in range(S)]
        outputs: list[Any] = [None] * T
        for t in range(T + S - 1):
            new_words = list(words)
            for s in range(S):
                m = t - s
                if not 0 <= m < T:
                    continue
                xs = tuple(x[m] for x in stream)
                word_in = words[s - 1] if s > 0 else zero_word()
                new_words[s], y = fns[s](word_in, xs, const_args)
                if s == S - 1:
                    outputs[m] = y
            words = new_words
        return tuple(torch.stack(col) for col in zip(*outputs))

    # -- sharded execution (one stage per rank) --------------------------------

    def _output_like(self, stream: list, const_args: dict[int, Any],
                     device: torch.device) -> list[torch.Tensor]:
        """Empty tensors shaped as the stacked outputs, built from the
        program's abstract values: what a rank that does not run the last
        stage receives the replicated outputs into."""
        T = int(stream[0].shape[0])
        args_map = {i: x[0] for i, x in zip(self.stream_argnums, stream)}
        consts = self.prog.partition.cdfg.graph.consts
        like = []
        for tag, ref in self.prog.out_sources:
            if tag == "chan":
                v = ref.aval
            elif tag == "arg":
                v = args_map[ref] if ref in args_map else const_args[ref]
            elif tag == "const":
                v = consts[ref]
            else:
                v = torch.as_tensor(ref)
            like.append(torch.empty((T, *v.shape), dtype=v.dtype,
                                    device=device))
        return like

    def build_sharded(self, group: dist.ProcessGroup | None = None
                      ) -> Callable:
        """Return ``run(*args) -> stacked outputs`` executing with stage
        *s* on rank *s* of ``group`` (default: the initialised world).

        SPMD: every rank of the group calls ``run`` with the same
        arguments.  Each tick, a rank runs its stage on its microbatch
        (if it has one this tick) and the boundary word shifts one rank
        along the ring ``[(i, (i + 1) % S)]``, on every tick and every
        rank, as the reference's ``ppermute``; stage ``S-1``'s stacked
        outputs are then broadcast, so every rank returns them.  The
        group needs at least ``S`` ranks; its first ``S`` form the ring
        (a subgroup of them, made here, when the group is larger), and
        ranks past ``S - 1`` run no stage and receive the outputs."""
        S = self.num_stages
        group = group if group is not None else dist.group.WORLD
        size, rank = dist.get_world_size(group), dist.get_rank(group)
        if rank < 0:
            raise ValueError("this rank is not a member of the group")
        if size < S:
            raise ValueError(f"the group has {size} ranks, need {S} (one "
                             f"rank per stage)")
        ring = group
        if size > S and rank < S:
            # only the ring's members make it
            ring = dist.new_group(
                [dist.get_global_rank(group, i) for i in range(S)],
                use_local_synchronization=True)

        def run(*args: Any):
            stream = [args[i] for i in self.stream_argnums]
            T = int(stream[0].shape[0])
            device = stream[0].device
            const_args = {j: a for j, a in enumerate(args)
                          if j not in self.stream_argnums}
            outputs: list[Any] = [None] * T
            if rank < S:
                comm = Collectives(ring, device)
                fn = self._stage_fn(rank, device)
                zero = torch.zeros(self.width, dtype=WORD, device=device)
                word = zero
                for t in range(T + S - 1):
                    m = t - rank
                    w_out = zero
                    if 0 <= m < T:
                        w_out, y = fn(word, tuple(x[m] for x in stream),
                                      const_args)
                        if rank == S - 1:
                            outputs[m] = y
                    word = comm.ppermute(w_out)
            like = self._output_like(stream, const_args, device)
            if rank == S - 1:
                got = [torch.stack(col) for col in zip(*outputs)]
                for g, l in zip(got, like):
                    if g.shape != l.shape or g.dtype != l.dtype:
                        raise RuntimeError(
                            f"an output is {tuple(g.shape)} {g.dtype}, the "
                            f"program's value {tuple(l.shape)} {l.dtype}")
                like = got
            comm = Collectives(group, device)
            return tuple(comm.broadcast(o, S - 1) for o in like)

        return run


# ---------------------------------------------------------------------------
# Homogeneous pipeline parallelism (classic PP with the template's channels)
# ---------------------------------------------------------------------------

class _GPipe(torch.autograd.Function):
    """GPipe over the ranks of ``comm``: the forward's ticks, and a backward
    that runs them in reverse.

    Inputs: ``stage_fn``, the parameter tree's structure, the
    :class:`Collectives`, the microbatches, then this rank's parameter
    leaves.  The forward runs without a graph and keeps each valid
    tick's stage input; the backward recomputes the stage from it
    (``torch.autograd.grad`` of ``stage_fn``), so a rank holds one
    microbatch's graph at a time.  Every rank shifts on every tick in
    both directions, so the ranks' sends and receives always pair up."""

    @staticmethod
    def forward(ctx, stage_fn, like, comm, mbs, *local):
        S, r, M = comm.size, comm.rank, mbs.shape[0]
        params = tree.unflatten(like, list(local))
        zero = torch.zeros_like(mbs[0])
        act, inputs = zero, [None] * M
        out = torch.empty_like(mbs)
        for t in range(M + S - 1):
            m = t - r
            y = zero
            if 0 <= m < M:
                x = mbs[m] if r == 0 else act
                y = stage_fn(params, x)
                if y.shape != x.shape or y.dtype != x.dtype:
                    raise ValueError(
                        f"stage_fn maps {tuple(x.shape)} {x.dtype} to "
                        f"{tuple(y.shape)} {y.dtype}; a stage must keep "
                        f"its input's shape and dtype")
                inputs[m] = x
                if r == S - 1:
                    out[m] = y
            act = comm.ppermute(y, hop=1)
        ctx.stage_fn, ctx.like, ctx.comm = stage_fn, like, comm
        ctx.inputs = inputs
        ctx.save_for_backward(*local)
        return comm.broadcast(out, S - 1)

    @staticmethod
    def backward(ctx, g_out):
        comm, stage_fn, like = ctx.comm, ctx.stage_fn, ctx.like
        S, r = comm.size, comm.rank
        M = g_out.shape[0]
        local = ctx.saved_tensors
        need_p = ctx.needs_input_grad[4:]
        need_x = r > 0 or ctx.needs_input_grad[3]
        g_local = [torch.zeros_like(p) if n else None
                   for p, n in zip(local, need_p)]
        g_mbs = torch.zeros_like(g_out) if ctx.needs_input_grad[3] else None
        zero = torch.zeros_like(g_out[0])
        g_in = zero
        for t in reversed(range(M + S - 1)):
            m = t - r
            g_x = zero
            if 0 <= m < M and (need_x or any(need_p)):
                # the last stage's output is the replicated result: its
                # gradient is this rank's own; the others' come one rank
                # back from the stage after
                g_y = g_out[m] if r == S - 1 else g_in
                with torch.enable_grad():
                    x = ctx.inputs[m].detach().requires_grad_(need_x)
                    ps = [p.detach().requires_grad_(n)
                          for p, n in zip(local, need_p)]
                    y = stage_fn(tree.unflatten(like, ps), x)
                    wrt = [x] * need_x + [p for p, n in zip(ps, need_p) if n]
                    grads = list(torch.autograd.grad(y, wrt, g_y,
                                                     allow_unused=True))
                if need_x:
                    gx = grads.pop(0)
                    g_x = zero if gx is None else gx
                    if r == 0 and g_mbs is not None:
                        g_mbs[m] = g_x
                for i in (i for i, n in enumerate(need_p) if n):
                    g = grads.pop(0)
                    if g is not None:
                        g_local[i] += g
            g_in = comm.ppermute(g_x, hop=-1)
        ctx.inputs = None
        return (None, None, None, g_mbs, *g_local)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, microbatches: torch.Tensor, *,
                   group: dist.ProcessGroup | None = None) -> torch.Tensor:
    """GPipe-style forward over ``S`` stages, stage *s* on rank *s* of
    ``group`` (default: the initialised world), ``S`` the group's size.

    SPMD: every rank calls it with the same arguments.  ``stage_params``
    is a tree whose leaves have a leading ``S`` axis; rank *r* moves only
    its slice ``p[r]`` to its device (the port's device policy, set per
    rank by :func:`repro_torch.launch.mesh.spawn`).  ``microbatches`` has
    shape ``(M, ...)``; ``stage_fn(p, x)`` keeps ``x``'s shape and dtype.
    Runs ``M + S - 1`` ticks; a rank calls ``stage_fn`` only on its valid
    ticks (``0 <= t - r < M``) and shifts its activation one rank on
    every tick.  Returns the ``(M, ...)`` outputs on every rank.

    Differentiable, as the reference's: the backward runs the ticks in
    reverse and shifts each activation gradient one rank back (GPipe's
    backward), recomputing each stage from its saved input.  The loss is
    replicated — every rank computes the same loss from the replicated
    output and calls backward — and the backward of the final
    replication is the identity on rank ``S - 1`` and zero elsewhere, so
    each rank's gradient is its own share: nonzero only in slice ``r``
    of each parameter leaf (and, on rank 0, for the microbatches); the
    sum over ranks is the full gradient.  An ``all_reduce`` of the
    output's gradient would make it ``S`` times too large."""
    comm = Collectives(group, get_device())
    S = comm.size
    leaves = tree.leaves(stage_params)
    for leaf in leaves:
        if leaf.shape[0] != S:
            raise ValueError(f"stage_params leaves need a leading axis of "
                             f"{S} (one slice per rank), got "
                             f"{tuple(leaf.shape)}")
    local = [leaf[comm.rank].to(comm.device) for leaf in leaves]
    return _GPipe.apply(stage_fn, stage_params, comm,
                        microbatches.to(comm.device), *local)


def pipeline_apply_emulated(
        stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
        stage_params: Any, microbatches: torch.Tensor,
        num_stages: int) -> torch.Tensor:
    """Schedule-exact single-device emulation of :func:`pipeline_apply`
    (differentiable by ``torch.autograd`` through the loop)."""
    S = num_stages
    M = microbatches.shape[0]
    acts = [torch.zeros_like(microbatches[0]) for _ in range(S)]
    outs: list[Any] = [None] * M
    for t in range(M + S - 1):
        new_acts = list(acts)
        for s in range(S):
            m = t - s
            if not 0 <= m < M:
                continue
            x = microbatches[m] if s == 0 else acts[s - 1]
            y = stage_fn(tree.tree_map(lambda q: q[s], stage_params), x)
            new_acts[s] = y
            if s == S - 1:
                outs[m] = y
        acts = new_acts
    return torch.stack(outs)


def gpipe_bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """Fill/drain overhead of the schedule (paper Fig. 2's ramp)."""
    return (num_stages - 1) / (num_microbatches + num_stages - 1)
