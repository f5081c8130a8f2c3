"""The pass pipeline of the dataflow compiler driver.

Each pass is a named object with a ``run(ctx)`` method that reads/writes
fields of a shared :class:`CompileContext`.  The default pipeline mirrors
the paper's flow —

    trace → memdep → transform → partition → rewrite → dse → decouple → schedule

(``transform`` is a no-op unless ``options.transforms`` activates the
HLS transformation catalog — see ``repro_torch.dataflow.transforms`` — and
``dse`` is a no-op unless ``options.dse`` opts into partition-space
exploration) — with each step delegating to the corresponding
``repro_torch.core`` function.  Pipelines are ordinary
immutable value objects: ``default_pipeline().replace("partition",
MyPartitionPass())`` swaps a pass, ``.without("rewrite")`` drops one,
``.insert_after(...)`` adds one.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Sequence

import torch
import torch.utils._pytree as pytree

from .._device import get_device
from ..core.cdfg import (CDFG, Graph, add_memory_order_edges,
                         annotate_memory_regions, carry_pairs, trace)
from ..core.decouple import decouple
from ..core.partition import (duplicate_cheap_rewrite,
                              materialize, merge_costly_boundaries,
                              stage_groups)
from .options import CompileOptions
from .schedule import Schedule


@dataclasses.dataclass
class CompileContext:
    """Mutable state threaded through the pass pipeline."""

    fn: Callable
    example_args: tuple
    options: CompileOptions
    #: the compile device; unset, the port's default (``set_device``),
    #: which is the card unless the caller asked for the CPU
    device: torch.device = dataclasses.field(default_factory=get_device)
    graph: Graph | None = None
    #: pytree specs of the example arguments (whose leaves are
    #: ``graph.invars``, in order) and of the outputs
    in_tree: Any = None
    out_tree: Any = None
    cdfg: CDFG | None = None
    plan: Any = None            # StagePlan from the partition pass
    partition: Any = None
    program: Any = None         # DecoupledProgram
    schedule: Schedule | None = None
    dse_result: Any = None
    timings: dict[str, float] = dataclasses.field(default_factory=dict)
    #: pass name -> verifier findings recorded by the inter-pass hook
    diagnostics: dict[str, list] = dataclasses.field(default_factory=dict)


def to_device(args: Any, device: torch.device) -> Any:
    """``args`` with every tensor leaf moved to ``device`` (tuples and
    lists kept, nested or not)."""
    return pytree.tree_map(
        lambda a: a.to(device) if isinstance(a, torch.Tensor) else a, args)


def flat_argnums(args: Sequence[Any], argnums: Sequence[int]) -> tuple:
    """The positions among the leaves of ``args`` of the leaves of the
    arguments at ``argnums`` (a tuple argument spans several)."""
    out, start = [], 0
    for i, a in enumerate(args):
        n = len(pytree.tree_leaves(a))
        if i in argnums:
            out.extend(range(start, start + n))
        start += n
    return tuple(out)


class Pass:
    """Base class for driver passes; subclasses set ``name``."""

    name = "pass"

    def run(self, ctx: CompileContext) -> None:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<{type(self).__name__} {self.name!r}>"


class TracePass(Pass):
    """Front end: ``torch.fx`` trace, lowering, and the raw CDFG (SSA data
    edges only).  Example tensors are moved to the compile device, and
    every closed-over tensor must already live there.

    Tuple arguments (nested or not) are flattened, one graph input per
    leaf.  With ``options.loop`` the function is a loop body
    ``body(carry, *xs)``, and carry back-edges are added per leaf of the
    carry example, minus ``nonaliasing_carries`` (the §III-A user
    annotation) — the cyclic §III view.
    """

    name = "trace"

    def run(self, ctx: CompileContext) -> None:
        opts = ctx.options
        args = to_device(ctx.example_args, ctx.device)
        ctx.graph, ctx.out_tree = trace(ctx.fn, *args)
        ctx.in_tree = pytree.tree_structure(args)
        for cv, c in zip(ctx.graph.constvars, ctx.graph.consts):
            if c.device.type != ctx.device.type:
                raise ValueError(
                    f"closed-over tensor {cv.name} lies on {c.device}, but "
                    f"the program is compiled for {ctx.device}")
        pairs: Sequence[tuple[int, int]] = ()
        if opts.loop and args:
            pairs = carry_pairs(args[0], opts.nonaliasing_carries)
        ctx.cdfg = CDFG.from_graph(
            ctx.graph,
            latency_model=opts.latency_model(),
            add_memory_edges=False,
            annotate_regions=False,
            carry_pairs=pairs,
        )


class MemoryDepPass(Pass):
    """§III-A memory-dependence analysis: region discovery + ordering
    edges between memory ops of a shared region."""

    name = "memdep"

    def run(self, ctx: CompileContext) -> None:
        regions = ctx.options.regions_map() or None
        annotate_memory_regions(ctx.cdfg, regions)
        if ctx.options.add_memory_edges:
            add_memory_order_edges(ctx.cdfg)


class TransformPass(Pass):
    """The HLS transformation catalog (``repro_torch.dataflow.transforms``):
    validate ``options.transforms`` against the analyzed CDFG and annotate
    the CDFG with the active config.  No-op when ``options.transforms``
    is unset or the identity."""

    name = "transform"

    def run(self, ctx: CompileContext) -> None:
        cfg = getattr(ctx.options, "transforms", None)
        if cfg is None or cfg.is_identity:
            ctx.cdfg.transforms = None
            return
        cfg.validate(ctx.cdfg)
        ctx.cdfg.transforms = cfg


class PartitionPass(Pass):
    """Algorithm 1: SCCs → condensation → topo order → stage groups,
    materialized into a Partition with FIFO channels.  When the active
    transform config asks for memory-port re-association, the plan's
    multi-region stages are split by region first."""

    name = "partition"

    def run(self, ctx: CompileContext) -> None:
        ctx.plan = stage_groups(ctx.cdfg, policy=ctx.options.policy)
        cfg = getattr(ctx.cdfg, "transforms", None)
        if cfg is not None and cfg.reassoc:
            from .transforms import split_by_region
            ctx.plan = split_by_region(ctx.cdfg, ctx.plan)
        ctx.partition = materialize(ctx.cdfg, ctx.plan)


class RewritePass(Pass):
    """Post-partition rewrites: cost-aware boundary merging (for the
    ``cost_aware`` policy) and §III-B1 cheap-op duplication; channels are
    re-derived afterwards."""

    name = "rewrite"

    def run(self, ctx: CompileContext) -> None:
        opts = ctx.options
        if opts.policy == "cost_aware" and len(ctx.plan.groups) > 1:
            ctx.plan = merge_costly_boundaries(
                ctx.cdfg, ctx.plan, opts.channel_cost_bytes)
            ctx.partition = materialize(ctx.cdfg, ctx.plan)
        if opts.duplicate_cheap and opts.policy != "fused":
            duplicate_cheap_rewrite(ctx.partition)


class DsePass(Pass):
    """Partition-space design-space exploration (no-op unless
    ``options.dse`` is set): enumerate legal merge/split/duplicate
    re-partitionings of the Algorithm 1 plan, prune against the
    :class:`~repro_torch.dataflow.options.ResourceConstraints` resource
    model, simulate every survivor (synthetic per-region traces — supply
    real traces through ``Compiled.explore``), and re-partition onto the
    constrained-best candidate.  The full exploration is kept on
    ``ctx.dse_result`` / ``Compiled.dse_result``."""

    name = "dse"

    def run(self, ctx: CompileContext) -> None:
        rc = ctx.options.dse
        if rc is None:
            return
        from . import dse as _dse
        result = _dse.explore_plans(
            ctx.cdfg, ctx.plan, constraints=rc,
            duplicate_base=ctx.options.duplicate_cheap)
        ctx.dse_result = result
        best = result.best()
        if best.plan is not None and best is not result.baseline:
            from ..core.partition import (duplicate_cheap_rewrite,
                                          materialize)
            from .transforms import IDENTITY
            ctx.plan = best.plan
            tf = getattr(best, "tf", None)
            ctx.cdfg.transforms = tf if tf is not None \
                and not tf.is_identity else None
            ctx.partition = materialize(
                ctx.cdfg, best.plan,
                transforms=tf if tf is not None else IDENTITY)
            if best.duplicate:
                duplicate_cheap_rewrite(ctx.partition)


class DecouplePass(Pass):
    """Access/execute decoupling: one executable program per stage."""

    name = "decouple"

    def run(self, ctx: CompileContext) -> None:
        ctx.program = decouple(ctx.partition)


class SchedulePass(Pass):
    """Static schedule analysis: per-stage summaries (II, latency,
    memory-in-SCC), channel totals, and the lazily-built systolic
    executor. Feeds ``Compiled.report()`` / ``.simulate()``."""

    name = "schedule"

    def run(self, ctx: CompileContext) -> None:
        ctx.schedule = Schedule.from_program(
            ctx.program, stream_argnums=flat_argnums(
                ctx.example_args, ctx.options.stream_argnums))


@dataclasses.dataclass(frozen=True)
class PassPipeline:
    """An ordered, inspectable sequence of passes."""

    passes: tuple[Pass, ...]

    def __post_init__(self) -> None:
        object.__setattr__(self, "passes", tuple(self.passes))
        names = self.names()
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate pass names: {names}")

    def names(self) -> list[str]:
        return [p.name for p in self.passes]

    def __iter__(self):
        return iter(self.passes)

    def __getitem__(self, name: str) -> Pass:
        for p in self.passes:
            if p.name == name:
                return p
        raise KeyError(name)

    def index(self, name: str) -> int:
        for i, p in enumerate(self.passes):
            if p.name == name:
                return i
        raise KeyError(name)

    # -- structural edits (return new pipelines) -----------------------------

    def replace(self, name: str, new_pass: Pass) -> "PassPipeline":
        i = self.index(name)
        return PassPipeline(self.passes[:i] + (new_pass,)
                            + self.passes[i + 1:])

    def without(self, name: str) -> "PassPipeline":
        i = self.index(name)
        return PassPipeline(self.passes[:i] + self.passes[i + 1:])

    def insert_after(self, name: str, new_pass: Pass) -> "PassPipeline":
        i = self.index(name)
        return PassPipeline(self.passes[:i + 1] + (new_pass,)
                            + self.passes[i + 1:])

    # -- execution ------------------------------------------------------------

    def run(self, ctx: CompileContext, *, start: int = 0,
            stop: int | None = None) -> CompileContext:
        from . import verify as _verify
        check = _verify.enabled(ctx.options)
        for p in self.passes[start:stop]:
            t0 = time.perf_counter()
            p.run(ctx)
            ctx.timings[p.name] = time.perf_counter() - t0
            if check:
                # inter-pass IR verification: an error here names the
                # pass that broke an invariant
                _verify.verify_ctx(ctx, p.name)
        return ctx

    def signature(self) -> tuple:
        """Identity of the pipeline structure, for cache keying."""
        return tuple((p.name, type(p).__module__ + "." + type(p).__qualname__)
                     for p in self.passes)


def default_pipeline() -> PassPipeline:
    return PassPipeline((TracePass(), MemoryDepPass(), TransformPass(),
                         PartitionPass(), RewritePass(), DsePass(),
                         DecouplePass(), SchedulePass()))
