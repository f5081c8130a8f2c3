"""Access/execute decoupling: turn a :class:`Partition` into executable
stage functions connected by explicit channel values.

This is the analogue of the paper's §IV "hardware generation": each
pipeline stage's sub-CDFG is emitted as an independent unit ("synthesizable
C, one statement per LLVM instruction").  Here each stage becomes an
independent callable that interprets its lowered equations (one per FX
operation, or five for a scalar-index load) on torch tensors.  Cross-stage
values are the FIFO payloads.

The decoupled program is *semantically identical* to the original
function: :func:`run_stages_sequential` replays all stages in topological
order and is tested for exact equality against the direct call.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

from .cdfg import CDFG, Eqn, Literal
from .partition import Partition


@dataclasses.dataclass
class StageProgram:
    """An executable stage: ``fn(*inputs) -> tuple(outputs)``.

    ``in_vars`` / ``out_vars`` give the graph vars consumed / produced, in
    positional order.  ``in_from`` tags each input as coming from the
    original function arguments (``("arg", i)``), a constant
    (``("const", i)``) or an upstream channel (``("chan", var)``).
    """

    stage_id: int
    fn: Callable
    in_vars: list[Any]
    out_vars: list[Any]
    in_from: list[tuple]
    eqn_count: int


@dataclasses.dataclass
class DecoupledProgram:
    partition: Partition
    stages: list[StageProgram]
    #: (var) -> producing stage id, for channel routing
    producer_stage: dict[Any, int]
    out_sources: list[tuple]  # ("chan", var) | ("arg", i) | ("const", i)

    def __len__(self) -> int:
        return len(self.stages)


def _make_stage_fn(eqns: Sequence[Eqn], in_vars: Sequence[Any],
                   out_vars: Sequence[Any]) -> Callable:
    """Build an interpreter that replays ``eqns`` in order."""

    def fn(*args):
        env: dict[Any, Any] = dict(zip(in_vars, args))
        for eqn in eqns:
            invals = [v.val if isinstance(v, Literal) else env[v]
                      for v in eqn.invars]
            out = eqn.eval(*invals)
            if len(eqn.outvars) == 1:
                env[eqn.outvars[0]] = out
            else:                   # a scan: the carry and the state
                env.update(zip(eqn.outvars, out))
        return tuple(env[v] for v in out_vars)

    return fn


def decouple(partition: Partition) -> DecoupledProgram:
    """Emit one executable program per pipeline stage."""
    cdfg: CDFG = partition.cdfg
    graph = cdfg.graph
    invar_idx = {v: i for i, v in enumerate(graph.invars)}
    constvar_idx = {v: i for i, v in enumerate(graph.constvars)}

    # var -> producing node
    producer_node: dict[Any, int] = {}
    for n in cdfg.nodes:
        for ov in n.eqn.outvars:
            producer_node[ov] = n.id

    producer_stage: dict[Any, int] = {
        v: partition.stage_of_node[nid] for v, nid in producer_node.items()
    }

    out_needed_by_stage: dict[int, set] = {s.id: set() for s in
                                           partition.stages}
    for ov in graph.outvars:
        if isinstance(ov, Literal):
            continue
        if ov in producer_stage:
            out_needed_by_stage[producer_stage[ov]].add(ov)

    stages_programs: list[StageProgram] = []
    for stage in partition.stages:
        # §III-B1: prepend duplicated cheap producers
        dup_ids = [nid for nid, consumers in partition.duplicated.items()
                   if stage.id in consumers]
        eqn_ids = sorted(set(stage.node_ids) | set(dup_ids))
        eqns = [cdfg.node(nid).eqn for nid in eqn_ids]
        defined = {ov for e in eqns for ov in e.outvars}

        in_vars: list[Any] = []
        in_from: list[tuple] = []
        seen_in = set()
        for eqn in eqns:
            for iv in eqn.invars:
                if isinstance(iv, Literal) or iv in defined or iv in seen_in:
                    continue
                seen_in.add(iv)
                in_vars.append(iv)
                if iv in invar_idx:
                    in_from.append(("arg", invar_idx[iv]))
                elif iv in constvar_idx:
                    in_from.append(("const", constvar_idx[iv]))
                else:
                    src = producer_stage.get(iv)
                    if src is None or src == stage.id:
                        raise AssertionError(
                            f"stage {stage.id}: unresolved input {iv}")
                    in_from.append(("chan", iv))

        # outputs: vars produced here and consumed by later stages or final
        consumed_later = set()
        for e in cdfg.edges:
            if e.var is None:
                continue
            s_src = partition.stage_of_node.get(e.src)
            s_dst = partition.stage_of_node.get(e.dst)
            if s_src == stage.id and s_dst != stage.id:
                # consumers that received a duplicated copy don't need it
                if (e.src in partition.duplicated
                        and s_dst in partition.duplicated[e.src]):
                    continue
                consumed_later.add(e.var)
        out_vars = [v for v in sorted(
            consumed_later | out_needed_by_stage[stage.id],
            key=lambda v: producer_node.get(v, -1)) if v in defined]

        stages_programs.append(StageProgram(
            stage_id=stage.id,
            fn=_make_stage_fn(eqns, in_vars, out_vars),
            in_vars=in_vars,
            out_vars=out_vars,
            in_from=in_from,
            eqn_count=len(eqns),
        ))

    out_sources: list[tuple] = []
    for ov in graph.outvars:
        if isinstance(ov, Literal):
            out_sources.append(("lit", ov.val))
        elif ov in producer_stage:
            out_sources.append(("chan", ov))
        elif ov in invar_idx:
            out_sources.append(("arg", invar_idx[ov]))
        else:
            out_sources.append(("const", constvar_idx[ov]))

    return DecoupledProgram(partition, stages_programs, producer_stage,
                            out_sources)


def run_stages_sequential(prog: DecoupledProgram, *args: Any) -> tuple:
    """Semantic-equivalence executor: replay stages in order, materializing
    channel values.  Must produce bit-identical results to the original
    function (this is the correctness oracle for the pipeline executors)."""
    consts = prog.partition.cdfg.graph.consts
    chan_env: dict[Any, Any] = {}
    for sp in prog.stages:
        ins = []
        for (tag, ref), var in zip(sp.in_from, sp.in_vars):
            if tag == "arg":
                ins.append(args[ref])
            elif tag == "const":
                ins.append(consts[ref])
            else:
                ins.append(chan_env[var])
        outs = sp.fn(*ins)
        for v, o in zip(sp.out_vars, outs):
            chan_env[v] = o
    results = []
    for tag, ref in prog.out_sources:
        if tag == "chan":
            results.append(chan_env[ref])
        elif tag == "arg":
            results.append(args[ref])
        elif tag == "const":
            results.append(consts[ref])
        else:
            results.append(ref)
    return tuple(results)
