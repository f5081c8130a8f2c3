"""Dataflow pipeline executor — the template's systolic schedule.

:class:`SystolicPipeline` runs a
:class:`~repro_torch.core.decouple.DecoupledProgram` stage by stage over
microbatches: stage *s* processes microbatch *m* at tick ``t = m + s`` and
hands its channel payload, packed into one fixed-width word, to stage
*s+1* for the next tick — exactly the paper's Fig. 2 schedule, where a
stall in one stage does not halt the others.

This slice ports the single-device, schedule-exact emulation
(:meth:`SystolicPipeline.run_emulated`).  The multi-device executors (one
stage per GPU, and the homogeneous GPipe ``pipeline_apply``) arrive with
the multi-device slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import torch

from .channels import WORD, ChannelSpec
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


def gpipe_bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """Fill/drain overhead of the schedule (paper Fig. 2's ramp)."""
    return (num_stages - 1) / (num_microbatches + num_stages - 1)
