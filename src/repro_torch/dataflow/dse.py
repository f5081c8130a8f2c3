"""Partition-space design-space exploration over :class:`StagePlan`s.

Algorithm 1 fixes *one* partitioning rule — cut after every memory op or
long SCC — but the quality of the dataflow template under area/FIFO
constraints depends on *which* partition you pick: HIDA (Ye et al.,
2023) shows hierarchical dataflow DSE over partitions is where the real
wins are, and de Fine Licht et al. (2018) catalog the merge / split /
duplicate transformations such a search must enumerate.  This module is
that explorer for the template:

1. **Enumerate** — BFS over the legal single moves (adjacent-stage
   merges, interior splits; SCCs are never split and topological order
   is preserved by construction — see
   :func:`repro_torch.core.partition.neighbor_plans`) from the Algorithm 1
   plan, with the ``fused`` / ``maximal`` degenerate plans always
   included; the §III-B1 cheap-op duplication rewrite is a per-candidate
   toggle (the *duplicate* move), and the HLS transformation catalog
   (:mod:`repro_torch.dataflow.transforms` — unroll/vectorize, access
   coalescing, memory-port re-association) adds per-candidate transform
   lanes plus a re-associated plan seed.
2. **Prune** — against :class:`~repro_torch.dataflow.options.ResourceConstraints`:
   total FIFO bits, per-stage memory-port count, duplication budget,
   stage count.  Pruned candidates are never simulated.
3. **Evaluate** — every survivor runs through the *real* cycle
   simulator (no analytic shortcut).  Candidate partitions of one
   kernel regroup the same memory ops, so the per-op rescache keying
   (:mod:`repro_torch.core.rescache`) lets every candidate after the first
   serve its trace resolution from cache: DSE over many candidates
   costs little more than one cold simulation, with cycle counts
   bit-identical to fresh per-candidate runs.
4. **Select** — the cycles-vs-FIFO-bits Pareto front, each front point
   materialized as a full :class:`~repro_torch.dataflow.driver.Compiled`
   artifact (``Compiled.explore``), or the constrained-best plan
   compiled in place (the ``dse`` pass, ``dataflow_jit(..., dse=...)``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Mapping, Sequence

import numpy as np

from ..core.cdfg import CDFG
from ..core.partition import (StagePlan, Partition, materialize,
                              duplicate_cheap_rewrite, fused_plan,
                              maximal_plan, neighbor_plans, plan_is_legal,
                              plan_signature)
from ..core.simulator import (MemAccess, MemoryModel, SimStage,
                              standard_memory_models)
from .options import ResourceConstraints
from .schedule import _cyclic_nodes


# ---------------------------------------------------------------------------
# Enumeration
# ---------------------------------------------------------------------------


def enumerate_plans(cdfg: CDFG, base_plan: StagePlan,
                    max_plans: int, *,
                    reassoc: bool = False) -> list[tuple[tuple[str, ...],
                                                         StagePlan]]:
    """Breadth-first closure of the merge/split move set from
    ``base_plan``, deduplicated by :func:`plan_signature` and capped at
    ``max_plans``.  The fused and maximal degenerate plans are seeded
    explicitly so they are reachable at any budget; ``reassoc=True``
    additionally seeds the memory-port re-association split
    (:func:`repro_torch.dataflow.transforms.split_by_region` — multi-region
    stages split by region, the documented DSE gap).  Returns
    ``(moves, plan)`` pairs; the base plan is first with an empty move
    list."""
    from collections import deque

    seeds = [("fused", fused_plan(base_plan)),
             ("maximal", maximal_plan(base_plan))]
    if reassoc:
        from .transforms import split_by_region
        seeds.insert(0, ("reassoc", split_by_region(cdfg, base_plan)))
    out: list[tuple[tuple[str, ...], StagePlan]] = [((), base_plan)]
    seen = {plan_signature(base_plan)}
    for tag, p in seeds:
        sig = plan_signature(p)
        if sig not in seen and plan_is_legal(cdfg, p):
            seen.add(sig)
            out.append(((tag,), p))
    queue = deque([((), base_plan)])
    while queue and len(out) < max_plans:
        moves, plan = queue.popleft()
        for tag, nb in neighbor_plans(plan):
            sig = plan_signature(nb)
            if sig in seen or not plan_is_legal(cdfg, nb):
                continue
            seen.add(sig)
            rec = (moves + (tag,), nb)
            out.append(rec)
            queue.append(rec)
            if len(out) >= max_plans:
                break
    return out


# ---------------------------------------------------------------------------
# Resource model
# ---------------------------------------------------------------------------


def partition_resources(part: Partition, fifo_depth: int) -> dict:
    """The resource footprint the constraints prune against: channel
    payload bits, total FIFO storage at ``fifo_depth``, the widest
    stage's memory-port count (one access interface per region), and the
    §III-B1 duplication count (replica instances across stages)."""
    channel_bits = sum(c.nbytes for c in part.channels) * 8
    return {
        "num_stages": len(part.stages),
        "num_channels": len(part.channels),
        "channel_bits": channel_bits,
        "fifo_bits": fifo_depth * channel_bits,
        "max_mem_ports": max((len(s.regions) for s in part.stages),
                             default=0),
        "duplicated_nodes": sum(len(v)
                                for v in part.duplicated.values()),
    }


def constraint_violation(res: Mapping[str, int],
                         rc: ResourceConstraints) -> str | None:
    """First violated limit as a human-readable reason, or None."""
    checks = (
        ("fifo_bits", rc.max_fifo_bits),
        ("max_mem_ports", rc.max_mem_ports_per_stage),
        ("duplicated_nodes", rc.max_duplicated_nodes),
        ("num_stages", rc.max_stages),
    )
    for field, limit in checks:
        if limit is not None and res[field] > limit:
            return f"{field} {res[field]} > {limit}"
    return None


# ---------------------------------------------------------------------------
# Candidate evaluation
# ---------------------------------------------------------------------------


def traces_by_node(cdfg: CDFG, base_partition: Partition,
                   traces: Any = None, *, n_iters: int = 4096,
                   seed: int = 0,
                   address_space: int = 4 << 20) -> dict[int,
                                                         list[MemAccess]]:
    """Pin address traces to memory *nodes* so every candidate partition
    sees identical traffic no matter how it groups the ops.

    Deliberate deviation from ``Schedule.sim_stages``: that bridge
    attaches traces per (stage, region), so merging two stages that
    touch one region would *drop* traffic mid-search; here each memory
    node keeps its stream across candidates (conserved traffic, honest
    comparisons).  For kernels where several ops share a region the two
    bridges therefore model different traffic — compare DSE cycles
    against DSE cycles, not against ``Compiled.simulate()``.

    Trace conventions accepted (same shapes as ``sim_stages``):

    * ``None`` — synthetic uniform-random **byte** addresses, one stream
      per region (the cache-hostile default);
    * a mapping ``region -> MemAccess | [MemAccess]`` — a single trace
      is shared by all of the region's ops; a list is assigned
      positionally to the region's ops in node order;
    * a sequence of :class:`MemAccess` — positional, over memory nodes
      in the *baseline* partition's pipeline order (the Fig. 5
      benchmark convention).
    """
    mem_nodes = [nid for st in base_partition.stages
                 for nid in st.node_ids if cdfg.node(nid).is_memory]
    out: dict[int, list[MemAccess]] = {}
    if traces is not None and not isinstance(traces, Mapping):
        # A shorter list leaves trailing memory ops traffic-less — the
        # established ``sim_stages`` convention (the paper kernels
        # supply one stream per *distinct* traffic source, not per op),
        # applied identically to every candidate so comparisons stay
        # apples-to-apples.
        for nid, tr in zip(mem_nodes, list(traces)):
            out[nid] = [tr]
        return out
    rng = np.random.default_rng(seed)
    by_region: dict[str, Any] = dict(traces or {})
    assigned: dict[str, int] = {}
    for nid in mem_nodes:
        region = cdfg.node(nid).region
        if region is None:
            continue
        tr = by_region.get(region)
        if tr is None and traces is None:
            tr = MemAccess(region,
                           rng.integers(0, address_space, n_iters) * 4)
            by_region[region] = tr
        if tr is None:
            continue
        if isinstance(tr, MemAccess):
            out[nid] = [tr]
        else:  # list: positional among the region's ops, last one reused
            i = assigned.get(region, 0)
            assigned[region] = i + 1
            out[nid] = [tr[min(i, len(tr) - 1)]]
    return out


def sim_stages_for_partition(part: Partition,
                             node_traces: Mapping[int, list[MemAccess]],
                             cyclic_mem: set[int]) -> list[SimStage]:
    """Cycle-simulator stage specs for one candidate partition: II and
    latency from the materialized (and possibly duplicated-into) stages,
    traces attached per memory node, ``mem_in_scc`` from the CDFG's
    cyclic memory nodes (partition-independent)."""
    out: list[SimStage] = []
    for st in part.stages:
        accs = [t for nid in st.node_ids
                for t in node_traces.get(nid, ())]
        out.append(SimStage(
            name=f"s{st.id}",
            ii=st.ii,
            latency=max(1, st.latency),
            accesses=accs,
            mem_in_scc=bool(cyclic_mem & set(st.node_ids)),
        ))
    return out


def evaluate_candidates(
    stage_lists: Sequence[Sequence[SimStage]],
    mem: MemoryModel,
    n_iters: int,
    *,
    fifo_depth: int | None = None,
    fifo_depths: Sequence[int] | None = None,
    depth_lists: Sequence[Sequence[int]] | None = None,
    n_iters_list: Sequence[int] | None = None,
    seed: int = 0,
    use_rescache: bool | None = None,
    chunk_iters: int | None = None,
    depth_incremental: bool = True,
) -> tuple[list[dict[int, int]], dict]:
    """Simulate many candidate stage decompositions of *one* kernel —
    each over a grid of FIFO depths — in a single chunk-major streaming
    pass.

    Candidates are grouped by their per-op resolution key: each distinct
    group resolves its traces once (served from the chunk-granular
    rescache when possible — any stored prefix counts — and written
    back when not), and every candidate then only pays the cheap
    per-stage fold plus one wavefront solve per depth.  Depths are
    solved deepest-first with the depth-incremental warm start, so
    gridding depth costs little more than one solve per candidate.
    Iterating chunk-major keeps the per-trace window/burst memos hot,
    so sibling candidates regenerate nothing.  Cycle counts are
    bit-identical to stand-alone
    :func:`repro_torch.core.simulator.simulate_dataflow` runs (same canonical
    access order, same draw streams — asserted in tests).

    Depths per candidate come from ``depth_lists`` (one sequence per
    candidate), else the shared ``fifo_depths``, else the single
    ``fifo_depth`` (default 8).  ``n_iters_list`` gives per-candidate
    iteration counts (transformed candidates stream
    ``tokens(n_iters) = ceil(n/U)`` channel tokens, so a mixed
    transformed/untransformed batch runs shorter lanes alongside the
    full-length ones; the shared chunk grid is clamped per candidate, so
    every lane sees exactly the chunk boundaries a stand-alone run of
    its own length would).  Returns ``(per-candidate {depth: cycles}
    dicts, stats)``.
    """
    from ..core import rescache as _rc
    from ..core.simulator import (DEFAULT_CHUNK_ITERS, _LaneSolver,
                                  _OpFolder, _ResolutionPlan,
                                  _ResolvedChunk, _ServeLost,
                                  _chunk_bounds, _fold_stage)
    chunk_iters = chunk_iters or DEFAULT_CHUNK_ITERS
    if depth_lists is None:
        shared = tuple(fifo_depths) if fifo_depths is not None \
            else (fifo_depth if fifo_depth is not None else 8,)
        depth_lists = [shared] * len(stage_lists)
    if n_iters_list is None:
        n_iters_list = [n_iters] * len(stage_lists)
    max_n = max(n_iters_list, default=n_iters)
    if max_n <= 0 or not stage_lists:
        return [{d: 0 for d in ds} for ds in depth_lists], \
            {"resolution_groups": 0, "cold_groups": 0}

    def _run(rescache_override: bool | None) -> tuple[list[dict[int,
                                                                int]],
                                                      dict]:
        # candidates sharing a resolution key always share an iteration
        # count (same op streams ⇒ same transform ⇒ same token count),
        # but key on both so a pathological mix stays correct
        groups: dict[tuple, dict] = {}
        gids: list[tuple] = []
        for stages, g_n in zip(stage_lists, n_iters_list):
            gid = (_rc.resolution_key("dataflow", stages, mem, seed), g_n)
            gids.append(gid)
            if gid not in groups:
                groups[gid] = {
                    "stages": stages,
                    "n": g_n,
                    "plan": _ResolutionPlan(
                        "dataflow", stages, {mem.name: mem}, seed,
                        g_n, rescache_override)}
        folders = [_OpFolder(st) for st in stage_lists]
        solvers = [{d: _LaneSolver(st, d, collect_stalls=False)
                    for d in ds}
                   for st, ds in zip(stage_lists, depth_lists)]
        align = _rc.CHUNK_ITERS if _rc.enabled(rescache_override) \
            else None
        zeros: dict[int, np.ndarray] = {}
        for lo, hi in _chunk_bounds(max_n, chunk_iters, align):
            for g in groups.values():
                if lo >= g["n"]:
                    continue
                hi_g = min(hi, g["n"])
                plan = g["plan"]
                chunks = plan.advance(lo, hi_g)
                if mem.name in plan.served:
                    g["L"] = plan.served[mem.name].chunk(lo, hi_g)
                    g["spec_chunk"] = None
                    _rc.note_chunks(served=1)
                elif plan.live_chunk_is_served(lo):
                    g["L"] = plan.live_ops(mem.name, lo, hi_g)
                    g["spec_chunk"] = None
                else:
                    g["spec_chunk"] = chunks[mem.name]
                    g["L"] = plan.resolver.last_ops[mem.name]

                # contiguous column views, shared by every candidate of
                # the group this chunk
                def _mk_col(L: np.ndarray, cc: dict) -> Any:
                    def col(k: int) -> np.ndarray:
                        a = cc.get(k)
                        if a is None:
                            a = cc[k] = np.ascontiguousarray(L[:, k])
                        return a
                    return col
                g["col"] = _mk_col(g["L"], {})
            # candidates mostly differ in one or two stages: fold each
            # distinct (group, op set, ii, serialized) stage once per
            # chunk
            fold_cache: dict[tuple, tuple] = {}
            for i, folder in enumerate(folders):
                if lo >= n_iters_list[i]:
                    continue
                g = groups[gids[i]]
                hi_g = min(hi, g["n"])
                n = hi_g - lo
                zero = zeros.get(n)
                if zero is None:
                    zero = zeros[n] = np.zeros(n, dtype=np.int32)
                if g["spec_chunk"] is not None \
                        and g["stages"] is stage_lists[i]:
                    res = g["spec_chunk"]  # group spec: already folded
                else:
                    bw = None
                    c_list, lat_list = [], []
                    for s, st in enumerate(stage_lists[i]):
                        key = (gids[i], tuple(folder.stage_cols[s]),
                               st.ii, st.mem_in_scc)
                        hit = fold_cache.get(key)
                        if hit is None:
                            if bw is None:
                                bw = folder.burst_words(lo, hi_g,
                                                        mem.line_bytes)
                            hit = _fold_stage(
                                mem, st.ii, st.mem_in_scc,
                                folder.stage_cols[s], g["col"], bw[s],
                                folder.is_store, n, zero)
                            fold_cache[key] = hit
                        c_list.append(hit[0])
                        lat_list.append(hit[1])
                    res = _ResolvedChunk(lo, hi_g, c_list, lat_list)
                warm = None
                for d in sorted(solvers[i], reverse=True):
                    warm = solvers[i][d].solve_chunk(
                        res, warm=warm if depth_incremental else None)
        stats = {"resolution_groups": len(groups),
                 "cold_groups": sum(
                     1 for g in groups.values()
                     if g["plan"].resolver is not None)}
        return [{d: int(sv.last_finish) for d, sv in by_depth.items()}
                for by_depth in solvers], stats

    try:
        return _run(use_rescache)
    except _ServeLost:  # raced store eviction: redo the pass cold
        return _run(False)


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DseCandidate:
    """One explored (plan, duplicate-toggle, transform, memory-model,
    FIFO-depth) point."""

    groups: tuple[tuple[int, ...], ...]   # plan signature (node-id groups)
    moves: tuple[str, ...]
    duplicate: bool
    resources: dict
    fifo_depth: int = 8
    cycles: int | None = None             # None => pruned, not simulated
    pruned: str | None = None
    pareto: bool = False
    compiled: Any = None                  # Compiled, attached on the front
    plan: StagePlan | None = dataclasses.field(default=None, repr=False)
    #: transform-config signature ("none" = untransformed); ``tf`` keeps
    #: the config object for re-materialization
    transform: str = "none"
    tf: Any = dataclasses.field(default=None, repr=False)
    #: memory model this point was simulated on (multi-mem fronts)
    mem_name: str = ""
    #: channel tokens simulated (== n_iters unless unrolled)
    n_tokens: int | None = None
    #: static deadlock bound for this candidate's stage chain (the
    #: smallest uniform FIFO depth that cannot statically collapse the
    #: pipeline — ``repro_torch.dataflow.verify.chain_deadlock_bound``);
    #: depths below it are pruned pre-simulation when verification is
    #: on, and ``bench_trend`` asserts no front point ever sits below
    #: its own bound (the analysis soundness guard)
    deadlock_min_depth: int | None = None

    @property
    def fifo_bits(self) -> int:
        return self.resources["fifo_bits"]

    def to_json(self) -> dict:
        return {
            "moves": list(self.moves),
            "duplicate": self.duplicate,
            "fifo_depth": self.fifo_depth,
            "transform": self.transform,
            "mem": self.mem_name,
            "n_tokens": self.n_tokens,
            "cycles": self.cycles,
            "pruned": self.pruned,
            "deadlock_min_depth": self.deadlock_min_depth,
            "pareto": self.pareto,
            **{k: self.resources[k]
               for k in ("num_stages", "num_channels", "fifo_bits",
                         "max_mem_ports", "duplicated_nodes")},
        }


@dataclasses.dataclass
class DseResult:
    """The explored partition space: every candidate, the baseline
    (Algorithm 1 as configured), and the cycles-vs-FIFO-bits Pareto
    front.  ``Compiled.explore`` attaches a full ``Compiled`` artifact
    to each front candidate (``cand.compiled``)."""

    baseline: DseCandidate
    candidates: list[DseCandidate]
    front: list[DseCandidate]
    n_iters: int
    fifo_depth: int
    mem_name: str
    #: the explored FIFO-depth axis (a single entry unless the joint
    #: partition×depth front was requested via ``fifo_depths=...``)
    fifo_depths: tuple = ()
    wall_s: float = 0.0
    rescache_hits: int = 0
    rescache_misses: int = 0
    #: from evaluate_candidates: distinct resolution groups / cold ones
    eval_stats: dict = dataclasses.field(default_factory=dict)
    #: memory models spanned (multi-mem fronts; first = primary)
    mem_names: tuple = ()
    #: transform-config signatures explored alongside the baseline's
    transforms: tuple = ()

    def evaluated(self) -> list[DseCandidate]:
        return [c for c in self.candidates if c.cycles is not None]

    def best(self) -> DseCandidate:
        """Feasible candidate minimizing (cycles, fifo_bits) on the
        *primary* memory model; the baseline when nothing else was
        evaluated."""
        ev = [c for c in self.evaluated() if c.pruned is None
              and c.mem_name == self.mem_name]
        if not ev:
            return self.baseline
        return min(ev, key=lambda c: (c.cycles, c.fifo_bits))

    def dominates_baseline(self) -> bool:
        """Does some candidate strictly dominate Algorithm 1's plan —
        fewer cycles at ≤ the FIFO bits, or ≤ cycles at fewer bits?
        Compared on the baseline's memory model only (cross-model cycle
        counts are not comparable)."""
        b = self.baseline
        if b.cycles is None:
            return bool(self.evaluated())
        return any(
            (c.cycles < b.cycles and c.fifo_bits <= b.fifo_bits)
            or (c.cycles <= b.cycles and c.fifo_bits < b.fifo_bits)
            for c in self.evaluated() if c is not b
            and c.mem_name == b.mem_name)

    def transformed_dominates(self) -> bool:
        """Does some *transformed* candidate strictly dominate the best
        untransformed point — fewer cycles at equal-or-lower FIFO bits —
        on any explored memory model?  This is the widened-front gate
        ``bench_trend.py`` enforces (a transformed front that stops
        dominating the stage-regrouping-only front is a regression)."""
        base_sig = self.baseline.transform
        ev = [c for c in self.evaluated() if c.pruned is None]
        for mn in self.mem_names or (self.mem_name,):
            unt = [c for c in ev if c.mem_name == mn
                   and c.transform == base_sig]
            tfc = [c for c in ev if c.mem_name == mn
                   and c.transform != base_sig]
            if not unt or not tfc:
                continue
            u = min(unt, key=lambda c: (c.cycles, c.fifo_bits))
            if any(t.cycles < u.cycles and t.fifo_bits <= u.fifo_bits
                   for t in tfc):
                return True
        return False

    def to_json(self) -> dict:
        return {
            "n_iters": self.n_iters,
            "fifo_depth": self.fifo_depth,
            "fifo_depths": list(self.fifo_depths or (self.fifo_depth,)),
            "mem": self.mem_name,
            "mems": list(self.mem_names or (self.mem_name,)),
            "transforms": list(self.transforms),
            "wall_s": self.wall_s,
            "rescache_hits": self.rescache_hits,
            "rescache_misses": self.rescache_misses,
            **self.eval_stats,
            "dominates_baseline": self.dominates_baseline(),
            "transformed_dominates": self.transformed_dominates(),
            "baseline": self.baseline.to_json(),
            "best": self.best().to_json(),
            "front": [c.to_json() for c in self.front],
            "candidates": [c.to_json() for c in self.candidates],
        }

    def summary(self) -> str:
        ev = self.evaluated()
        lines = [
            f"partition DSE: {len(self.candidates)} candidates "
            f"({len(ev)} simulated at {self.n_iters} iters on "
            f"{self.mem_name!r}, fifo_depth={self.fifo_depth}; "
            f"rescache {self.rescache_hits} hits / "
            f"{self.rescache_misses} misses)",
            f"  baseline (Algorithm 1): {self.baseline.cycles} cycles @ "
            f"{self.baseline.fifo_bits} FIFO bits, "
            f"{self.baseline.resources['num_stages']} stages",
        ]
        multi_depth = len(set(self.fifo_depths
                              or (self.fifo_depth,))) > 1
        multi_mem = len(set(self.mem_names or (self.mem_name,))) > 1
        for c in self.front:
            tag = " <- baseline" if c is self.baseline else ""
            depth = f", depth={c.fifo_depth}" if multi_depth else ""
            mm = f", mem={c.mem_name}" if multi_mem else ""
            tf = f", tf={c.transform}" if c.transform != "none" else ""
            lines.append(
                f"  front: {c.cycles} cycles @ {c.fifo_bits} bits "
                f"({c.resources['num_stages']} stages, dup="
                f"{c.duplicate}{depth}{mm}{tf}, moves="
                f"{'/'.join(c.moves) or 'none'}){tag}")
        b = self.best()
        lines.append(
            f"  best: {b.cycles} cycles @ {b.fifo_bits} bits "
            f"(moves={'/'.join(b.moves) or 'none'}, dup={b.duplicate})"
            + ("  [strictly dominates Algorithm 1]"
               if self.dominates_baseline() else "")
            + ("  [transformed front dominates untransformed]"
               if self.transformed_dominates() else ""))
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# The explorer
# ---------------------------------------------------------------------------


def explore_plans(
    cdfg: CDFG,
    base_plan: StagePlan,
    *,
    constraints: ResourceConstraints | None = None,
    mem: MemoryModel | None = None,
    mems: Sequence[Any] | None = None,
    node_traces: Mapping[int, list[MemAccess]] | None = None,
    duplicate_base: bool = True,
    n_iters: int | None = None,
    fifo_depth: int | None = None,
    fifo_depths: Sequence[int] | None = None,
    seed: int | None = None,
    max_candidates: int | None = None,
    use_rescache: bool | None = None,
    server: str | None = None,
    transforms: Sequence[Any] | None = None,
    verify: bool | None = None,
) -> DseResult:
    """Enumerate → prune → simulate → Pareto, over ``(plan, duplicate,
    transform, memory model, FIFO depth)`` candidates (no ``Compiled``
    construction — see :func:`explore` / ``Compiled.explore`` for that
    layer).

    ``fifo_depths`` turns on the *joint* partition×depth search: every
    (plan, duplicate) pair is costed and simulated at every depth (one
    resolution, one warm-started solve per depth), and the Pareto front
    spans both axes.  ``transforms`` (a list of
    :class:`~repro_torch.dataflow.transforms.TransformConfig`, or the
    ``unroll_factors`` / ``explore_coalesce`` / ``explore_reassoc``
    constraint knobs) widens the search with the HLS transformation
    catalog: each config is validated against the CDFG, its candidates
    are materialized with scaled channel widths/II (so
    ``max_fifo_bits`` prunes infeasible unroll factors before any
    simulation), its op streams are rewritten once and shared across
    candidates, and a ``reassoc`` request seeds the port-re-association
    split in the plan enumeration.  ``mems`` spans several memory
    models in one exploration (per-model Pareto fronts, concatenated;
    the first — or the explicit ``mem`` — is primary and hosts the
    baseline).  The enumeration budget ``max_candidates`` counts
    *untransformed* (plan, duplicate) pairs; the depth / transform /
    model grids multiply evaluated points, not the budget.

    ``verify`` (default: on, unless ``REPRO_VERIFY=0``) runs the static
    dataflow verifier on every candidate partition *before* paying for
    simulation: depths below the candidate's static deadlock bound are
    pruned with reason ``"deadlock: ..."``, partitions that dropped an
    ordering token / race with ``"race: ..."``
    (``eval_stats["pruned_deadlock"] / ["pruned_race"]`` count them;
    every candidate records its ``deadlock_min_depth``).  The baseline
    is still always simulated — it is the comparison point."""
    from ..core import rescache as _rc
    from . import verify as _vfy
    from .transforms import IDENTITY, TransformConfig, \
        transform_node_traces
    rc = constraints or ResourceConstraints()
    do_verify = _vfy.enabled(None) if verify is None else bool(verify)
    n_iters = rc.n_iters if n_iters is None else n_iters
    if fifo_depths is None:
        fifo_depths = getattr(rc, "fifo_depths", None)
    primary_depth = rc.fifo_depth if fifo_depth is None else fifo_depth
    depths = tuple(dict.fromkeys(fifo_depths)) if fifo_depths \
        else (primary_depth,)
    if primary_depth not in depths:
        primary_depth = depths[0]
    seed = rc.seed if seed is None else seed
    max_candidates = rc.max_candidates if max_candidates is None \
        else max_candidates

    # -- memory-model axis (multi-mem fronts) --------------------------------
    if mems is None:
        mems = getattr(rc, "mems", ()) or None
    if mems:
        models = standard_memory_models()
        mem_list = [m if isinstance(m, MemoryModel) else models[m]()
                    for m in mems]
        if mem is not None:
            mem_list = [mem] + [m for m in mem_list
                                if m.name != mem.name]
    else:
        mem_list = [mem if mem is not None
                    else standard_memory_models()[rc.mem]()]
    mem = mem_list[0]
    mem_names = tuple(m.name for m in mem_list)

    if node_traces is None:
        node_traces = traces_by_node(
            cdfg, materialize(cdfg, base_plan, transforms=IDENTITY), None,
            n_iters=n_iters, seed=seed)
    cyclic = _cyclic_nodes(cdfg)
    cyclic_mem = {nid for nid in cyclic if cdfg.node(nid).is_memory}

    # -- transform axis ------------------------------------------------------
    # tf=None is the identity lane: the artifact's *own* config (its
    # CDFG may already be transformed) — axis entries are absolute
    # configs, not composed on top of it
    base_cfg = getattr(cdfg, "transforms", None)
    if base_cfg is not None and base_cfg.is_identity:
        base_cfg = None
    reassoc = bool(getattr(rc, "explore_reassoc", False))
    src = transforms
    if src is None:
        src = []
        for u in getattr(rc, "unroll_factors", ()) or ():
            if u and int(u) > 1:
                src.append(TransformConfig(unroll=int(u)))
                if getattr(rc, "explore_coalesce", False):
                    src.append(TransformConfig(unroll=int(u),
                                               coalesce=True))
    axis: list[Any] = []
    for t in src:
        if t is None:
            continue
        if t.reassoc:
            reassoc = True
            t = dataclasses.replace(t, reassoc=False)
        if t.is_identity or t in axis:
            continue
        t.validate(cdfg)  # structural legality — raises TransformError
        axis.append(t)
    tf_axis: list[Any] = [None] + axis

    # transformed op streams, derived once from the node traces and
    # shared by every candidate of a lane (shared fingerprints, window/
    # burst memos, resolution keys); coalescing never applies to memory
    # ops on a dependence cycle (serialized per-request latency)
    tf_traces: dict[str, Any] = {}

    def _traces_for(eff: Any) -> Any:
        key = eff.signature() if eff is not None else "none"
        tr = tf_traces.get(key)
        if tr is None:
            tr = node_traces if eff is None or eff.is_identity \
                else transform_node_traces(node_traces, eff,
                                           serialized_nodes=cyclic_mem)
            tf_traces[key] = tr
        return tr

    # the §III-B1 duplication rewrite is a per-candidate *move*, explored
    # in both directions regardless of the base setting — forbid it
    # outright with max_duplicated_nodes=0
    dup_options = (duplicate_base, not duplicate_base)

    stats0 = _rc.stats()
    t0 = time.perf_counter()
    plans = enumerate_plans(cdfg, base_plan, max_candidates,
                            reassoc=reassoc)
    # race pruning is only meaningful when §III-A ordering was actually
    # requested: without mem edges the user asserted non-aliasing and
    # the verifier downgrades races to warnings
    has_mem_edges = any(e.kind == "mem" for e in cdfg.edges)
    pruned_stats = {"pruned_deadlock": 0, "pruned_race": 0}
    candidates: list[DseCandidate] = []
    baseline: DseCandidate | None = None
    #: per mem: (per-depth candidates, stages, token count) per lane
    sim_by_mem: dict[str, list[tuple[dict[int, DseCandidate],
                                     list[SimStage], int]]] = \
        {mn: [] for mn in mem_names}
    n_pairs = 0
    for moves, plan in plans:
        if n_pairs >= max_candidates and baseline is not None:
            break
        dup_effect = None
        for dup in dup_options:
            if n_pairs >= max_candidates and baseline is not None:
                break
            psig = plan_signature(plan)
            part0 = materialize(
                cdfg, plan,
                transforms=base_cfg if base_cfg is not None else IDENTITY)
            if dup:
                duplicate_cheap_rewrite(part0)
                dup_effect = bool(part0.duplicated)
            if dup != dup_options[0] and not dup_effect:
                # the rewrite is a no-op for this plan: the toggled
                # variant would be byte-identical — don't burn budget
                # (and a redundant solve) on it
                continue
            n_pairs += 1
            is_base_pair = not moves and dup == duplicate_base
            for tf in tf_axis:
                eff = tf if tf is not None else base_cfg
                sig = eff.signature() if eff is not None else "none"
                if tf is None:
                    part = part0
                else:
                    part = materialize(cdfg, plan, transforms=eff)
                    if dup:
                        duplicate_cheap_rewrite(part)
                ntk = eff.tokens(n_iters) if eff is not None else n_iters
                tmoves = moves + (() if dup == duplicate_base
                                  else ("duplicate" if dup
                                        else "no-duplicate",))
                if tf is not None:
                    tmoves = tmoves + tf.active()
                # static verification of the candidate, once per
                # (plan, dup, transform) lane: the deadlock bound of
                # the simulated stage chain, and any dropped ordering
                # token / decoupled-access race in the partition
                bound = _vfy.chain_deadlock_bound(
                    (s.latency for s in part.stages),
                    (s.ii for s in part.stages))
                race_reason: str | None = None
                if do_verify:
                    bad = [d for d in _vfy.verify_partition(
                               part, strict_races=has_mem_edges)
                           if d.severity == "error"
                           and d.rule in ("race", "mem-order")]
                    if bad:
                        race_reason = f"race: {bad[0].message}"
                stages: list[SimStage] | None = None
                for m in mem_list:
                    to_sim: dict[int, DseCandidate] = {}
                    for d in depths:
                        res = partition_resources(part, d)
                        cand = DseCandidate(
                            groups=psig, moves=tmoves, duplicate=dup,
                            resources=res, fifo_depth=d, plan=plan,
                            transform=sig, tf=eff, mem_name=m.name,
                            n_tokens=ntk, deadlock_min_depth=bound)
                        is_base = (is_base_pair and tf is None
                                   and m is mem_list[0]
                                   and d == primary_depth)
                        cand.pruned = constraint_violation(res, rc)
                        if do_verify and cand.pruned is None:
                            if race_reason is not None:
                                cand.pruned = race_reason
                                pruned_stats["pruned_race"] += 1
                            elif d < bound:
                                cand.pruned = (
                                    f"deadlock: fifo depth {d} < "
                                    f"static bound {bound}")
                                pruned_stats["pruned_deadlock"] += 1
                        # the baseline is always simulated — it is the
                        # comparison point even when it violates the
                        # constraints (depths < 1 can never simulate)
                        if (cand.pruned is None or is_base) and d >= 1:
                            to_sim[d] = cand
                        if is_base:
                            baseline = cand
                        candidates.append(cand)
                    if to_sim:
                        if stages is None:
                            # built lazily: a lane whose every depth is
                            # pruned (an over-budget unroll factor)
                            # never transforms its traces
                            stages = sim_stages_for_partition(
                                part, _traces_for(eff), cyclic_mem)
                        sim_by_mem[m.name].append((to_sim, stages, ntk))
    if server:
        # resolve every distinct survivor group through the daemon
        # first (shared spawn-pool, in-flight dedup with concurrent
        # explorers); the chunk-major pass below then serves the grid
        # from the store.  Best-effort: a missing daemon or an
        # over-cap artifact just resolves cold locally as before.
        from ..serve.client import ServeUnavailable, prefetch
        addr = None if server == "auto" else server
        ok = True
        for m in mem_list:
            if not ok:
                break
            for _, st, ntk in sim_by_mem[m.name]:
                try:
                    prefetch(st, {m.name: m}, ntk, seed=seed,
                             address=addr)
                except ServeUnavailable:
                    ok = False
                    break
    # one chunk-major pass per memory model simulates every survivor,
    # sharing trace resolution across candidates (and with past/future
    # runs via the chunk-granular rescache); each candidate's depth grid
    # shares one fold and warm-starts shallower depths from deeper fixed
    # points.  Transformed lanes run their shorter token streams on the
    # same chunk grid (clamped per lane).
    eval_stats = {"resolution_groups": 0, "cold_groups": 0,
                  **pruned_stats}
    for m in mem_list:
        entries = sim_by_mem[m.name]
        if not entries:
            continue
        cycles, es = evaluate_candidates(
            [st for _, st, _ in entries], m, n_iters,
            depth_lists=[tuple(bd) for bd, _, _ in entries],
            n_iters_list=[ntk for _, _, ntk in entries],
            seed=seed, use_rescache=use_rescache)
        for (bd, _, _), cyc in zip(entries, cycles):
            for d, cand in bd.items():
                cand.cycles = cyc[d]
        for k in eval_stats:
            eval_stats[k] += es.get(k, 0)
    stats1 = _rc.stats()

    # cycles-vs-FIFO-bits front per memory model over feasible
    # evaluated candidates (cross-model cycles are not comparable, so
    # each model gets its own frontier; the result concatenates them,
    # primary model first)
    front: list[DseCandidate] = []
    for mn in mem_names:
        best_cycles: int | None = None
        pool = [c for c in candidates if c.mem_name == mn
                and c.cycles is not None and c.pruned is None]
        for c in sorted(pool, key=lambda c: (c.fifo_bits, c.cycles)):
            if best_cycles is None or c.cycles < best_cycles:
                best_cycles = c.cycles
                c.pareto = True
                front.append(c)
    return DseResult(
        baseline=baseline, candidates=candidates, front=front,
        n_iters=n_iters, fifo_depth=primary_depth, mem_name=mem.name,
        fifo_depths=depths, wall_s=time.perf_counter() - t0,
        rescache_hits=stats1["mem_hits"] + stats1["disk_hits"]
        - stats0["mem_hits"] - stats0["disk_hits"],
        rescache_misses=stats1["misses"] - stats0["misses"],
        eval_stats=eval_stats, mem_names=mem_names,
        transforms=tuple(t.signature() for t in axis))


def compiled_with_plan(base: Any, plan: StagePlan,
                       duplicate: bool, transform: Any = None) -> Any:
    """Materialize a full ``Compiled`` artifact for one explored plan:
    the front-end products (traced graph, CDFG) are shared with ``base``, the
    partition is rebuilt from ``plan`` (with ``transform`` — a
    :class:`~repro_torch.dataflow.transforms.TransformConfig`, or ``None``
    to inherit the base artifact's own config), and the
    decouple/schedule passes re-run.  Bypasses the compile cache
    (candidate plans are not reachable from options alone)."""
    from .driver import Compiled
    from .passes import CompileContext, DecouplePass, SchedulePass
    from .transforms import IDENTITY
    eff = transform if transform is not None \
        else getattr(base.options, "transforms", None)
    opts = base.options.replace(duplicate_cheap=duplicate, dse=None,
                                transforms=eff)
    ctx = CompileContext(fn=base.fn,
                         example_args=base.context.example_args,
                         options=opts, device=base.device)
    ctx.graph = base.context.graph
    ctx.in_tree = base.context.in_tree
    ctx.out_tree = base.context.out_tree
    # the CDFG is shared with ``base`` — never mutate its ``transforms``
    # annotation; pass the config straight into ``materialize`` instead
    ctx.cdfg = base.context.cdfg
    ctx.plan = plan
    part = materialize(
        ctx.cdfg, plan,
        transforms=eff if eff is not None and not eff.is_identity
        else IDENTITY)
    if duplicate:
        duplicate_cheap_rewrite(part)
    ctx.partition = part
    DecouplePass().run(ctx)
    SchedulePass().run(ctx)
    return Compiled(ctx, base.pipeline)


def explore(
    compiled: Any,
    *,
    traces: Any = None,
    constraints: ResourceConstraints | None = None,
    mem: MemoryModel | None = None,
    mems: Sequence[Any] | None = None,
    n_iters: int | None = None,
    fifo_depth: int | None = None,
    fifo_depths: Sequence[int] | None = None,
    seed: int | None = None,
    max_candidates: int | None = None,
    use_rescache: bool | None = None,
    server: str | None = None,
    transforms: Sequence[Any] | None = None,
    verify: bool | None = None,
) -> DseResult:
    """``Compiled.explore`` implementation: explore re-partitionings of
    ``compiled``'s kernel and return the cycles-vs-FIFO-bits Pareto
    front with a ``Compiled`` artifact attached to every front (and the
    best) candidate.  Pass ``fifo_depths=[...]`` for the joint
    partition×depth front (each candidate costed and simulated at every
    depth; the channel FIFO depth becomes a search axis instead of a
    fixed parameter), ``transforms=[TransformConfig(...), ...]`` to
    widen the search with the transformation catalog, and
    ``mems=["ACP", "ACP+64KB", ...]`` (names or
    :class:`~repro_torch.core.simulator.MemoryModel` instances) to span memory
    models in one exploration — the front then carries one sub-front
    per model, each candidate recording its model in ``mem_name``."""
    rc = constraints or compiled.options.dse or ResourceConstraints()
    n_iters = rc.n_iters if n_iters is None else n_iters
    seed = rc.seed if seed is None else seed
    node_traces = traces_by_node(
        compiled.cdfg, compiled.partition, traces,
        n_iters=n_iters, seed=seed)
    result = explore_plans(
        compiled.cdfg, compiled.context.plan,
        constraints=rc, mem=mem, mems=mems, node_traces=node_traces,
        duplicate_base=compiled.options.duplicate_cheap,
        n_iters=n_iters, fifo_depth=fifo_depth,
        fifo_depths=fifo_depths, seed=seed,
        max_candidates=max_candidates, use_rescache=use_rescache,
        server=server, transforms=transforms, verify=verify)
    artifacts: dict[tuple, Any] = {}
    for cand in {id(c): c for c in result.front + [result.best()]}.values():
        if cand.compiled is None:
            # the baseline IS the caller's artifact (same plan, same
            # duplication setting, same transform config) — no need to
            # re-decouple/schedule; otherwise one artifact per distinct
            # (plan, duplicate, transform), shared across the mem/depth
            # grid
            if cand is result.baseline:
                cand.compiled = compiled
                continue
            key = (cand.groups, cand.duplicate, cand.transform)
            art = artifacts.get(key)
            if art is None:
                art = compiled_with_plan(compiled, cand.plan,
                                         cand.duplicate, cand.tf)
                artifacts[key] = art
            cand.compiled = art
    return result
