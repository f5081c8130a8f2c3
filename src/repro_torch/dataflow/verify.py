"""Static dataflow verifier: IR invariants, deadlock bounds, races.

The pipeline restructures a traced function into a multi-stage dataflow
engine through several IR forms (CDFG → StagePlan → Partition →
DecoupledProgram → Schedule).  Each pass preserves invariants the later
layers silently assume — SCCs are never split, the stage order is a
topological order of the condensation, every cross-stage dependence has
a FIFO channel, §III-A memory-ordering tokens survive rewrites.  Before
this module those invariants were spot-checked (``plan_is_legal``,
per-transform guards) and violations surfaced late, as wrong simulation
results.  This is the production-compiler counterpart: a pure static
analysis over the IR that runs after every pass (``CompileOptions
.verify``, on by default; ``REPRO_VERIFY=0`` disables it process-wide)
and reports structured :class:`Diagnostic` records.

Rule catalog (ids are stable; ``docs/verify.md`` documents each):

  ``plan-cover``     plan groups partition the SCC set; every CDFG node
                     is covered by exactly one SCC/group.
  ``plan-topo``      every cross-group dependence edge flows forward
                     (the group order is a topo order of the
                     condensation).
  ``scc-integrity``  no SCC is split across groups/stages.
  ``chan-missing``   every cross-stage dependence edge has a FIFO
                     channel (or a §III-B1 replica in the consumer).
  ``chan-width``     channel payload widths match the var's bytes ×
                     the active unroll factor (token channels are
                     zero-width).
  ``mem-order``      §III-A memory-ordering tokens are preserved: every
                     ``mem`` edge is intra-stage or has a directed
                     channel path, and no §III-B1 replica drops an
                     ordering feeder.
  ``chan-cycle``     the stage channel graph is acyclic (a directed
                     channel cycle carries zero initial tokens and
                     deadlocks at any FIFO depth).
  ``fifo-depth``     the configured FIFO depth clears the plan's
                     deadlock bound (token-capacity argument — see
                     :func:`deadlock_min_depth`).
  ``race``           stage pairs touching an overlapping memory region
                     (with at least one store) have an ordering-token
                     path between them.
  ``transform``      the active transform config is legal for the
                     materialized CDFG and stage timing matches
                     ``scaled_stage_timing``.
  ``decouple``       the decoupled program's channel wiring matches the
                     partition (producer stages, stage count).

Deadlock model (the ``chan-cycle`` / ``fifo-depth`` rules): channels
form a marked graph — each FIFO contributes a forward edge holding the
producer's in-flight tokens and a reverse *credit* edge holding
``depth`` free slots.  A directed cycle whose places hold zero tokens
can never fire again: a cycle of forward edges alone (``chan-cycle``)
deadlocks at any depth.  Cycles mixing forward and credit edges bound
the achievable initiation interval instead: a cycle through ``b``
credit edges with total forward latency ``L`` sustains at best one
token per ``L / (b·depth)`` cycles.  :func:`deadlock_min_depth` is the
smallest uniform depth at which no such cycle is slower than running
the stages back-to-back — below it the "pipeline" statically collapses
into a serialized machine and the DSE prunes the point before paying
for simulation (``docs/verify.md`` derives both bounds).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Any, Iterable, Mapping

import networkx as nx

from ..core.partition import (Partition, StagePlan, _scaled_stage_timing,
                              _var_nbytes, derive_channels)

#: rule id -> one-line description (the catalog; docs/verify.md)
RULES: dict[str, str] = {
    "plan-cover": "plan groups partition the SCC set / cover every node",
    "plan-topo": "cross-group dependence edges flow forward",
    "scc-integrity": "no SCC is split across groups or stages",
    "chan-missing": "every cross-stage edge has a channel or replica",
    "chan-width": "channel widths = var bytes x unroll (tokens 0)",
    "mem-order": "memory-ordering tokens survive rewrites",
    "chan-cycle": "stage channel graph is acyclic",
    "fifo-depth": "configured FIFO depth clears the deadlock bound",
    "race": "overlapping-region stage pairs have an ordering path",
    "transform": "transform config legal post-materialization",
    "decouple": "decoupled program wiring matches the partition",
}

#: cap on credit-graph cycle enumeration (stage graphs are tiny; this
#: only guards pathological hand-built inputs)
_MAX_CYCLES = 4096


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One verifier finding: a rule id from :data:`RULES`, a severity
    (``"error"`` — the IR is broken, the pipeline raises; ``"warning"``
    — legal but statically suspect, surfaced in reports/lint), the IR
    location it anchors to, the message, and a fix hint."""

    rule: str
    severity: str          # "error" | "warning"
    loc: str               # e.g. "stage 1 -> stage 3", "node 7", "plan"
    message: str
    hint: str = ""

    def __str__(self) -> str:
        s = f"[{self.rule}] {self.severity} @ {self.loc}: {self.message}"
        return s + (f"  (hint: {self.hint})" if self.hint else "")


class VerifyError(RuntimeError):
    """Raised by the pipeline hook when a pass leaves error-severity
    diagnostics behind.  Carries the structured findings."""

    def __init__(self, diagnostics: Iterable[Diagnostic],
                 where: str = "") -> None:
        self.diagnostics = [d for d in diagnostics
                            if d.severity == "error"]
        head = f"IR verification failed after pass {where!r}" if where \
            else "IR verification failed"
        lines = [head] + [f"  {d}" for d in self.diagnostics]
        super().__init__("\n".join(lines))
        self.where = where


def enabled(options: Any = None) -> bool:
    """Is verification on?  ``REPRO_VERIFY=0`` wins over everything
    (the documented escape hatch); otherwise ``options.verify``
    (default True)."""
    if os.environ.get("REPRO_VERIFY", "").strip() == "0":
        return False
    return bool(getattr(options, "verify", True))


def _err(rule: str, loc: str, msg: str, hint: str = "") -> Diagnostic:
    return Diagnostic(rule, "error", loc, msg, hint)


def _warn(rule: str, loc: str, msg: str, hint: str = "") -> Diagnostic:
    return Diagnostic(rule, "warning", loc, msg, hint)


# ---------------------------------------------------------------------------
# Family 1: inter-pass IR invariants
# ---------------------------------------------------------------------------


def verify_plan(cdfg: Any, plan: StagePlan) -> list[Diagnostic]:
    """StagePlan invariants: cover, SCC integrity, topo order, and the
    plan-level half of memory-order preservation (uncovered mem-edge
    endpoints would be silently dropped by ``derive_channels``)."""
    out: list[Diagnostic] = []
    seen = [k for grp in plan.groups for k in grp]
    if sorted(seen) != list(range(len(plan.sccs))):
        missing = set(range(len(plan.sccs))) - set(seen)
        dup = [k for k in set(seen) if seen.count(k) > 1]
        out.append(_err(
            "plan-cover", "plan",
            f"groups do not partition the SCC set "
            f"(missing={sorted(missing)}, repeated={sorted(dup)})",
            "rebuild the plan with stage_groups() or apply only "
            "merge_move/split_move"))
    covered = set(plan.scc_of_node)
    node_ids = {n.id for n in cdfg.nodes}
    if not node_ids <= covered:
        out.append(_err(
            "plan-cover", "plan",
            f"nodes {sorted(node_ids - covered)} not mapped to any SCC",
            "the plan was built for a different CDFG — re-run "
            "stage_groups() on this one"))
    for k, comp in enumerate(plan.sccs):
        mapped = {plan.scc_of_node.get(n) for n in comp}
        if mapped != {k}:
            out.append(_err(
                "scc-integrity", f"scc {k}",
                f"members map to SCCs {sorted(str(m) for m in mapped)}; "
                f"an SCC must stay whole",
                "SCCs are never split (Algorithm 1); regroup whole "
                "SCC ids only"))
    group_of: dict[int, int] = {}
    for gi, grp in enumerate(plan.groups):
        for k in grp:
            group_of[k] = gi
    for e in cdfg.edges:
        a = plan.scc_of_node.get(e.src)
        b = plan.scc_of_node.get(e.dst)
        if a is None or b is None:
            if e.kind == "mem":
                out.append(_err(
                    "mem-order", f"node {e.src} -> node {e.dst}",
                    "memory-order edge endpoint not covered by the "
                    "plan; its ordering token would be dropped",
                    "re-derive the plan from the CDFG that carries "
                    "this edge"))
            continue
        ga, gb = group_of.get(a), group_of.get(b)
        if a != b and ga is not None and gb is not None and ga > gb:
            out.append(_err(
                "plan-topo", f"node {e.src} -> node {e.dst}",
                f"dependence flows backward (group {ga} -> {gb}); the "
                f"group order is not a topological order",
                "only merge adjacent groups or split at interior "
                "points — both preserve the topo order"))
    return out


def _stage_graph(part: Partition) -> nx.DiGraph:
    g = nx.DiGraph()
    for s in part.stages:
        g.add_node(s.id)
    for c in part.channels:
        g.add_edge(c.src_stage, c.dst_stage)
    return g


def verify_partition(part: Partition, *,
                     strict_races: bool = True) -> list[Diagnostic]:
    """Partition invariants: channel balance/width vs an independent
    re-derivation, SCC integrity of ``stage_of_node``, memory-order
    preservation through rewrite/duplication, stage-graph acyclicity,
    the race detector, and transform-timing consistency.

    ``strict_races=False`` downgrades ``race`` findings to warnings —
    the posture when the user compiled with ``add_memory_edges=False``
    and so explicitly asserted the accesses don't alias."""
    cdfg = part.cdfg
    out: list[Diagnostic] = []

    # --- scc-integrity: stages must hold whole SCCs ------------------------
    g = nx.DiGraph()
    g.add_nodes_from(n.id for n in cdfg.nodes)
    g.add_edges_from((e.src, e.dst) for e in cdfg.edges)
    for comp in nx.strongly_connected_components(g):
        stages = {part.stage_of_node.get(n) for n in comp}
        if len(stages) > 1:
            out.append(_err(
                "scc-integrity", f"nodes {sorted(comp)}",
                f"SCC split across stages {sorted(map(str, stages))}",
                "a dependence cycle cannot cross a FIFO; keep the SCC "
                "in one stage"))

    # --- chan-missing / chan-width: balance vs re-derivation ---------------
    expected = {(c.src_stage, c.dst_stage, c.var): c
                for c in derive_channels(part)}
    actual = {(c.src_stage, c.dst_stage, c.var): c
              for c in part.channels}
    for key, c in expected.items():
        have = actual.get(key)
        loc = f"stage {key[0]} -> stage {key[1]}"
        if have is None:
            kind = "memory-order token" if c.var is None else \
                f"var {c.var}"
            rule = "mem-order" if c.kind == "mem" else "chan-missing"
            out.append(_err(
                rule, loc,
                f"cross-stage {kind} edge has no channel",
                "re-derive channels after every stage_of_node or "
                "duplication change (derive_channels)"))
        elif have.nbytes != c.nbytes:
            out.append(_err(
                "chan-width", loc,
                f"channel width {have.nbytes}B != expected {c.nbytes}B "
                f"(var bytes x unroll)",
                "materialize() and derive_channels() must share the "
                "active TransformConfig"))
    for key in actual:
        if key not in expected:
            out.append(_err(
                "chan-missing", f"stage {key[0]} -> stage {key[1]}",
                "channel has no underlying cross-stage dependence edge",
                "stale channel list — re-derive after re-partitioning"))

    # --- chan-width: independent width check (not via re-derivation) ------
    unroll = int(getattr(part.transforms, "unroll", 1) or 1)
    for c in part.channels:
        want = _var_nbytes(c.var) * unroll if c.var is not None else 0
        if c.nbytes != want:
            key = (c.src_stage, c.dst_stage, c.var)
            if key in expected and expected[key].nbytes != c.nbytes:
                continue  # already reported against the re-derivation
            out.append(_err(
                "chan-width",
                f"stage {c.src_stage} -> stage {c.dst_stage}",
                f"channel width {c.nbytes}B != {want}B "
                f"({'token' if c.var is None else 'data'} channel, "
                f"unroll x{unroll})",
                "token channels are zero-width; data channels scale "
                "with the unroll factor"))

    # --- chan-cycle --------------------------------------------------------
    sg = _stage_graph(part)
    cyc = None
    if not nx.is_directed_acyclic_graph(sg):
        cyc = nx.find_cycle(sg)
    if cyc:
        path = " -> ".join(str(u) for u, _ in cyc) + f" -> {cyc[-1][1]}"
        out.append(_err(
            "chan-cycle", f"stages {path}",
            "directed channel cycle: zero initial tokens, deadlocks at "
            "any FIFO depth",
            "stage order must be a topological order of the "
            "condensation (plan-topo); no channel may flow backward"))

    # --- mem-order through rewrites ----------------------------------------
    reach: dict[int, set[int]] = {}     # a stage's descendants, as asked
    for e in cdfg.edges:
        if e.kind != "mem":
            continue
        a = part.stage_of_node.get(e.src)
        b = part.stage_of_node.get(e.dst)
        loc = f"node {e.src} -> node {e.dst}"
        if a is None or b is None:
            out.append(_err(
                "mem-order", loc,
                "memory-order edge endpoint has no stage",
                "the partition was built for a different CDFG"))
            continue
        if a == b or cyc is not None:
            continue
        if a not in reach:
            reach[a] = nx.descendants(sg, a) if a in sg else set()
        if b not in reach[a]:
            out.append(_err(
                "mem-order", f"stage {a} -> stage {b} ({loc})",
                "memory-order edge crosses stages with no channel path; "
                "the ordering token was dropped",
                "derive_channels() must keep a token channel (or "
                "transitive path) for every mem edge"))
    # §III-B1: a replica silently drops any ordering feeder of the
    # duplicated node — re-check the rewrite's own guard
    feeders = {}
    for e in cdfg.edges:
        feeders.setdefault(e.dst, []).append(e)
    for nid, consumers in part.duplicated.items():
        fed = feeders.get(nid, ())
        if fed:
            kinds = sorted({e.kind for e in fed})
            out.append(_err(
                "mem-order", f"node {nid}",
                f"duplicated node has feeder edges ({'/'.join(kinds)}); "
                f"its replicas in stages {list(consumers)} drop that "
                f"ordering/dataflow",
                "only feeder-free cheap ops are duplicable (§III-B1)"))

    # --- race detector ------------------------------------------------------
    sev = _err if strict_races else _warn
    touch: dict[str, dict[int, bool]] = {}
    for n in cdfg.nodes if cyc is None else ():
        if not n.is_memory or not n.region:
            continue
        sid = part.stage_of_node.get(n.id)
        if sid is None:
            continue
        per = touch.setdefault(n.region, {})
        per[sid] = per.get(sid, False) or n.is_store
    for region, per in touch.items():
        sids = sorted(per)
        for a, b in itertools.combinations(sids, 2):
            if not (per[a] or per[b]):
                continue  # loads commute (§III-A)
            if cyc is None and (b in reach.get(a, ())
                                or a in reach.get(b, ())):
                continue
            out.append(sev(
                "race", f"stage {a} || stage {b}",
                f"both touch region {region!r} (store involved) with no "
                f"ordering-token path between them",
                "add_memory_order_edges() serializes same-region "
                "stores; or assign the ops distinct regions if they "
                "cannot alias"))

    # --- transform legality + timing re-check ------------------------------
    tf = part.transforms
    if tf is not None and not getattr(tf, "is_identity", True):
        from .transforms import TransformError
        try:
            tf.validate(cdfg)
        except TransformError as ex:
            out.append(_err(
                "transform", "partition",
                f"active transform config illegal for this CDFG: {ex}",
                "the transform pass must re-validate after any CDFG "
                "rewrite"))
    extra: dict[int, int] = {}
    for nid, consumers in part.duplicated.items():
        for sid in consumers:
            extra[sid] = extra.get(sid, 0) + cdfg.node(nid).latency
    for s in part.stages:
        base = sum(cdfg.node(n).latency for n in s.node_ids) \
            + extra.get(s.id, 0)
        ii, lat = _scaled_stage_timing(s.scc_ii, base, part.transforms)
        if (s.ii, s.latency) != (ii, lat):
            out.append(_err(
                "transform", f"stage {s.id}",
                f"stage timing (ii={s.ii}, lat={s.latency}) != scaled "
                f"timing (ii={ii}, lat={lat}) for the active config",
                "recompute stage timing via scaled_stage_timing after "
                "duplication or transform changes"))
    return out


def verify_program(program: Any) -> list[Diagnostic]:
    """DecoupledProgram wiring vs its partition: stage count, producer
    map consistency, and channel-input resolvability."""
    out: list[Diagnostic] = []
    part = program.partition
    if len(program.stages) != len(part.stages):
        out.append(_err(
            "decouple", "program",
            f"{len(program.stages)} stage programs != "
            f"{len(part.stages)} partition stages",
            "decouple() must emit exactly one program per stage"))
    for var, sid in program.producer_stage.items():
        if not any(s.id == sid for s in part.stages):
            out.append(_err(
                "decouple", f"var {var}",
                f"produced by unknown stage {sid}",
                "stale producer map — re-run decouple()"))
    known = set(program.producer_stage)
    for sp in program.stages:
        for src in sp.in_from:
            if src[0] == "chan" and src[1] not in known:
                out.append(_err(
                    "decouple", f"stage {sp.stage_id}",
                    f"channel input {src[1]} has no producing stage",
                    "every ('chan', var) input must appear in "
                    "producer_stage"))
    return out


# ---------------------------------------------------------------------------
# Family 2: static deadlock-freedom analysis
# ---------------------------------------------------------------------------


def _credit_cycle_bounds(lats: Mapping[int, int], iis: Mapping[int, int],
                         edges: set[tuple[int, int]]) -> tuple[int, int]:
    """(deadlock bound, full-throughput bound) over the credit marked
    graph of the stage channel set ``edges``.

    Every channel contributes a forward edge (latency of its producer)
    and a reverse credit edge (``depth`` free slots).  A simple cycle
    through ``b`` credit edges with forward latency ``L`` sustains at
    best one token per ``L/(b*depth)`` cycles, so:

    * **full throughput** needs ``depth >= L/(b*II_p)`` on every cycle
      (``II_p`` = the static pipeline II, ``max`` stage II) — below
      this, backpressure stretches the initiation interval;
    * **collapse ("static deadlock")** happens when the implied II
      reaches the fully serialized per-token cost ``sum(ii)`` — the
      engine is statically no faster than running its stages
      back-to-back, so decoupling has degenerated.  The bound is the
      smallest depth strictly above that point.
    """
    ii_p = max(1, max(iis.values(), default=1))
    serial = max(1, sum(max(1, v) for v in iis.values()))
    g = nx.DiGraph()
    g.add_nodes_from(lats)
    for s, t in edges:
        g.add_edge(s, t, kind="fwd")
        g.add_edge(t, s, kind="credit")
    dead = thr = 1
    for cycle in itertools.islice(nx.simple_cycles(g), _MAX_CYCLES):
        latency = credits = 0
        for u, v in zip(cycle, cycle[1:] + cycle[:1]):
            if (u, v) in edges:
                latency += max(1, lats.get(u, 1))
            else:
                credits += 1
        if credits == 0:
            continue  # pure forward cycle: chan-cycle's error, not ours
        # unsafe iff latency/(credits*d) >= serial, i.e. d <= L/(b*S)
        dead = max(dead, latency // (credits * serial) + 1)
        thr = max(thr, -(-latency // (credits * ii_p)))
    return dead, thr


def deadlock_min_depth(part: Partition) -> int:
    """Smallest uniform FIFO depth at which the partition's channel
    cycles cannot statically collapse the pipeline (see
    :func:`_credit_cycle_bounds`; ``docs/verify.md`` has the
    derivation).  Depths below this are flagged by ``fifo-depth`` and
    pruned by the DSE."""
    lats = {s.id: max(1, s.latency) for s in part.stages}
    iis = {s.id: max(1, s.ii) for s in part.stages}
    edges = {(c.src_stage, c.dst_stage) for c in part.channels
             if c.src_stage != c.dst_stage}
    if any((t, s) in edges for s, t in edges) or not edges:
        return 1  # cyclic graphs are chan-cycle errors; chains of 1 fine
    return _credit_cycle_bounds(lats, iis, edges)[0]


def chain_deadlock_bound(lats: Iterable[int],
                         iis: Iterable[int]) -> int:
    """The :func:`deadlock_min_depth` bound specialized to a linear
    stage chain — the machine model ``simulate_dataflow`` solves, where
    stage ``s`` backpressures on ``start[s+1, i-depth]``.  The binding
    credit cycles are the adjacent pairs, so the bound reduces to
    ``floor(max latency / serialized cost) + 1`` over non-final
    stages."""
    lats, iis = list(lats), list(iis)
    if len(lats) < 2:
        return 1
    serial = max(1, sum(max(1, x) for x in iis))
    return max(1, max(max(1, x) for x in lats[:-1]) // serial + 1)


def fifo_depth_diagnostics(part: Partition,
                           depths: Iterable[int]) -> list[Diagnostic]:
    """``fifo-depth`` findings for the configured depth axis: error
    below the collapse bound (or below 1 — the simulator refuses it),
    warning below the full-throughput bound."""
    out: list[Diagnostic] = []
    lats = {s.id: max(1, s.latency) for s in part.stages}
    iis = {s.id: max(1, s.ii) for s in part.stages}
    edges = {(c.src_stage, c.dst_stage) for c in part.channels
             if c.src_stage != c.dst_stage}
    if not edges or any((t, s) in edges for s, t in edges):
        return out
    dead, thr = _credit_cycle_bounds(lats, iis, edges)
    for d in dict.fromkeys(depths):
        if d < 1:
            out.append(_err(
                "fifo-depth", f"fifo_depth={d}",
                "FIFO depth below 1: a zero-capacity channel can never "
                "transfer a token",
                "fifo_depth must be >= 1"))
        elif d < dead:
            out.append(_err(
                "fifo-depth", f"fifo_depth={d}",
                f"statically deadlocks: depth {d} < bound {dead} — the "
                f"credit cycles' token capacity serializes the "
                f"pipeline below back-to-back stage execution",
                f"use depth >= {dead} (>= {thr} for full throughput)"))
        elif d < thr:
            out.append(_warn(
                "fifo-depth", f"fifo_depth={d}",
                f"below the full-throughput bound {thr}: backpressure "
                f"stretches the initiation interval past the static "
                f"pipeline II",
                f"depth >= {thr} hides all producer latency"))
    return out


# ---------------------------------------------------------------------------
# Entry points: pipeline hook and whole-artifact verification
# ---------------------------------------------------------------------------

#: pass name -> IR forms checked after it.  The front-end and no-op
#: passes re-check nothing; ``dse`` re-materializes, so it re-verifies.
#: Unknown (user-inserted) passes get every form that exists — a custom
#: pass that corrupts the IR is blamed by name, not its successor.
_AFTER_PASS = {
    "trace": (),
    "memdep": (),
    "transform": (),
    "partition": ("plan", "partition"),
    "rewrite": ("plan", "partition"),
    "dse": ("plan", "partition"),
    "decouple": ("program",),
    "schedule": (),
}
_ALL_FORMS = ("plan", "partition", "program")


def verify_ctx(ctx: Any, pass_name: str) -> list[Diagnostic]:
    """The inter-pass hook: verify the IR forms ``pass_name`` is
    responsible for, record findings on ``ctx.diagnostics``, raise
    :class:`VerifyError` on error severity."""
    forms = _AFTER_PASS.get(pass_name, _ALL_FORMS)
    diags: list[Diagnostic] = []
    strict = bool(getattr(ctx.options, "add_memory_edges", True))
    if "plan" in forms and ctx.plan is not None:
        diags += verify_plan(ctx.cdfg, ctx.plan)
    if "partition" in forms and ctx.partition is not None:
        diags += verify_partition(ctx.partition, strict_races=strict)
    if "program" in forms and ctx.program is not None:
        diags += verify_program(ctx.program)
    if diags:
        ctx.diagnostics.setdefault(pass_name, []).extend(diags)
    errors = [d for d in diags if d.severity == "error"]
    if errors:
        raise VerifyError(errors, where=pass_name)
    return diags


def verify_compiled(compiled: Any,
                    fifo_depths: Iterable[int] | None = None
                    ) -> list[Diagnostic]:
    """Whole-artifact verification (``Compiled.verify()``): every rule
    family over the final plan/partition/program, plus the deadlock
    bound against ``fifo_depths`` (default: the DSE constraints' depth
    axis, else the simulator default of 8)."""
    ctx = compiled.context
    strict = bool(getattr(ctx.options, "add_memory_edges", True))
    diags = verify_plan(ctx.cdfg, ctx.plan)
    diags += verify_partition(ctx.partition, strict_races=strict)
    if ctx.program is not None:
        diags += verify_program(ctx.program)
    if fifo_depths is None:
        rc = getattr(ctx.options, "dse", None)
        fifo_depths = tuple(getattr(rc, "fifo_depths", None) or
                            (getattr(rc, "fifo_depth", None) or 8,)) \
            if rc is not None else (8,)
    diags += fifo_depth_diagnostics(ctx.partition, fifo_depths)
    return diags
