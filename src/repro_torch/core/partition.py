"""Algorithm 1 — partitioning the CDFG onto the dataflow template (§III-A).

Faithful transcription of the paper's pseudocode::

    procedure PartitionCDFG(G)
        SCCs            <- allStronglyConnComps(G)
        DAG             <- collapse(SCCs, G)
        TopoSortedNodes <- topologicalSort(DAG)
        LongSCCs        <- getSCCWithLongOp(SCCs)
        MemNodes        <- findLdStNodes(G)
        MemLongSCC      <- LongSCCs ∪ MemNodes
        allStages <- {};  curStage <- {}
        while TopoSortedNodes ≠ ∅:
            curNode  <- TopoSortedNodes.pop()
            curStage <- curStage ∪ curNode
            if curNode ∈ MemLongSCC:
                allStages <- allStages ∪ curStage
                curStage  <- {}
        return allStages

Notes kept from the paper:

* SCCs are never split across stages — channels add latency, which would
  inflate the initiation interval of the loop they embody (§III, citing
  decoupled software pipelining [7]).
* A new stage is cut **after** every memory operation or long-latency SCC,
  which (a) pipelines many outstanding requests into the memory subsystem and
  (b) localizes stalls (§III-B2).
* The pseudocode drops a trailing non-empty ``curStage``; we append it (the
  intended behaviour — otherwise pure-sink cheap ops would vanish).

Beyond-paper policies (kept separate, selected via ``policy=``):

* ``"fused"``      — everything in one stage: the conventional-HLS end of the
  spectrum (§II); this is the baseline the paper compares against.
* ``"maximal"``    — one stage per node: the fine-grained dataflow machine end.
* ``"cost_aware"`` — Algorithm 1, then merges adjacent stages whose channel
  cost exceeds the stall-localization benefit (FIFO area vs duplication,
  §III-B1 generalized with a cost model).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import networkx as nx

from .cdfg import CDFG, CHEAP_PRIMITIVES, LatencyModel


@dataclasses.dataclass
class Stage:
    """One stage of the dataflow pipeline template."""

    id: int
    node_ids: list[int]
    has_memory: bool
    has_long: bool
    #: abstract cycle cost of the stage body (sum of op latencies)
    latency: int
    #: min initiation interval imposed by dependence cycles inside the stage
    ii: int
    #: memory regions this stage touches (paper: one access interface each)
    regions: tuple[str, ...]
    #: raw dependence-cycle latency (``ii`` before transform scaling:
    #: unroll serializes U recurrence steps per token, so ``ii`` may be
    #: ``U·scc_ii`` — the rewrites need the unscaled value to recompute)
    scc_ii: int = 0

    def __repr__(self) -> str:  # pragma: no cover
        tags = []
        if self.has_memory:
            tags.append("MEM")
        if self.has_long:
            tags.append("LONG")
        return (f"<Stage {self.id}: {len(self.node_ids)} ops lat={self.latency}"
                f" ii={self.ii} {'|'.join(tags)}>")


@dataclasses.dataclass
class Channel:
    """A FIFO channel between two stages (one per crossing var)."""

    src_stage: int
    dst_stage: int
    var: Any | None            # graph var carried; None => pure ordering token
    nbytes: int                # payload width per token
    kind: str = "data"


@dataclasses.dataclass
class Partition:
    cdfg: CDFG
    stages: list[Stage]
    channels: list[Channel]
    stage_of_node: dict[int, int]
    #: nodes replicated into later stages instead of channeled (§III-B1)
    duplicated: dict[int, list[int]] = dataclasses.field(default_factory=dict)
    #: active :class:`repro_torch.dataflow.transforms.TransformConfig` (None =
    #: untransformed); channel widths and stage timing already reflect it
    transforms: Any = None

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    def summary(self) -> str:
        lines = [f"Partition: {self.num_stages} stages, "
                 f"{len(self.channels)} channels"]
        for s in self.stages:
            prims = [self.cdfg.node(n).prim for n in s.node_ids]
            lines.append(f"  stage {s.id}: {prims} "
                         f"(mem={s.has_memory} long={s.has_long} "
                         f"ii={s.ii} lat={s.latency})")
        for c in self.channels:
            v = "token" if c.var is None else str(c.var)
            lines.append(f"  chan s{c.src_stage}->s{c.dst_stage} {v} "
                         f"{c.nbytes}B")
        if self.duplicated:
            lines.append(f"  duplicated nodes: {self.duplicated}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------


def _var_nbytes(var: Any) -> int:
    aval = var.aval
    import numpy as np

    return int(np.prod(aval.shape)) * aval.dtype.itemsize if aval.shape else (
        aval.dtype.itemsize)


def _scc_cycle_latency(cdfg: CDFG, scc: set[int], self_loops: set[int]
                       ) -> int:
    """Latency of the dependence cycle inside an SCC (lower-bounds its II);
    ``self_loops`` are the nodes with an edge to themselves."""
    if len(scc) == 1:
        nid = next(iter(scc))
        return cdfg.node(nid).latency if nid in self_loops else 0
    return sum(cdfg.node(n).latency for n in scc)


def _scaled_stage_timing(scc_ii: int, base_latency: int,
                         transforms: Any) -> tuple[int, int]:
    """(ii, latency) of a stage under the active transform config's
    unroll factor: a cyclic SCC serializes its U recurrence steps per
    channel token (``ii = U·scc_ii``, ``latency += (U−1)·scc_ii``);
    acyclic stages replicate U-way spatially and keep their timing.
    The single definition :func:`materialize` and
    :func:`duplicate_cheap_rewrite` share so the scaling cannot drift
    (re-exported as ``repro_torch.dataflow.transforms.scaled_stage_timing``)."""
    U = int(getattr(transforms, "unroll", 1) or 1)
    ii = max(1, scc_ii)
    latency = base_latency
    if U > 1 and scc_ii > 0:
        ii = max(1, scc_ii * U)
        latency += (U - 1) * scc_ii
    return ii, latency


@dataclasses.dataclass
class StagePlan:
    """Intermediate result of Algorithm 1 before materialization: the SCC
    decomposition plus the grouping of SCCs into stages.  Produced by
    :func:`stage_groups`, optionally refined by
    :func:`merge_costly_boundaries`, turned into a :class:`Partition` by
    :func:`materialize`.  Exposed so the compiler driver
    (``repro_torch.dataflow``) can run each step as a named, swappable pass."""

    sccs: list[set[int]]
    scc_of_node: dict[int, int]
    order: list[int]
    mem_long: set[int]
    groups: list[list[int]]


def stage_groups(
    cdfg: CDFG,
    *,
    policy: str = "paper",
) -> StagePlan:
    """Algorithm 1 lines 2-10: SCCs, condensation, topological order,
    classification, and the stage grouping for the chosen policy (without
    the cost-aware merge — that is a separate rewrite)."""
    g = nx.DiGraph()
    for n in cdfg.nodes:
        g.add_node(n.id)
    for e in cdfg.edges:
        g.add_edge(e.src, e.dst)

    # --- Algorithm 1 lines 2-3: SCCs and condensation -----------------------
    sccs = [set(c) for c in nx.strongly_connected_components(g)]
    scc_of_node: dict[int, int] = {}
    for k, comp in enumerate(sccs):
        for nid in comp:
            scc_of_node[nid] = k
    dag = nx.DiGraph()
    dag.add_nodes_from(range(len(sccs)))
    for e in cdfg.edges:
        a, b = scc_of_node[e.src], scc_of_node[e.dst]
        if a != b:
            dag.add_edge(a, b)

    # --- line 4: deterministic topological sort ----------------------------
    order = list(nx.lexicographical_topological_sort(
        dag, key=lambda k: min(sccs[k])))

    # --- lines 5-7: classification ------------------------------------------
    def scc_has_long(k: int) -> bool:
        return any(cdfg.node(n).is_long for n in sccs[k])

    def scc_has_mem(k: int) -> bool:
        return any(cdfg.node(n).is_memory for n in sccs[k])

    mem_long = {k for k in range(len(sccs))
                if scc_has_long(k) or scc_has_mem(k)}

    # --- stage assignment ----------------------------------------------------
    if policy == "fused":
        groups = [list(range(len(sccs)))] if sccs else []
    elif policy == "maximal":
        groups = [[k] for k in order]
    else:  # "paper" and "cost_aware" start from Algorithm 1
        groups = []
        cur: list[int] = []
        for k in order:
            cur.append(k)
            if k in mem_long:
                groups.append(cur)
                cur = []
        if cur:  # trailing stage (pseudocode omission, see module docstring)
            groups.append(cur)

    return StagePlan(sccs, scc_of_node, order, mem_long, groups)


def merge_costly_boundaries(
    cdfg: CDFG,
    plan: StagePlan,
    channel_cost_bytes: int,
) -> StagePlan:
    """Cost-aware rewrite on a :class:`StagePlan` (see
    :func:`_merge_costly_boundaries` for the merge rule)."""
    groups = _merge_costly_boundaries(
        cdfg, plan.sccs, [list(g) for g in plan.groups], channel_cost_bytes)
    return dataclasses.replace(plan, groups=groups)


def materialize(cdfg: CDFG, plan: StagePlan,
                transforms: Any = None) -> Partition:
    """Turn a :class:`StagePlan` into a :class:`Partition` with concrete
    :class:`Stage` records and FIFO channels (no duplication rewrite).
    ``transforms`` (default: the CDFG's annotation from the ``transform``
    pass) scales stage timing and channel widths — see
    :func:`repro_torch.dataflow.transforms.scaled_stage_timing`."""
    if transforms is None:
        transforms = getattr(cdfg, "transforms", None)
    stages: list[Stage] = []
    stage_of_node: dict[int, int] = {}
    self_loops = {e.src for e in cdfg.edges if e.src == e.dst}
    for sid, grp in enumerate(plan.groups):
        node_ids = sorted(n for k in grp for n in plan.sccs[k])
        for nid in node_ids:
            stage_of_node[nid] = sid
        scc_ii = max([0] + [_scc_cycle_latency(cdfg, plan.sccs[k],
                                               self_loops) for k in grp])
        ii, latency = _scaled_stage_timing(
            scc_ii, sum(cdfg.node(n).latency for n in node_ids), transforms)
        regions = tuple(sorted({cdfg.node(n).region for n in node_ids
                                if cdfg.node(n).region}))
        stages.append(Stage(
            id=sid,
            node_ids=node_ids,
            has_memory=any(cdfg.node(n).is_memory for n in node_ids),
            has_long=any(cdfg.node(n).is_long for n in node_ids),
            latency=latency,
            ii=ii,
            regions=regions,
            scc_ii=scc_ii,
        ))
    part = Partition(cdfg, stages, [], stage_of_node, transforms=transforms)
    part.channels = derive_channels(part)
    return part


def duplicate_cheap_rewrite(part: Partition) -> Partition:
    """§III-B1 rewrite: replicate cheap producers into consumer stages,
    re-derive the channel set, and fold the duplicated producers' latencies
    into their consumer stages' ``latency`` (the replica executes *inside*
    the consumer, so its cycles belong to that stage's body — the old code
    left consumer latencies at their pre-duplication values and the
    simulator under-estimated those stages).  Latencies are recomputed
    from scratch, so the rewrite is idempotent.  Mutates ``part`` in place
    and returns it."""
    _duplicate_cheap_sccs(part)
    cdfg = part.cdfg
    extra: dict[int, int] = {}
    for nid, consumers in part.duplicated.items():
        for sid in consumers:
            extra[sid] = extra.get(sid, 0) + cdfg.node(nid).latency
    for s in part.stages:
        base = sum(cdfg.node(n).latency for n in s.node_ids) \
            + extra.get(s.id, 0)
        s.ii, s.latency = _scaled_stage_timing(
            s.scc_ii, base, part.transforms)
    part.channels = derive_channels(part)
    return part


def partition_cdfg(
    cdfg: CDFG,
    *,
    policy: str = "paper",
    latency_model: LatencyModel | None = None,
    duplicate_cheap: bool = True,
    channel_cost_bytes: int = 4096,
) -> Partition:
    """Map a CDFG to the dataflow architectural template.

    policy:
      "paper"      — Algorithm 1 verbatim.
      "fused"      — single stage (the conventional accelerator).
      "maximal"    — one node per stage (fine-grained dataflow machine).
      "cost_aware" — Algorithm 1 + channel-cost driven stage merging.

    Orchestrates :func:`stage_groups` → :func:`merge_costly_boundaries` →
    :func:`materialize` → :func:`duplicate_cheap_rewrite`; the compiler
    driver (``repro_torch.dataflow``) runs the same steps as named passes.
    ``latency_model`` is accepted for API compatibility; latencies are
    fixed at CDFG construction.
    """
    del latency_model
    plan = stage_groups(cdfg, policy=policy)
    if policy == "cost_aware" and len(plan.groups) > 1:
        plan = merge_costly_boundaries(cdfg, plan, channel_cost_bytes)
    part = materialize(cdfg, plan)

    # --- §III-B1: duplicate cheap SCCs instead of cutting a channel ----------
    if duplicate_cheap and policy not in ("fused",):
        duplicate_cheap_rewrite(part)
    return part


def _merge_costly_boundaries(
    cdfg: CDFG,
    sccs: list[set[int]],
    groups: list[list[int]],
    channel_cost_bytes: int,
) -> list[list[int]]:
    """Cost-aware refinement: merge a stage boundary when the bytes that
    would cross it exceed ``channel_cost_bytes`` *and* neither side contains
    a memory op (merging memory stages would defeat stall localization)."""
    scc_of_node = {n: k for k, comp in enumerate(sccs) for n in comp}
    changed = True
    while changed and len(groups) > 1:
        changed = False
        for b in range(len(groups) - 1):
            left = {n for k in groups[b] for n in sccs[k]}
            right = {n for k in groups[b + 1] for n in sccs[k]}
            left_mem = any(cdfg.node(n).is_memory for n in left)
            right_mem = any(cdfg.node(n).is_memory for n in right)
            if left_mem or right_mem:
                continue
            xbytes = 0
            seen = set()
            for e in cdfg.edges:
                if e.var is None or e.var in seen:
                    continue
                if e.src in left and e.dst in right:
                    xbytes += _var_nbytes(e.var)
                    seen.add(e.var)
            if xbytes > channel_cost_bytes:
                groups[b] = groups[b] + groups[b + 1]
                del groups[b + 1]
                changed = True
                break
    # keep scc_of_node referenced for clarity (deterministic rebuild upstream)
    del scc_of_node
    return groups


def _duplicate_cheap_sccs(part: Partition) -> None:
    """§III-B1: frequently-occurring cheap SCCs (loop counters and other
    single-cycle integer ops) are replicated into consumer stages rather than
    paying for a FIFO.  Long-latency ops and memory accesses are never
    duplicated (paper rule)."""
    cdfg = part.cdfg
    for node in cdfg.nodes:
        if node.is_memory or node.is_long:
            continue
        if node.prim not in CHEAP_PRIMITIVES:
            continue
        src_stage = part.stage_of_node[node.id]
        consumer_stages = sorted({
            part.stage_of_node[e.dst]
            for e in cdfg.edges
            if e.src == node.id and e.var is not None
            and part.stage_of_node[e.dst] != src_stage
        })
        if not consumer_stages:
            continue
        # only duplicate if every producer feeding this node is available in
        # the consumer stage (i.e. its inputs are graph invars or themselves
        # duplicable/visible) — conservative: inputs must be graph inputs.
        # Token edges (memory-order / carry, ``var is None``) count as
        # feeders too: they carry an ordering constraint that a replica in
        # the consumer stage would silently drop.
        feeders = [e for e in cdfg.edges if e.dst == node.id]
        if feeders:
            continue
        part.duplicated[node.id] = consumer_stages


# ---------------------------------------------------------------------------
# Partition-space moves (the DSE layer, after HIDA / de Fine Licht et al.)
#
# A :class:`StagePlan` is the unit the explorer works on: ``groups`` is an
# ordered list of SCC-id lists, each a contiguous run of the fixed topo
# order.  The legal moves — merging two adjacent stages, splitting a stage
# at an interior point — keep that shape, so SCCs are never split and the
# topological order of the condensation is preserved by construction.
# ``plan_is_legal`` re-checks both invariants independently (tests, and a
# guard against hand-built plans).
# ---------------------------------------------------------------------------


def plan_signature(plan: StagePlan) -> tuple[tuple[int, ...], ...]:
    """Canonical identity of a plan's stage grouping (for dedup): the
    SCC groups, each named by its sorted member node ids."""
    return tuple(tuple(sorted(n for k in grp for n in plan.sccs[k]))
                 for grp in plan.groups)


def plan_is_legal(cdfg: CDFG, plan: StagePlan) -> bool:
    """A plan is legal iff (a) its groups partition the SCC set, (b) no
    SCC is split across groups (structural: groups hold whole SCC ids),
    (c) every cross-group dependence edge flows forward — i.e. the
    group order is a topological order of the condensation — and
    (d) channel re-derivation preserves every §III-A memory-ordering
    token: a ``mem`` edge whose endpoint the plan does not cover would
    be silently dropped by :func:`derive_channels` (``stage_of_node
    .get`` skips it), losing the store-ordering guarantee.  This is the
    one legality oracle the DSE move generation and the static verifier
    (``repro_torch.dataflow.verify``) share."""
    seen: list[int] = [k for grp in plan.groups for k in grp]
    if sorted(seen) != list(range(len(plan.sccs))):
        return False
    group_of: dict[int, int] = {}
    for gi, grp in enumerate(plan.groups):
        for k in grp:
            group_of[k] = gi
    for e in cdfg.edges:
        a = plan.scc_of_node.get(e.src)
        b = plan.scc_of_node.get(e.dst)
        if a is None or b is None:
            # uncovered endpoint: fatal for ordering tokens (d); plain
            # data edges to uncovered nodes never materialize either
            return False
        ga, gb = group_of.get(a), group_of.get(b)
        if ga is None or gb is None:
            return False
        if a != b and ga > gb:
            return False
    return True


def merge_move(plan: StagePlan, b: int) -> StagePlan:
    """Merge adjacent groups ``b`` and ``b+1`` (always legal)."""
    groups = [list(g) for g in plan.groups]
    groups[b] = groups[b] + groups[b + 1]
    del groups[b + 1]
    return dataclasses.replace(plan, groups=groups)


def split_move(plan: StagePlan, b: int, j: int) -> StagePlan:
    """Split group ``b`` before its ``j``-th SCC (0 < j < len(group));
    both halves keep their relative (topological) order, so the move is
    always legal."""
    groups = [list(g) for g in plan.groups]
    grp = groups[b]
    if not 0 < j < len(grp):
        raise ValueError(f"split point {j} outside group of {len(grp)}")
    groups[b:b + 1] = [grp[:j], grp[j:]]
    return dataclasses.replace(plan, groups=groups)


def neighbor_plans(plan: StagePlan) -> list[tuple[str, StagePlan]]:
    """All single-move neighbours of ``plan``: every adjacent merge and
    every interior split, with a human-readable move tag."""
    out: list[tuple[str, StagePlan]] = []
    for b in range(len(plan.groups) - 1):
        out.append((f"merge({b},{b + 1})", merge_move(plan, b)))
    for b, grp in enumerate(plan.groups):
        for j in range(1, len(grp)):
            out.append((f"split({b}@{j})", split_move(plan, b, j)))
    return out


def fused_plan(plan: StagePlan) -> StagePlan:
    """The all-merged degenerate point of the move set (policy 'fused')."""
    groups = [[k for grp in plan.groups for k in grp]] if plan.groups else []
    return dataclasses.replace(plan, groups=groups)


def maximal_plan(plan: StagePlan) -> StagePlan:
    """The all-split degenerate point (policy 'maximal')."""
    return dataclasses.replace(
        plan, groups=[[k] for grp in plan.groups for k in grp])


def derive_channels(part: Partition) -> list[Channel]:
    """Every dependence edge crossing a stage boundary becomes a FIFO channel
    (§III-A last ¶): one channel per (var, src, dst) triple; memory-order
    edges become zero-width token channels.  Under an unroll transform a
    token carries U iterations' worth of payload, so data channels widen
    ×U (the FIFO bit accounting the DSE prunes against scales with them;
    token channels stay zero-width)."""
    unroll = int(getattr(part.transforms, "unroll", 1) or 1)
    seen: set[tuple[int, int, Any]] = set()
    channels: list[Channel] = []
    for e in part.cdfg.edges:
        s_src = part.stage_of_node.get(e.src)
        s_dst = part.stage_of_node.get(e.dst)
        if s_src is None or s_dst is None or s_src == s_dst:
            continue
        # duplicated producers don't need a channel into their consumers
        if e.src in part.duplicated and s_dst in part.duplicated[e.src]:
            continue
        key = (s_src, s_dst, e.var)
        if key in seen:
            continue
        seen.add(key)
        channels.append(Channel(
            src_stage=s_src,
            dst_stage=s_dst,
            var=e.var,
            nbytes=_var_nbytes(e.var) * unroll if e.var is not None else 0,
            kind=e.kind,
        ))
    return channels
