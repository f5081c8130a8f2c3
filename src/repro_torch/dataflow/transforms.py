"""The HLS transformation catalog (de Fine Licht et al.) for the
dataflow template: four semantics-preserving rewrites, each a named,
legality-checked *pre-partition* pass in the :class:`PassPipeline` and a
DSE move alongside merge/split/duplicate (``docs/transforms.md``).

1. **Loop tiling** (``tile`` × ``tile_rows``) — re-chunk a declared 2-D
   iteration space (row-major ``tile_rows`` × C) so column tiles are
   visited innermost; the trace layer re-derives address windows through
   the tile permutation.  Legal only when no memory op sits on a
   dependence cycle (a loop-carried memory access pins the iteration
   order — the DFS pathology).
2. **Unroll / vectorize** (``unroll=U``) — U iterations per channel
   token: channels widen ×U (FIFO bit accounting scales with them), ops
   replicate U-way spatially, and a stage whose SCC imposes a cyclic II
   serializes its U recurrence steps (``ii → U·scc_ii``).  Memory ops
   split into U strided sub-streams resolved per token.
3. **Access coalescing** (``coalesce``, rides on ``unroll≥2``) — the U
   sub-accesses of an unrolled op merge into one burst-width op
   (``MemAccess.width = U``) when a stride/alignment legality check
   passes: constant positive stride, group span within one line, and
   group-aligned bases.  Ops that fail the check (or sit in a
   ``mem_in_scc`` stage) stay unrolled-but-uncoalesced.
4. **Memory-port re-association** (``reassoc``) — split a stage that
   touches several memory regions into per-region stages
   (:func:`split_by_region`), closing the documented DSE gap; always a
   legal contiguous split of the topological order
   (:func:`repro_torch.core.partition.plan_is_legal` re-checks).

Rescache key contract: transformed op streams have different addresses
and generator closures, so :func:`repro_torch.core.rescache.trace_fingerprint`
gives them **distinct v3 keys** — transformed traces are *new cache
entries, never invalidations* of untransformed artifacts.  The coalesced
``width`` is fold-only (bandwidth accounting), exactly like
``words_per_cycle``: it never keys.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import networkx as nx
import numpy as np

from ..core.simulator import DEFAULT_LINE_BYTES, MemAccess


class TransformError(ValueError):
    """A transform's legality check failed."""


@dataclasses.dataclass(frozen=True)
class TransformConfig:
    """Active transforms + factors (frozen/hashable: rides on
    :class:`~repro_torch.dataflow.options.CompileOptions` and in the compile
    cache key).

    ``unroll``     — iterations per channel token (1 = off).
    ``coalesce``   — merge each op's unrolled sub-accesses into one
                     burst-width access where the stride/alignment check
                     passes (requires ``unroll >= 2``).
    ``tile``       — column-tile width of the tiled iteration order
                     (0 = off; requires ``tile_rows``).
    ``tile_rows``  — row count of the declared 2-D iteration space.
    ``reassoc``    — split multi-region stages by memory region.
    """

    unroll: int = 1
    coalesce: bool = False
    tile: int = 0
    tile_rows: int = 0
    reassoc: bool = False

    def __post_init__(self) -> None:
        if self.unroll < 1:
            raise TransformError(f"unroll factor must be >= 1, "
                                 f"got {self.unroll}")
        if self.coalesce and self.unroll < 2:
            raise TransformError(
                "coalesce merges an op's unrolled sub-accesses: it "
                "requires unroll >= 2")
        if (self.tile > 0) != (self.tile_rows > 0):
            raise TransformError(
                "tiling needs the iteration-space shape: set both "
                f"tile (got {self.tile}) and tile_rows "
                f"(got {self.tile_rows})")
        if self.tile < 0 or self.tile_rows < 0:
            raise TransformError("tile / tile_rows must be >= 0")

    # -- identity / naming ----------------------------------------------------

    @property
    def is_identity(self) -> bool:
        return (self.unroll == 1 and not self.coalesce and not self.tile
                and not self.reassoc)

    def active(self) -> tuple[str, ...]:
        """Move tags, one per active transform (DSE move names)."""
        tags = []
        if self.tile:
            tags.append(f"tile={self.tile}x{self.tile_rows}")
        if self.unroll > 1:
            tags.append(f"unroll={self.unroll}")
        if self.coalesce:
            tags.append("coalesce")
        if self.reassoc:
            tags.append("reassoc")
        return tuple(tags)

    def signature(self) -> str:
        """Compact label for reports / sweep rows (``"none"`` when
        identity)."""
        return "+".join(self.active()) or "none"

    # -- iteration-space accounting -------------------------------------------

    def tokens(self, n_iters: int) -> int:
        """Channel tokens for ``n_iters`` original iterations (tiling
        permutes, unrolling groups U iterations per token)."""
        return -(-n_iters // self.unroll) if self.unroll > 1 else n_iters

    # -- structural legality (needs the CDFG) ---------------------------------

    def validate(self, cdfg: Any = None) -> None:
        """Structural legality against a CDFG (the shape checks already
        ran in ``__post_init__``).  Tiling reorders the iteration space,
        so it is illegal when any memory op sits on a dependence cycle:
        a loop-carried access (the DFS pathology, or a dp-table
        back-edge that was *not* waived via ``nonaliasing_carries``)
        pins the original order."""
        if cdfg is None or not self.tile:
            return
        cyclic = _cyclic_memory_nodes(cdfg)
        if cyclic:
            prims = sorted(cdfg.node(n).prim for n in cyclic)
            raise TransformError(
                f"tiling reorders iterations, but memory ops {prims} sit "
                f"on a dependence cycle (loop-carried access): the "
                f"iteration order is pinned.  Drop the back-edge via "
                f"nonaliasing_carries if the regions do not alias.")


#: the do-nothing config (the untransformed point of the DSE axis)
IDENTITY = TransformConfig()


def _cyclic_memory_nodes(cdfg: Any) -> set[int]:
    g = nx.DiGraph()
    g.add_nodes_from(n.id for n in cdfg.nodes)
    g.add_edges_from((e.src, e.dst) for e in cdfg.edges)
    cyclic: set[int] = set()
    for comp in nx.strongly_connected_components(g):
        if len(comp) > 1 or any(g.has_edge(n, n) for n in comp):
            cyclic |= {n for n in comp if cdfg.node(n).is_memory}
    return cyclic


# ---------------------------------------------------------------------------
# Trace-layer rewrites
#
# Each rewrite produces MemAccess objects whose ``gen`` is a plain
# closure over (base trace, integer factors, base fingerprint string):
# rescache.trace_fingerprint hashes the closure's bytecode, scalar
# cells, and sampled windows, so transformed streams get distinct keys
# automatically.  Generators stay pure in (lo, hi) — required by the
# MemAccess contract (chunking, resume, cloudpickle'd workers).
# ---------------------------------------------------------------------------


def _base_tag(acc: MemAccess) -> str:
    """Content tag of the base trace, captured as a *string closure
    cell* of every derived generator so the fingerprint distinguishes
    transforms of different bases even when sampling coincides."""
    from ..core import rescache as _rc
    return _rc.trace_fingerprint(acc)


def unrolled_access(acc: MemAccess, factor: int, lane: int) -> MemAccess:
    """Sub-stream ``lane`` of ``acc`` unrolled by ``factor``: token
    ``i`` carries original iteration ``i*factor + lane``.  All lanes
    share one token count ``ceil(len(acc)/factor)``; positions past the
    original trace pad to −1 (no access)."""
    if not 0 <= lane < factor:
        raise ValueError(f"lane {lane} outside unroll factor {factor}")
    n_tok = -(-len(acc) // factor)
    tag = _base_tag(acc)

    def gen(lo: int, hi: int) -> np.ndarray:
        _ = (factor, lane, tag)  # closure cells: keyed by the fingerprint
        if hi <= lo:
            return np.empty(0, dtype=np.int64)
        w = acc._raw_window(lo * factor + lane,
                            (hi - 1) * factor + lane + 1)
        return np.ascontiguousarray(w[::factor])

    return MemAccess(acc.region, gen=gen, length=n_tok,
                     is_store=acc.is_store)


def coalescible(acc: MemAccess, factor: int,
                line_bytes: int = DEFAULT_LINE_BYTES) -> bool:
    """Stride/alignment legality of merging each ``factor``-group of
    ``acc`` into one burst access: within every group the addresses
    advance by one constant positive stride ``s``, the group spans at
    most one line (``s*factor <= line_bytes``), and group bases are
    ``s*factor``-aligned (no line straddle).  Materialized traces up to
    2²⁰ addresses are checked in full; longer or generated traces check
    a deterministic spread of group-aligned windows (the same sampling
    posture as ``rescache.trace_fingerprint``)."""
    n = len(acc)
    if factor < 2 or n < factor:
        return False
    full = acc.addrs is not None and n <= (1 << 20)
    if full:
        windows = [(0, n)]
    else:
        span = 1024 * factor
        step = max(factor, ((n - span) // (7 * factor)) * factor)
        windows = []
        for i in range(8):
            lo = min(i * step, max(0, ((n - span) // factor) * factor))
            windows.append((lo, min(n, lo + span)))
    stride: int | None = None
    for lo, hi in windows:
        g = (hi - lo) // factor
        if g == 0:
            continue
        a = acc._raw_window(lo, lo + g * factor).reshape(g, factor)
        rows = (a >= 0).all(axis=1)  # partial tail groups are exempt
        if not rows.any():
            continue
        a = a[rows]
        d = np.diff(a, axis=1)
        if stride is None:
            stride = int(d[0, 0])
        if stride <= 0 or not (d == stride).all():
            return False
        if stride * factor > line_bytes:
            return False
        if (a[:, 0] % (stride * factor)).any():
            return False
    return stride is not None


def coalesced_access(acc: MemAccess, factor: int) -> MemAccess:
    """The merged burst-width op: one access per token at the group base
    address, ``width=factor`` words.  Caller is responsible for the
    :func:`coalescible` legality check."""
    base = unrolled_access(acc, factor, 0)
    return MemAccess(acc.region, gen=base.gen, length=len(base),
                     is_store=acc.is_store, width=factor)


def tiled_access(acc: MemAccess, tile_rows: int, tile: int) -> MemAccess:
    """``acc`` re-windowed through the tile permutation of its
    ``tile_rows`` × C row-major iteration space: column tiles of width
    ``tile`` are interchanged outermost, so token ``j`` reads original
    iteration ``π(j)`` with tile-column-row-column′ order (the working
    set of a tile is ``tile_rows × tile`` instead of a full row).  The
    trace length must factor (``len % tile_rows == 0``) — trace-level
    legality."""
    n = len(acc)
    R, T = int(tile_rows), int(tile)
    if R < 1 or T < 1:
        raise TransformError(f"tile shape {T}x{R} must be positive")
    if n % R != 0:
        raise TransformError(
            f"trace length {n} does not factor into tile_rows={R} rows")
    C = n // R
    widths = np.minimum(T, C - T * np.arange(-(-C // T)))
    cum = np.cumsum(widths * R)  # block end offsets, one per column tile
    starts = np.concatenate(([0], cum[:-1]))
    tag = _base_tag(acc)

    def gen(lo: int, hi: int) -> np.ndarray:
        _ = (R, C, T, tag)
        if hi <= lo:
            return np.empty(0, dtype=np.int64)
        j = np.arange(lo, hi, dtype=np.int64)
        t = np.searchsorted(cum, j, side="right")
        within = j - starts[t]
        w = widths[t]
        idx = (within // w) * C + t * T + within % w
        # fetch contiguous runs of the permuted index through the base
        # trace's own windowing (works for materialized and gen traces)
        out = np.empty(hi - lo, dtype=np.int64)
        cuts = np.flatnonzero(np.diff(idx) != 1) + 1
        bounds = np.concatenate(([0], cuts, [len(idx)]))
        for a, b in zip(bounds[:-1], bounds[1:]):
            out[a:b] = acc._raw_window(int(idx[a]), int(idx[a]) + (b - a))
        return out

    return MemAccess(acc.region, gen=gen, length=n, is_store=acc.is_store)


def transform_access(
    cfg: TransformConfig,
    acc: MemAccess,
    *,
    line_bytes: int = DEFAULT_LINE_BYTES,
    allow_coalesce: bool = True,
) -> list[MemAccess]:
    """Apply ``cfg``'s trace-layer rewrites to one memory op's stream:
    tile first (iteration-space permutation), then unroll into U
    sub-streams, then coalesce them into one burst-width op when legal.
    ``allow_coalesce=False`` for ops in ``mem_in_scc`` stages: a
    serialized access pays per-request latency, so merging would drop
    U−1 of its draws.  Results are memoized on the base access per
    config, so sibling candidates (DSE) share transformed objects — and
    with them the window/burst/fingerprint memos and resolution keys."""
    key = ("_tf_memo", cfg.tile, cfg.tile_rows, cfg.unroll,
           cfg.coalesce and allow_coalesce, line_bytes)
    memo = acc.__dict__.setdefault("_tf_memo", {})
    hit = memo.get(key)
    if hit is not None:
        return hit
    out = acc
    if cfg.tile:
        out = tiled_access(out, cfg.tile_rows, cfg.tile)
    if cfg.unroll > 1:
        if cfg.coalesce and allow_coalesce \
                and coalescible(out, cfg.unroll, line_bytes):
            res = [coalesced_access(out, cfg.unroll)]
        else:
            res = [unrolled_access(out, cfg.unroll, u)
                   for u in range(cfg.unroll)]
    else:
        res = [out]
    memo[key] = res
    return res


def transform_node_traces(
    node_traces: Mapping[int, list[MemAccess]],
    cfg: TransformConfig,
    *,
    serialized_nodes: set[int] | frozenset[int] = frozenset(),
    line_bytes: int = DEFAULT_LINE_BYTES,
) -> dict[int, list[MemAccess]]:
    """Transform a DSE node→traces map (``dse.traces_by_node`` layout).
    ``serialized_nodes`` are memory nodes on a dependence cycle — their
    streams never coalesce (see :func:`transform_access`)."""
    if cfg.is_identity:
        return dict(node_traces)
    return {
        nid: [t for a in accs
              for t in transform_access(
                  cfg, a, line_bytes=line_bytes,
                  allow_coalesce=nid not in serialized_nodes)]
        for nid, accs in node_traces.items()
    }


# ---------------------------------------------------------------------------
# Memory-port re-association (the partition-layer rewrite)
# ---------------------------------------------------------------------------


def split_by_region(cdfg: Any, plan: Any) -> Any:
    """Split every multi-region stage of ``plan`` by memory region: a
    new group starts whenever an SCC touches memory regions disjoint
    from those already in the current run (non-memory SCCs ride with the
    current run; an SCC whose *own* memory nodes span several regions is
    unsplittable and keeps them together).  Groups stay contiguous runs
    of the fixed topological order, so the result is legal by
    construction — re-checked via ``plan_is_legal``."""
    from ..core.partition import plan_is_legal
    # walk each group in the plan's topological order — group lists are
    # not guaranteed to be topo-sorted internally (the fused plan lists
    # SCC ids numerically), and the split groups' relative order must
    # follow the condensation order to stay legal
    pos = {k: i for i, k in enumerate(plan.order)}
    groups: list[list[int]] = []
    for grp in plan.groups:
        cur: list[int] = []
        cur_regions: set[str] = set()
        for k in sorted(grp, key=pos.__getitem__):
            regs = {cdfg.node(n).region for n in plan.sccs[k]
                    if cdfg.node(n).is_memory and cdfg.node(n).region}
            if regs and cur_regions and not (regs & cur_regions):
                groups.append(cur)
                cur, cur_regions = [], set()
            cur.append(k)
            cur_regions |= regs
        if cur:
            groups.append(cur)
    out = dataclasses.replace(plan, groups=groups)
    assert plan_is_legal(cdfg, out), "reassoc produced an illegal plan"
    return out


def scaled_stage_timing(scc_ii: int, base_latency: int,
                        cfg: TransformConfig | None) -> tuple[int, int]:
    """(ii, latency) of a stage under ``cfg``'s unroll — the partition
    layer owns the definition (see
    ``repro_torch.core.partition._scaled_stage_timing``); re-exported here as
    the catalog's public name."""
    from ..core.partition import _scaled_stage_timing
    return _scaled_stage_timing(scc_ii, base_latency, cfg)
