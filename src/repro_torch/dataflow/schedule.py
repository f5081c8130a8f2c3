"""Static schedule analysis + simulation bridge for compiled artifacts.

:class:`Schedule` is the product of the driver's final pass: per-stage
summaries (initiation interval, latency, memory-in-SCC classification),
channel totals, and a lazily-built :class:`~repro_torch.core.pipeline.SystolicPipeline`
for the streaming executors.  :class:`SimReport` packages the Fig. 2
occupancy view and the Fig. 5 machine comparison produced by
``Compiled.simulate()``; :class:`SweepResult` / :func:`sweep_schedule`
grid the same machines over memory models × FIFO depths × SCC modes
(``Compiled.sweep()``, the Fig. 5 design-space sweep).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Mapping, Sequence

import networkx as nx
import numpy as np

from ..core.decouple import DecoupledProgram
from ..core.pipeline import SystolicPipeline, gpipe_bubble_fraction
from ..core.simulator import (MemAccess, MemoryModel, SimResult, SimStage,
                              acp, simulate_conventional,
                              simulate_conventional_many, simulate_dataflow,
                              simulate_dataflow_many, standard_memory_models)


@dataclasses.dataclass(frozen=True)
class StageSummary:
    """One pipeline stage as the scheduler sees it."""

    id: int
    prims: tuple[str, ...]
    ii: int
    latency: int
    has_memory: bool
    has_long: bool
    regions: tuple[str, ...]
    mem_in_scc: bool
    memory_node_ids: tuple[int, ...]
    in_channel_bytes: int
    out_channel_bytes: int
    #: unscaled dependence-cycle latency (``ii``/``latency`` already
    #: reflect the active transform config; this recovers the base)
    scc_ii: int = 0


def _cyclic_nodes(cdfg: Any) -> set[int]:
    """Nodes on a dependence cycle (the DFS pathology detector)."""
    g = nx.DiGraph()
    g.add_nodes_from(n.id for n in cdfg.nodes)
    g.add_edges_from((e.src, e.dst) for e in cdfg.edges)
    cyclic: set[int] = set()
    for comp in nx.strongly_connected_components(g):
        if len(comp) > 1 or any(g.has_edge(n, n) for n in comp):
            cyclic |= comp
    return cyclic


@dataclasses.dataclass
class Schedule:
    """Static pipeline schedule for a decoupled program."""

    program: DecoupledProgram
    stream_argnums: tuple[int, ...]
    stages: list[StageSummary]
    num_channels: int
    channel_bytes: int
    #: active TransformConfig carried from the partition (None =
    #: untransformed); stage timing and channel_bytes already reflect it
    transforms: Any = None
    _pipeline: SystolicPipeline | None = None

    @classmethod
    def from_program(cls, program: DecoupledProgram,
                     *, stream_argnums: Sequence[int] = (0,)) -> "Schedule":
        part = program.partition
        cdfg = part.cdfg
        cyclic = _cyclic_nodes(cdfg)
        in_bytes = {s.id: 0 for s in part.stages}
        out_bytes = {s.id: 0 for s in part.stages}
        for c in part.channels:
            out_bytes[c.src_stage] += c.nbytes
            in_bytes[c.dst_stage] += c.nbytes
        summaries = []
        for s in part.stages:
            mem_ids = tuple(n for n in s.node_ids if cdfg.node(n).is_memory)
            summaries.append(StageSummary(
                id=s.id,
                prims=tuple(cdfg.node(n).prim for n in s.node_ids),
                ii=s.ii,
                latency=s.latency,
                has_memory=s.has_memory,
                has_long=s.has_long,
                regions=s.regions,
                mem_in_scc=any(n in cyclic for n in mem_ids),
                memory_node_ids=mem_ids,
                in_channel_bytes=in_bytes[s.id],
                out_channel_bytes=out_bytes[s.id],
                scc_ii=getattr(s, "scc_ii", 0),
            ))
        return cls(program, tuple(stream_argnums), summaries,
                   num_channels=len(part.channels),
                   channel_bytes=sum(c.nbytes for c in part.channels),
                   transforms=getattr(part, "transforms", None))

    # -- derived quantities ---------------------------------------------------

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    @property
    def pipeline_ii(self) -> int:
        """Steady-state initiation interval: the slowest stage's II."""
        return max([1] + [s.ii for s in self.stages])

    @property
    def total_latency(self) -> int:
        return sum(s.latency for s in self.stages)

    def bubble_fraction(self, microbatches: int) -> float:
        return gpipe_bubble_fraction(self.num_stages, microbatches)

    @property
    def pipeline(self) -> SystolicPipeline:
        """The systolic executor (built on first use: boundary packing
        allocates example payloads, so it is not free for large programs)."""
        if self._pipeline is None:
            self._pipeline = SystolicPipeline(
                self.program, stream_argnums=self.stream_argnums)
        return self._pipeline

    # -- Fig. 2 occupancy -----------------------------------------------------

    def occupancy(self, microbatches: int) -> list[list[int]]:
        """Fig. 2 grid: ``occ[t][s]`` is the microbatch in stage ``s`` at
        tick ``t`` (-1 = idle).  Microbatch m occupies stage s at tick
        ``t = m + s``."""
        S, T = self.num_stages, microbatches
        return [[t - s if 0 <= t - s < T else -1 for s in range(S)]
                for t in range(T + S - 1)]

    def render_occupancy(self, microbatches: int = 6) -> str:
        occ = self.occupancy(microbatches)
        lines = ["tick " + " ".join(f"s{s}" for s in
                                    range(self.num_stages))]
        for t, row in enumerate(occ):
            cells = " ".join(f"{m:>2}" if m >= 0 else " ." for m in row)
            lines.append(f"{t:>4} {cells}")
        return "\n".join(lines)

    # -- simulator bridge -----------------------------------------------------

    def sim_stages(
        self,
        traces: Mapping[str, Any] | Sequence[MemAccess] | None = None,
        *,
        n_iters: int = 2048,
        seed: int = 0,
        address_space: int = 4 << 20,
        apply_transforms: bool = True,
    ) -> list[SimStage]:
        """Build cycle-simulator stages from the partition.

        ``traces`` assigns memory address streams (**byte** addresses; the
        kernels touch 32-bit words, hence the ``* 4``) to the memory
        operations:

        * a mapping ``region name -> MemAccess | [MemAccess]`` (one entry
          per memory region, as :func:`repro_torch.core.simulator.stages_from_partition`);
        * a sequence of :class:`MemAccess`, assigned positionally to memory
          ops in pipeline-stage order (the Fig. 5 benchmark convention);
        * ``None`` — synthetic uniform-random word addresses, the
          cache-hostile default.

        Traces are always supplied per *original iteration*; when a
        transform config is active (and ``apply_transforms``), each op's
        stream is rewritten through the catalog (tile permutation, U
        strided unroll sub-streams, coalesced burst ops — coalescing is
        skipped for ``mem_in_scc`` stages, whose serialized accesses pay
        per-request latency) and the stages expect
        ``transforms.tokens(n_iters)`` simulated tokens.
        ``apply_transforms=False`` returns the *untransformed* machine —
        raw streams and unscaled II/latency — which is what the
        conventional-HLS comparison runs."""
        cfg = self.transforms
        if cfg is not None and cfg.is_identity:
            cfg = None
        rng = np.random.default_rng(seed)
        out: list[SimStage] = []
        if traces is None or isinstance(traces, Mapping):
            by_region = dict(traces or {})
        else:
            by_region = None
            trace_list = list(traces)
            ti = 0
        for s in self.stages:
            accesses: list[MemAccess] = []
            if by_region is not None:
                for region in s.regions:
                    tr = by_region.get(region)
                    if tr is None and traces is None:
                        tr = MemAccess(region, rng.integers(
                            0, address_space, n_iters) * 4)
                        by_region[region] = tr
                    if tr is None:
                        continue
                    accesses.extend(tr if isinstance(tr, list) else [tr])
            else:
                for _ in s.memory_node_ids:
                    if ti < len(trace_list):
                        accesses.append(trace_list[ti])
                        ti += 1
            ii, latency = s.ii, s.latency
            if cfg is not None:
                if apply_transforms:
                    from .transforms import transform_access
                    accesses = [t for a in accesses
                                for t in transform_access(
                                    cfg, a,
                                    allow_coalesce=not s.mem_in_scc)]
                elif cfg.unroll > 1 and s.scc_ii > 0:
                    # undo the unroll scaling baked in by materialize
                    ii = max(1, s.scc_ii)
                    latency = s.latency - (cfg.unroll - 1) * s.scc_ii
            out.append(SimStage(
                name=f"s{s.id}",
                ii=ii,
                latency=max(1, latency),
                accesses=accesses,
                mem_in_scc=s.mem_in_scc,
            ))
        return out


def fused_stage(stages: Sequence[SimStage]) -> SimStage:
    """The conventional-HLS counterpart: every op in one static schedule."""
    if not stages:
        return SimStage(name="fused", ii=1, latency=1)
    return SimStage(
        name="fused",
        ii=max(st.ii for st in stages),
        latency=sum(st.latency for st in stages),
        accesses=[a for st in stages for a in st.accesses],
        mem_in_scc=any(st.mem_in_scc for st in stages),
    )


@dataclasses.dataclass
class SimReport:
    """The Fig. 2/5 schedule report returned by ``Compiled.simulate()``."""

    schedule: Schedule
    stages: list[SimStage]
    dataflow: SimResult
    conventional: SimResult
    mem: MemoryModel
    n_iters: int
    microbatches: int

    @property
    def speedup(self) -> float:
        return self.conventional.cycles / max(1, self.dataflow.cycles)

    def summary(self) -> str:
        df, cv = self.dataflow, self.conventional

        def fmt_stalls(buckets: dict[str, int]) -> str:
            parts = [f"{k}={v}" for k, v in buckets.items() if v]
            return "+".join(parts) if parts else "none"

        lines = [
            f"simulated {self.n_iters} iterations on memory model "
            f"{self.mem.name!r}:",
            f"  conventional (fused) : {cv.cycles_per_iter:8.2f} cycles/iter"
            f"  ({cv.cycles} cycles)",
            f"  dataflow  (decoupled): {df.cycles_per_iter:8.2f} cycles/iter"
            f"  ({df.cycles} cycles)",
            f"  speedup              : {self.speedup:8.2f}x",
            "  per-stage stalls     : "
            + ", ".join(f"{k}[{fmt_stalls(v)}]"
                        for k, v in df.stage_stall_cycles.items()),
            "",
            f"Fig. 2 occupancy ({self.microbatches} microbatches, "
            f"{self.schedule.num_stages} stages, bubble fraction "
            f"{self.schedule.bubble_fraction(self.microbatches):.2f}):",
            self.schedule.render_occupancy(self.microbatches),
        ]
        return "\n".join(lines)


def simulate_schedule(
    schedule: Schedule,
    *,
    n_iters: int = 2048,
    mem: MemoryModel | None = None,
    traces: Any = None,
    fifo_depth: int = 8,
    microbatches: int = 6,
    seed: int = 0,
    use_rescache: bool | None = None,
    server: str | None = None,
    engine: str | None = None,
) -> SimReport:
    mem = mem or acp()
    cfg = getattr(schedule, "transforms", None)
    transformed = cfg is not None and not cfg.is_identity
    stages = schedule.sim_stages(traces, n_iters=n_iters, seed=seed)
    # the dataflow machine runs the transformed pipeline over its token
    # stream; the conventional baseline runs the *untransformed* fused
    # machine over the original iterations (same total work)
    n_df = cfg.tokens(n_iters) if transformed else n_iters
    base_stages = stages if not transformed else schedule.sim_stages(
        traces, n_iters=n_iters, seed=seed, apply_transforms=False)
    if server:
        # resolve through the daemon first (shared pool, in-flight
        # dedup); the local run below then serves from the store —
        # best-effort, so a missing daemon costs nothing
        from ..serve.client import ServeUnavailable, prefetch
        try:
            prefetch(stages, {"mem": mem}, n_df, seed=seed,
                     address=None if server == "auto" else server)
        except ServeUnavailable:
            pass
    df = simulate_dataflow(stages, mem, n_df, fifo_depth=fifo_depth,
                           seed=seed, use_rescache=use_rescache,
                           engine=engine)
    cv = simulate_conventional([fused_stage(base_stages)], mem, n_iters,
                               seed=seed, use_rescache=use_rescache,
                               engine=engine)
    return SimReport(schedule, stages, df, cv, mem, n_iters, microbatches)


# ---------------------------------------------------------------------------
# The Fig. 5 design-space sweep
# ---------------------------------------------------------------------------

#: ``mem_in_scc`` axis values: keep the partitioner's analysis, force the
#: DFS pathology everywhere (what the template degrades to when a memory
#: access cannot be decoupled), or force it off (perfect decoupling).
SCC_MODES = ("auto", "forced", "off")


def _with_scc_mode(stages: Sequence[SimStage], mode: str) -> list[SimStage]:
    if mode == "auto":
        return list(stages)
    if mode not in SCC_MODES:
        raise ValueError(f"mem_in_scc mode must be one of {SCC_MODES}, "
                         f"got {mode!r}")
    force = mode == "forced"
    return [dataclasses.replace(st, mem_in_scc=force if st.accesses
                                else st.mem_in_scc)
            for st in stages]


@dataclasses.dataclass
class SweepResult:
    """Grid of fully-simulated machine comparisons.

    ``rows`` is JSON-ready: one dict per (memory model × fifo depth ×
    SCC mode × bandwidth × outstanding-cap) point with
    dataflow/conventional cycles, cycles/iteration, runtimes, speedup,
    stall buckets, cache statistics, and the FIFO storage cost
    (``fifo_bits`` = depth × channel bits).  ``pareto()`` returns the
    cycles-vs-FIFO-bits frontier (HIDA-style: how much buffering the
    latency tolerance actually needs).
    """

    rows: list[dict]
    n_iters: int

    def best(self, metric: str = "dataflow_cycles") -> dict:
        """The grid point minimizing ``metric``."""
        return min(self.rows, key=lambda r: r[metric])

    def pareto(self, x: str = "fifo_bits",
               y: str = "dataflow_cycles") -> list[dict]:
        """Non-dominated rows minimizing ``(x, y)`` — by default the
        cycles-vs-FIFO-storage frontier.  Rows on the front are also
        marked in place (``row["pareto"] = True``)."""
        for r in self.rows:
            r["pareto"] = False
        front: list[dict] = []
        best_y = None
        for r in sorted(self.rows, key=lambda r: (r[x], r[y])):
            if best_y is None or r[y] < best_y:
                best_y = r[y]
                r["pareto"] = True
                front.append(r)
        return front

    def to_json(self) -> dict:
        return {"n_iters": self.n_iters, "rows": self.rows}

    def summary(self) -> str:
        lines = [f"sweep over {len(self.rows)} configurations "
                 f"({self.n_iters} iterations each):",
                 f"  {'mem':<10}{'fifo':>5}{'scc':>8}{'wpc':>5}{'mo':>4}"
                 f"{'df cyc/it':>11}{'conv cyc/it':>13}{'speedup':>9}"]
        for r in self.rows:
            lines.append(
                f"  {r['mem']:<10}{r['fifo_depth']:>5}"
                f"{r['mem_in_scc']:>8}"
                f"{r['words_per_cycle']:>5.2g}{r['max_outstanding']:>4}"
                f"{r['dataflow_cpi']:>11.2f}{r['conventional_cpi']:>13.2f}"
                f"{r['speedup']:>9.2f}")
        b = self.best()
        front = self.pareto()
        lines.append(f"  best dataflow config: {b['mem']} "
                     f"fifo={b['fifo_depth']} scc={b['mem_in_scc']} "
                     f"({b['dataflow_cpi']:.2f} cyc/iter, "
                     f"{b['speedup']:.2f}x over conventional)")
        lines.append(
            "  cycles-vs-FIFO-bits Pareto front: "
            + " → ".join(f"{r['fifo_depth']}@{r['fifo_bits']}b"
                         f"={r['dataflow_cycles']}" for r in front))
        return "\n".join(lines)


def sweep_schedule(
    schedule: Schedule,
    *,
    n_iters: int = 1 << 16,
    mems: Mapping[str, Callable[[], MemoryModel]] | None = None,
    fifo_depths: Iterable[int] = (8, 32),
    scc_modes: Iterable[str] = ("auto",),
    traces: Any = None,
    seed: int = 0,
    freq_mhz: float = 150.0,
    max_outstanding: int | None = None,
    words_per_cycle: Iterable[float] | None = None,
    max_outstandings: Iterable[int] | None = None,
    collect_stalls: bool = True,
    use_rescache: bool | None = None,
    workers: int | None = None,
    depth_incremental: bool = True,
    server: str | None = None,
    engine: str | None = None,
) -> SweepResult:
    """Grid-run the cycle simulator over memory models (§V: ACP / HP,
    ±64 KB cache) × FIFO depths × ``mem_in_scc`` modes × port bandwidths
    (``words_per_cycle``) × in-flight caps (``max_outstandings``).

    Every point simulates all ``n_iters`` iterations (no steady-state
    extrapolation), but the planner orders the grid so cells share work
    instead of re-resolving the same traces: per SCC mode, *all* memory
    variants and FIFO depths run through one
    :func:`~repro_torch.core.simulator.simulate_dataflow_many` pass — windows
    and burst masks are computed once, each distinct cache geometry
    replays once, bandwidth/outstanding variants reuse the same draws,
    and each FIFO depth only re-runs the wavefront solve.  The
    conventional engine has no FIFOs and ignores both SCC classification
    and the decoupled-port knobs, so one simulation per memory model
    covers its share of the grid.  Resolved traces are further memoized
    across calls, iteration counts (prefix serving), and processes via
    :mod:`repro_torch.core.rescache` (``use_rescache=False`` opts out).

    ``workers > 1`` shards the dataflow resolution across a process
    pool (the chunk-graph executor — bit-identical, multi-core);
    ``depth_incremental`` (default) warm-starts each FIFO-depth lane
    from the adjacent deeper lane's fixed point; ``server`` delegates
    resolution to a running resolution daemon (:mod:`repro_torch.serve` —
    ``"auto"`` or an explicit address), falling back to the local
    engines when none answers.  Each row records the engine that
    actually ran in ``resolution_mode`` (``"served:ADDR"`` /
    ``"sharded:N"`` / ``"streaming"``) and, in ``resilience``, the
    fault/retry counters its grid pass incurred (worker retries,
    quarantined store records, serve failovers) — a sweep that silently
    recovered from faults says so in its own output.
    """
    mems = dict(mems) if mems is not None else standard_memory_models()
    fifo_depths = tuple(fifo_depths)
    scc_modes = tuple(scc_modes)
    wpcs = tuple(words_per_cycle) if words_per_cycle is not None else (None,)
    mos = tuple(max_outstandings) if max_outstandings is not None \
        else (max_outstanding,)
    cfg = getattr(schedule, "transforms", None)
    transformed = cfg is not None and not cfg.is_identity
    tf_sig = cfg.signature() if transformed else "none"
    base_stages = schedule.sim_stages(traces, n_iters=n_iters, seed=seed)
    # transformed pipelines stream tokens (U iterations each); the
    # conventional baseline always runs the untransformed fused machine
    # over the original iterations — same total work on both sides
    n_df = cfg.tokens(n_iters) if transformed else n_iters
    conv_stages = base_stages if not transformed else schedule.sim_stages(
        traces, n_iters=n_iters, seed=seed, apply_transforms=False)
    channel_bits = schedule.channel_bytes * 8

    def variant(mk: Callable[[], MemoryModel], wpc, mo) -> MemoryModel:
        m = mk()
        if wpc is not None:
            m.words_per_cycle = wpc
        if mo is not None:
            m.max_outstanding = mo
        return m

    # conventional: one run per memory model (no FIFOs, no decoupled-port
    # knobs, SCC-independent), shared across the rest of the grid
    conv_mems = {mn: variant(mk, None, mos[0]) for mn, mk in mems.items()}
    conv = simulate_conventional_many(
        [fused_stage(conv_stages)], conv_mems, n_iters,
        freq_mhz=freq_mhz, seed=seed, use_rescache=use_rescache,
        engine=engine)

    # the engine the dataflow grid actually runs on, recorded per row
    # (satellite of the serving tier: on <4-core machines the workers
    # heuristic falls back to streaming — make the choice auditable)
    resolution_mode = "streaming" if not workers or workers < 2 \
        else f"sharded:{workers}"
    if server:
        from ..serve import client as _serve_client
        addr = None if server == "auto" else server
        if _serve_client.ping(addr):
            from ..serve import protocol as _serve_protocol
            resolution_mode = "served:" + (
                addr or _serve_protocol.default_address())

    # resilience observability (chaos-harness satellite): each row
    # carries the store/serve fault counters its grid pass incurred, so
    # a sweep that silently survived worker deaths, quarantined records
    # or daemon failovers says so in the output instead of only in logs
    from ..core import rescache as _resc
    _RESIL = ("worker_retries", "quarantined", "serve_failovers")

    def _resil_snap() -> dict[str, int]:
        s = _resc.stats()
        return {k: int(s.get(k, 0)) for k in _RESIL}

    rows: list[dict] = []
    for mode in scc_modes:
        resil0 = _resil_snap()
        stages = _with_scc_mode(base_stages, mode)
        variants: dict[str, tuple[str, float | None, int | None]] = {}
        vmems: dict[str, MemoryModel] = {}
        for mn, mk in mems.items():
            for wpc in wpcs:
                for mo in mos:
                    vn = mn if (wpc is None and mo is None) \
                        else f"{mn}|wpc={wpc}|mo={mo}"
                    variants[vn] = (mn, wpc, mo)
                    vmems[vn] = variant(mk, wpc, mo)
        grid = simulate_dataflow_many(
            stages, vmems, n_df, fifo_depths=fifo_depths,
            freq_mhz=freq_mhz, seed=seed, collect_stalls=collect_stalls,
            use_rescache=use_rescache, workers=workers,
            depth_incremental=depth_incremental, server=server,
            engine=engine)
        resil1 = _resil_snap()
        resilience = {k: resil1[k] - resil0[k] for k in _RESIL}
        for vn, (mn, wpc, mo) in variants.items():
            cv = conv[mn]
            m = vmems[vn]
            for depth in fifo_depths:
                df = grid[(vn, depth)]
                rows.append({
                    "mem": mn,
                    "fifo_depth": depth,
                    "fifo_bits": depth * channel_bits,
                    "transform": tf_sig,
                    "n_tokens": n_df,
                    "mem_in_scc": mode,
                    "words_per_cycle": m.words_per_cycle,
                    "max_outstanding": m.max_outstanding,
                    "dataflow_cycles": df.cycles,
                    "conventional_cycles": cv.cycles,
                    "dataflow_cpi": df.cycles_per_iter,
                    "conventional_cpi": cv.cycles_per_iter,
                    "dataflow_s": df.runtime_s,
                    "conventional_s": cv.runtime_s,
                    "speedup": cv.cycles / max(1, df.cycles),
                    "dataflow_stalls": df.total_stalls(),
                    "cache_hits": df.cache_hits,
                    "cache_misses": df.cache_misses,
                    "resolution_mode": resolution_mode,
                    "resilience": resilience,
                })
    res = SweepResult(rows, n_iters)
    res.pareto()  # mark the default frontier on the rows
    return res
