"""Compilation options for the dataflow compiler driver.

:class:`CompileOptions` is a frozen, hashable value object: together with
the traced graph it forms the key of the driver's in-memory compilation
cache, so every field must be hashable.  Mappings passed for
``latency_table`` / ``regions`` are frozen into sorted tuples.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

from ..core.cdfg import LatencyModel


def _freeze(value: Any) -> tuple:
    if isinstance(value, Mapping):
        return tuple(sorted(value.items()))
    return tuple(value)


@dataclasses.dataclass(frozen=True)
class ResourceConstraints:
    """The resource model the partition-space DSE prunes against, plus
    the exploration knobs the ``dse`` pass needs (frozen/hashable so it
    can ride in :class:`CompileOptions` and the compile cache key).

    Limits (``None`` = unconstrained):
      ``max_fifo_bits``            — total FIFO storage across channels
        (``fifo_depth × Σ channel payload bits``, the sweep's
        ``fifo_bits`` metric).
      ``max_mem_ports_per_stage``  — memory regions touched per stage
        (the template gives every stage one access interface per region).
      ``max_duplicated_nodes``     — §III-B1 duplication budget: total
        replicas across stages (0 forbids the rewrite outright).
      ``max_stages``               — stage count cap (area proxy).

    Exploration knobs (used when the ``dse`` pass runs at compile time;
    ``Compiled.explore`` accepts overrides):
      ``n_iters``        — iterations simulated per candidate.
      ``fifo_depth``     — FIFO depth candidates are costed/simulated at.
      ``fifo_depths``    — joint partition×depth search: cost and
        simulate every candidate at every listed depth (the depth
        becomes a search axis; the Pareto front spans both).  ``None``
        keeps the single-depth search at ``fifo_depth``.
      ``mem``            — memory-model name from
        :func:`repro_torch.core.simulator.standard_memory_models`.
      ``max_candidates`` — enumeration budget (BFS over merge/split
        moves from the Algorithm 1 plan; the fused and maximal
        degenerate plans are always included).  Counts (plan,
        duplicate) pairs; the depth / transform / memory-model grids
        multiply evaluated points, not the budget.
      ``seed``           — simulation seed.

    Transform-axis knobs (the catalog in ``repro_torch.dataflow.transforms``;
    all off by default so the stage-regrouping-only search is
    unchanged):
      ``unroll_factors``   — unroll factors to explore as DSE moves
        (e.g. ``(2, 4)``); each factor's FIFO-bit cost scales with the
        widened channels, so ``max_fifo_bits`` prunes them exactly like
        regrouped plans.
      ``explore_coalesce`` — additionally try each unroll factor with
        access coalescing (legality-checked per op stream).
      ``explore_reassoc``  — seed the plan enumeration with the
        memory-port re-association split (multi-region stages split by
        region).
      ``mems``             — memory-model names to span in one
        exploration (empty = just ``mem``); front points record their
        model.
    """

    max_fifo_bits: int | None = None
    max_mem_ports_per_stage: int | None = None
    max_duplicated_nodes: int | None = None
    max_stages: int | None = None
    n_iters: int = 4096
    fifo_depth: int = 8
    fifo_depths: Any = None
    mem: str = "ACP"
    max_candidates: int = 64
    seed: int = 0
    unroll_factors: Any = ()
    explore_coalesce: bool = False
    explore_reassoc: bool = False
    mems: Any = ()

    def __post_init__(self) -> None:
        if self.fifo_depths is not None:
            object.__setattr__(self, "fifo_depths",
                               tuple(self.fifo_depths))
        object.__setattr__(self, "unroll_factors",
                           tuple(self.unroll_factors))
        object.__setattr__(self, "mems", tuple(self.mems))


@dataclasses.dataclass(frozen=True)
class ServeOptions:
    """Serving-tier knobs carried on :class:`CompileOptions`.

    When set, ``Compiled.simulate`` / ``sweep`` / ``explore`` default
    their ``server`` argument to ``address`` (``None`` = the store's
    canonical socket, i.e. ``server="auto"``) and install the timeout /
    backoff knobs below as the process's serve-client configuration
    (:func:`repro_torch.serve.client.configure_timeouts`) before resolving —
    the compile-options side of the client's
    :class:`~repro_torch.serve.client.ServeTimeouts`.  ``max_wait_s`` is the
    cumulative connect + busy-retry budget; ``deadline_s`` (optional)
    rides each resolve request to the daemon, which fails the request
    server-side once exceeded (the client then falls back to library
    mode).  Frozen/hashable, so it participates in the compile cache
    key like every other option."""

    address: str | None = None
    connect_timeout_s: float = 10.0
    request_timeout_s: float = 600.0
    max_wait_s: float = 60.0
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    deadline_s: float | None = None

    def timeouts(self) -> Any:
        """The equivalent ``serve.client.ServeTimeouts`` (not ported yet)."""
        raise NotImplementedError(
            "ServeOptions: the serve client is not ported yet; it arrives "
            "with the serving-tier slice")


@dataclasses.dataclass(frozen=True)
class CompileOptions:
    """Everything that parameterizes a :func:`repro_torch.dataflow.compile` run.

    Partitioning (Algorithm 1):
      ``policy``             — "paper" | "fused" | "maximal" | "cost_aware".
      ``duplicate_cheap``    — §III-B1 cheap-op duplication rewrite.
      ``channel_cost_bytes`` — merge threshold for the cost_aware policy.

    Front end:
      ``latency_table`` / ``latency_default`` / ``long_threshold`` — the
        abstract latency model (overrides ``DEFAULT_LATENCY``).
      ``regions``          — invar index → region name (user alias results).
      ``add_memory_edges`` — §III-A memory-ordering edges.
      ``loop``             — treat the function as a loop body
        ``body(carry, *xs) -> new_carry`` and add carry back-edges.
      ``nonaliasing_carries`` — carry indices whose back-edge is dropped
        (the paper's user annotation; only meaningful with ``loop=True``).

    Execution:
      ``backend``        — default backend name for ``Compiled.__call__``.
      ``stream_argnums`` — argument positions that vary per microbatch when
        streaming through the systolic executors.

    Design-space exploration:
      ``dse`` — a :class:`ResourceConstraints` block.  When set, the
        ``dse`` pass explores merge/split/duplicate re-partitionings of
        the Algorithm 1 plan under these constraints (each candidate
        fully simulated) and compiles the winner;
        ``compiled.dse_result`` keeps the explored front.

    Transformation catalog:
      ``transforms`` — a
        :class:`repro_torch.dataflow.transforms.TransformConfig` (or ``None``).
        When set, the ``transform`` pass validates it against the
        analyzed CDFG and the partition/schedule layers apply it: unroll
        widens channels and scales SCC II, coalescing merges legal
        unrolled access groups into burst-width ops, tiling permutes the
        simulated iteration space, reassoc splits multi-region stages.
        Frozen/hashable, so it participates in the compile cache key.

    Serving tier:
      ``serve`` — a :class:`ServeOptions` block.  When set,
        ``Compiled.simulate`` / ``sweep`` / ``explore`` resolve through
        the resolution daemon at ``serve.address`` by default and the
        client runs with these timeout/backoff knobs
        (``docs/serving.md``).

    Static verification:
      ``verify`` — run the static dataflow verifier
        (``repro_torch.dataflow.verify``) after every pipeline pass: IR
        invariants (SCC integrity, topo order, channel/token balance,
        §III-A ordering preservation), the FIFO deadlock analysis, and
        the decoupled-access race detector.  Error-severity findings
        raise :class:`~repro_torch.dataflow.verify.VerifyError` at the pass
        that broke the invariant.  On by default; ``REPRO_VERIFY=0``
        in the environment disables it process-wide (``docs/verify
        .md``).
    """

    policy: str = "paper"
    backend: str = "sequential"
    duplicate_cheap: bool = True
    channel_cost_bytes: int = 4096
    latency_table: Any = ()
    latency_default: int = 1
    long_threshold: int = 1
    regions: Any = ()
    add_memory_edges: bool = True
    loop: bool = False
    nonaliasing_carries: Any = ()
    stream_argnums: Any = (0,)
    dse: ResourceConstraints | None = None
    transforms: Any = None
    serve: ServeOptions | None = None
    verify: bool = True

    def __post_init__(self) -> None:
        object.__setattr__(self, "latency_table", _freeze(self.latency_table))
        object.__setattr__(self, "regions", _freeze(self.regions))
        object.__setattr__(self, "stream_argnums",
                           tuple(self.stream_argnums))
        object.__setattr__(self, "nonaliasing_carries",
                           tuple(self.nonaliasing_carries))

    def latency_model(self) -> LatencyModel:
        return LatencyModel(table=dict(self.latency_table),
                            default=self.latency_default,
                            long_threshold=self.long_threshold)

    def regions_map(self) -> dict[int, str]:
        return dict(self.regions)

    def replace(self, **changes: Any) -> "CompileOptions":
        return dataclasses.replace(self, **changes)
