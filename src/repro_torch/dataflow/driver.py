"""The compiler driver: one entry point for the paper's whole flow.

``compile(fn, *example_args, options=..., device=...)`` runs the pass
pipeline (trace → memdep → partition → rewrite → decouple → schedule) and
returns a :class:`Compiled` artifact; ``dataflow_jit`` is the decorator
form that compiles lazily on first call per argument signature.

Programs are compiled for, and run on, one device: the port's device
policy (``repro_torch.set_device``, default ``"cuda"``) unless ``device=``
names another.  Asking for CUDA where there is none raises.

Compilation results are cached in memory, keyed on the traced FX graph,
the closed-over constants, the example arguments' shapes and dtypes, the
device, the options, and the pipeline structure: recompiling the same
function with the same options is a cache hit returning the *same*
``Compiled`` object.
"""

from __future__ import annotations

import inspect
import logging
from typing import Any, Callable, Sequence

import torch
import torch.utils._pytree as pytree

from .._device import get_device
from .backends import available_backends, get_backend
from .options import CompileOptions
from .passes import (CompileContext, PassPipeline, default_pipeline,
                     to_device)
from .schedule import SimReport, simulate_schedule


class Compiled:
    """The artifact produced by :func:`compile`.

    Stable surface:
      ``__call__(*args, backend=None)`` — execute via a registered backend
        (default: ``options.backend``) on the compile device.
      ``stream(*args)``   — stream microbatches through the emulated
        systolic pipeline (stream args carry a leading microbatch axis).
      ``simulate(...)``   — discrete-event Fig. 2/5 schedule report.
      ``sweep(...)``      — design-space sweep over memory models × FIFO
        depths × SCC modes (fully simulated grid; ``SweepResult``).
      ``report()``        — per-stage latency / channel summary (text).
      ``graph`` / ``cdfg`` / ``partition`` / ``program`` / ``schedule`` —
        the pass products, for inspection and downstream tools.
    """

    def __init__(self, context: CompileContext, pipeline: PassPipeline):
        self.context = context
        self.pipeline = pipeline
        self.fn = context.fn
        self.options = context.options
        self.device = context.device
        #: per-backend runtime state
        self.runtime_cache: dict[str, Any] = {}

    # -- pass products --------------------------------------------------------

    @property
    def graph(self):
        return self.context.graph

    @property
    def cdfg(self):
        return self.context.cdfg

    @property
    def partition(self):
        return self.context.partition

    @property
    def program(self):
        return self.context.program

    @property
    def schedule(self):
        return self.context.schedule

    @property
    def num_stages(self) -> int:
        return len(self.partition.stages)

    # -- execution ------------------------------------------------------------

    def __call__(self, *args: Any, backend: str | None = None) -> Any:
        return get_backend(backend or self.options.backend).execute(
            self, to_device(args, self.device))

    def stream(self, *args: Any) -> Any:
        """Run a stream of microbatches through the emulated systolic
        executor; args at ``options.stream_argnums`` have a leading
        microbatch axis (on every leaf of a tuple argument), outputs are
        stacked along it."""
        outs = self.schedule.pipeline.run_emulated(
            *self.flatten_inputs(to_device(args, self.device)))
        return self.unflatten_outputs(list(outs))

    def flatten_inputs(self, args: Sequence[Any]) -> list[Any]:
        """The leaves of ``args``, which are the program's inputs; the
        structure must be the example arguments'."""
        flat, spec = pytree.tree_flatten(tuple(args))
        if spec != self.context.in_tree:
            raise TypeError(
                f"arguments of structure {spec} do not match the compiled "
                f"structure {self.context.in_tree}")
        return flat

    def backends(self) -> tuple[str, ...]:
        """Backends available for this artifact in this environment."""
        return available_backends(self)

    def unflatten_outputs(self, flat: Sequence[Any]) -> Any:
        return pytree.tree_unflatten(list(flat), self.context.out_tree)

    # -- analysis -------------------------------------------------------------

    def _serve_defaults(self, kwargs: dict) -> dict:
        """Apply ``options.serve`` (a
        :class:`~repro_torch.dataflow.options.ServeOptions`): default the
        ``server`` argument to its address and install its
        timeout/backoff knobs as the serve-client configuration.  An
        explicit ``server=`` argument still wins."""
        sv = getattr(self.options, "serve", None)
        if sv is not None:
            kwargs.setdefault("server", sv.address or "auto")
            from ..serve import client as _serve_client
            _serve_client.configure_timeouts(sv.timeouts())
        return kwargs

    def simulate(self, n_iters: int = 2048, **kwargs: Any) -> SimReport:
        """Discrete-event simulation of this program on the template vs the
        fused conventional engine (see
        :func:`repro_torch.dataflow.schedule.simulate_schedule`).  The
        ``engine=`` keyword picks the resolution engine (``"torch"`` runs
        the solver's running max and the N-way cache replay on the
        card).  Pass ``server="auto"`` (or an address) to pre-resolve
        traces through a running resolution daemon."""
        return simulate_schedule(self.schedule, n_iters=n_iters,
                                 **self._serve_defaults(kwargs))

    def sweep(self, **kwargs: Any) -> Any:
        """Design-space sweep: grid the cycle simulator over memory models
        × FIFO depths × ``mem_in_scc`` modes, fully simulated (see
        :func:`repro_torch.dataflow.schedule.sweep_schedule`; dispatched
        through the ``simulate`` backend).  ``workers=N`` shards the trace
        resolution over the chunk-graph process pool and
        ``server="auto"`` (or an address) delegates it to a running
        resolution daemon; results stay bit-identical."""
        return get_backend("simulate").sweep(
            self, **self._serve_defaults(kwargs))

    def explore(self, **kwargs: Any) -> Any:
        """Partition-space DSE (see
        :func:`repro_torch.dataflow.dse.explore`): enumerate legal
        merge/split/duplicate re-partitionings of this kernel, prune
        against a :class:`~repro_torch.dataflow.options.ResourceConstraints`
        resource model, simulate every survivor, and return a
        :class:`~repro_torch.dataflow.dse.DseResult` whose
        cycles-vs-FIFO-bits Pareto front carries full ``Compiled``
        artifacts.  ``fifo_depths=[...]`` makes the FIFO depth a search
        axis; ``server="auto"`` resolves candidate traces through a
        running resolution daemon first."""
        from . import dse as _dse
        return _dse.explore(self, **self._serve_defaults(kwargs))

    @property
    def dse_result(self):
        """The ``dse`` pass's exploration (None unless ``options.dse``)."""
        return self.context.dse_result

    @property
    def transform_signature(self) -> str:
        """Active transformation-catalog signature (``"none"`` when the
        pipeline compiled untransformed)."""
        tf = getattr(self.schedule, "transforms", None)
        return tf.signature() if tf is not None else "none"

    def sim_stages(self, traces: Any = None, **kwargs: Any):
        """Cycle-simulator stage specs (II/latency/mem-in-SCC from the real
        partitioner, traces attached in pipeline order)."""
        return self.schedule.sim_stages(traces, **kwargs)

    def verify(self, fifo_depths: Sequence[int] | None = None,
               *, raise_on_error: bool = False) -> list:
        """Run the static dataflow verifier over this artifact: IR
        invariants (plan/partition/program), the decoupled-access race
        detector, and the FIFO deadlock analysis against
        ``fifo_depths`` (default: the DSE constraints' depth axis, else
        the simulator default of 8).  Returns
        the :class:`~repro_torch.dataflow.verify.Diagnostic` list — empty
        means clean; ``raise_on_error=True`` raises
        :class:`~repro_torch.dataflow.verify.VerifyError` on any
        error-severity finding."""
        from . import verify as _verify
        diags = _verify.verify_compiled(self, fifo_depths)
        if raise_on_error and any(d.severity == "error" for d in diags):
            raise _verify.VerifyError(diags, where="verify()")
        return diags

    def report(self) -> str:
        """Per-stage latency / channel summary."""
        sch = self.schedule
        opts = self.options
        lines = [
            f"dataflow program: {len(self.cdfg.nodes)} ops -> "
            f"{sch.num_stages} stages, {sch.num_channels} channels "
            f"({sch.channel_bytes}B/token), policy={opts.policy!r}, "
            f"backend={opts.backend!r}, device={self.device}",
            f"  pipeline II={sch.pipeline_ii}  "
            f"total latency={sch.total_latency}  "
            f"bubble@8mb={sch.bubble_fraction(8):.2f}",
            f"  passes: {' -> '.join(self.pipeline.names())}  "
            f"transforms: {self.transform_signature}",
        ]
        for s in sch.stages:
            tags = [t for t, on in (("MEM", s.has_memory),
                                    ("LONG", s.has_long),
                                    ("MEM-IN-SCC", s.mem_in_scc)) if on]
            prims = ",".join(s.prims[:6]) + ("…" if len(s.prims) > 6 else "")
            lines.append(
                f"  stage {s.id}: [{prims}] ii={s.ii} lat={s.latency} "
                f"in={s.in_channel_bytes}B out={s.out_channel_bytes}B "
                f"{'|'.join(tags)}"
                + (f" regions={list(s.regions)}" if s.regions else ""))
        for name, dt in self.context.timings.items():
            lines.append(f"  pass {name:<10} {dt * 1e3:8.2f} ms")
        diags = self.verify()
        errs = sum(d.severity == "error" for d in diags)
        warns = len(diags) - errs
        lines.append(
            "  verify: clean" if not diags else
            f"  verify: {errs} error(s), {warns} warning(s)")
        for d in diags[:4]:
            lines.append(f"    {d}")
        return "\n".join(lines)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"<Compiled {getattr(self.fn, '__name__', '?')} "
                f"stages={self.num_stages} backend={self.options.backend} "
                f"device={self.device}>")


# ---------------------------------------------------------------------------
# Compilation cache
# ---------------------------------------------------------------------------

_CACHE: dict[tuple, Compiled] = {}
_STATS = {"hits": 0, "misses": 0}


def _cache_key(ctx: CompileContext, pipeline: PassPipeline) -> tuple:
    # Consts are keyed by identity: symbolic_trace binds the *same* tensor
    # objects on retrace, and the cached Compiled keeps them alive, so ids
    # are stable exactly as long as the entry exists.
    g = ctx.graph
    return (
        g.code,
        tuple(str(v.aval) for v in g.invars),
        tuple(id(c) for c in g.consts),
        str(ctx.in_tree), str(ctx.out_tree),
        str(ctx.device),
        ctx.options,
        pipeline.signature(),
    )


def clear_cache() -> None:
    _CACHE.clear()
    _STATS["hits"] = _STATS["misses"] = 0


def cache_stats() -> dict[str, int]:
    return {"size": len(_CACHE), **_STATS}


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


def compile(  # noqa: A001 - deliberate: repro_torch.compile
    fn: Callable,
    *example_args: Any,
    options: CompileOptions | None = None,
    pipeline: PassPipeline | None = None,
    use_cache: bool = True,
    device: str | torch.device | None = None,
    **option_kwargs: Any,
) -> Compiled:
    """Compile ``fn`` for the dataflow template and return a
    :class:`Compiled` artifact.

    ``example_args`` are tensors (moved to the compile device).  Options
    come either as a :class:`CompileOptions` or as keyword shorthands
    (``compile(fn, x, policy="fused")``).  ``device`` defaults to the
    port's device policy (``"cuda"``); a CUDA request without a CUDA
    device raises.
    """
    dev = get_device(device)
    if options is None:
        options = CompileOptions(**option_kwargs)
    elif option_kwargs:
        options = options.replace(**option_kwargs)
    pipeline = pipeline or default_pipeline()

    ctx = CompileContext(fn=fn, example_args=example_args, options=options,
                         device=dev)
    # run the front end first: the cache key needs the traced graph
    pipeline.run(ctx, stop=1)
    key = None
    if use_cache and ctx.graph is not None:
        key = _cache_key(ctx, pipeline)
        hit = _CACHE.get(key)
        if hit is not None:
            _STATS["hits"] += 1
            return hit
        _STATS["misses"] += 1
    pipeline.run(ctx, start=1)
    compiled = Compiled(ctx, pipeline)
    if key is not None:
        _CACHE[key] = compiled
    return compiled


def _abstract_key(args: tuple) -> tuple:
    flat, spec = pytree.tree_flatten(args)
    return str(spec), tuple(
        (tuple(a.shape), str(a.dtype)) if isinstance(a, torch.Tensor)
        else (type(a).__name__,) for a in flat)


_log = logging.getLogger("repro_torch.dataflow")


def dataflow_jit(
    fn: Callable | None = None,
    *,
    options: CompileOptions | None = None,
    pipeline: PassPipeline | None = None,
    on_error: str = "raise",
    device: str | torch.device | None = None,
    **option_kwargs: Any,
) -> Callable:
    """Decorator form of :func:`compile`: traces lazily on first call (per
    argument-shape signature) and dispatches to the selected backend.

    ::

        @dataflow_jit(stream_argnums=(1,))
        def kernel(table, idx, w): ...

        kernel(table, idx, w)                      # options.backend
        kernel(table, idx, w, backend="emulated")  # explicit dispatch
        kernel.lower(table, idx, w).report()       # the Compiled artifact

    Keyword arguments to the wrapped function are bound to positional form
    via its signature (``backend`` is reserved for dispatch).

    ``on_error="fallback"``: if the analysis pipeline fails on some input
    shape, the call logs a warning and runs ``fn`` directly (``lower``
    still raises, so the failure stays inspectable; an explicit
    ``backend=`` is never rerouted).
    """
    if on_error not in ("raise", "fallback"):
        raise ValueError(f"on_error must be 'raise' or 'fallback', "
                         f"got {on_error!r}")
    if options is None:
        opts = CompileOptions(**option_kwargs)
    elif option_kwargs:
        opts = options.replace(**option_kwargs)
    else:
        opts = options

    def wrap(f: Callable) -> Callable:
        by_shape: dict[tuple, Compiled | None] = {}
        errors: dict[tuple, Exception] = {}
        state: dict[str, Any] = {}
        _unset = object()

        def bind(args: tuple, kwargs: dict) -> tuple:
            if not kwargs:
                return args
            if "sig" not in state:
                state["sig"] = inspect.signature(f)
            return state["sig"].bind(*args, **kwargs).args

        def lower(*args: Any, **kwargs: Any) -> Compiled:
            args = bind(args, kwargs)
            key = _abstract_key(args)
            compiled = by_shape.get(key)
            if compiled is None:
                compiled = compile(f, *args, options=opts,
                                   pipeline=pipeline, device=device)
                by_shape[key] = compiled
            return compiled

        def wrapper(*args: Any, backend: str | None = None,
                    **kwargs: Any) -> Any:
            args = bind(args, kwargs)
            key = _abstract_key(args)
            compiled = by_shape.get(key, _unset)
            if compiled is _unset:
                try:
                    compiled = compile(f, *args, options=opts,
                                       pipeline=pipeline, device=device)
                except Exception as e:
                    if on_error != "fallback":
                        raise
                    _log.warning(
                        "dataflow analysis of %s failed; running it "
                        "directly", getattr(f, "__name__", f), exc_info=True)
                    compiled = None
                    errors[key] = e
                by_shape[key] = compiled
            if compiled is None:  # analysis failed earlier; fused fallback
                if backend is not None:
                    raise RuntimeError(
                        f"dataflow analysis failed for this input shape; "
                        f"cannot honor backend={backend!r}"
                    ) from errors.get(key)
                return f(*args)
            return compiled(*args, backend=backend)

        wrapper.__name__ = getattr(f, "__name__", "dataflow_jit")
        wrapper.__doc__ = getattr(f, "__doc__", None)
        wrapper.__wrapped__ = f
        wrapper.lower = lower
        wrapper.options = opts
        return wrapper

    return wrap(fn) if fn is not None else wrap
