"""repro_torch.dataflow — the compiler driver for the dataflow template.

One entry point for the paper's whole flow::

    from repro_torch.dataflow import compile

    c = compile(body, acc, j, loop=True)        # on the card by default
    c(acc, j, backend="emulated")               # run the stages
    print(c.report()); print(c.simulate().summary())

Internals (all public, all swappable):

* :mod:`~repro_torch.dataflow.options`  — :class:`CompileOptions`.
* :mod:`~repro_torch.dataflow.passes`   — the ordered pass pipeline
  (trace → memdep → transform → partition → rewrite → dse → decouple →
  schedule).
* :mod:`~repro_torch.dataflow.backends` — the execution-backend registry
  (``sequential`` / ``emulated`` / ``eager`` / ``simulate``).
* :mod:`~repro_torch.dataflow.schedule` — static schedule analysis and the
  Fig. 2/5 simulation report.
* :mod:`~repro_torch.dataflow.dse` — the partition-space design-space
  explorer (``Compiled.explore``, the ``dse`` pass).
* :mod:`~repro_torch.dataflow.transforms` — the HLS transformation catalog.
* :mod:`~repro_torch.dataflow.verify` — the static dataflow verifier.
"""

from .backends import (Backend, BackendUnavailableError, available_backends,
                       execute_backends, get_backend, register_backend,
                       registered_backends, unregister_backend)
from .driver import (Compiled, cache_stats, clear_cache, compile,
                     dataflow_jit)
from .dse import (DseCandidate, DseResult, enumerate_plans, explore,
                  explore_plans, partition_resources)
from .options import CompileOptions, ResourceConstraints, ServeOptions
from .passes import (CompileContext, DecouplePass, DsePass, MemoryDepPass,
                     Pass, PartitionPass, PassPipeline, RewritePass,
                     SchedulePass, TracePass, TransformPass,
                     default_pipeline)
from .schedule import (Schedule, SimReport, StageSummary, SweepResult,
                       fused_stage, simulate_schedule, sweep_schedule)
from .transforms import TransformConfig, TransformError
from .verify import (RULES, Diagnostic, VerifyError, chain_deadlock_bound,
                     deadlock_min_depth, fifo_depth_diagnostics,
                     verify_compiled, verify_partition, verify_plan,
                     verify_program)

__all__ = [
    "Backend", "BackendUnavailableError", "available_backends",
    "execute_backends", "get_backend", "register_backend",
    "registered_backends", "unregister_backend",
    "Compiled", "cache_stats", "clear_cache", "compile", "dataflow_jit",
    "DseCandidate", "DseResult", "enumerate_plans", "explore",
    "explore_plans", "partition_resources",
    "CompileOptions", "ResourceConstraints", "ServeOptions",
    "CompileContext", "Pass", "PassPipeline", "TracePass", "MemoryDepPass",
    "PartitionPass", "RewritePass", "DsePass", "DecouplePass",
    "SchedulePass", "TransformPass", "default_pipeline",
    "Schedule", "SimReport", "StageSummary", "SweepResult", "fused_stage",
    "simulate_schedule", "sweep_schedule",
    "TransformConfig", "TransformError",
    "RULES", "Diagnostic", "VerifyError", "chain_deadlock_bound",
    "deadlock_min_depth", "fifo_depth_diagnostics", "verify_compiled",
    "verify_partition", "verify_plan", "verify_program",
]
