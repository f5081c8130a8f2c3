"""Pluggable execution backends for compiled dataflow programs.

A backend turns a :class:`~repro_torch.dataflow.driver.Compiled` artifact
plus call arguments into results.  The registry maps names to backend
objects; ``Compiled.__call__(... , backend="name")`` dispatches here.
Registering a new backend is one call::

    @register_backend
    class MyBackend(Backend):
        name = "mine"
        def execute(self, compiled, args): ...

Built-ins:

* ``sequential`` — replay the decoupled stages in topological order
  (bit-exact oracle for the pipelined executors).
* ``emulated``   — the tick-by-tick systolic schedule on one device
  (schedule-exact).
* ``systolic``   — the same schedule with stage *s* on rank *s* of the
  initialised ``torch.distributed`` group (needs ``num_stages`` ranks;
  :func:`repro_torch.launch.mesh.spawn` or ``torchrun`` starts them).
* ``eager``      — the original function, called directly: the fused
  conventional-accelerator baseline (the reference's ``xla`` backend).
* ``simulate``   — the discrete-event machine model; returns a
  :class:`~repro_torch.dataflow.schedule.SimReport` instead of outputs.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.distributed as dist

from ..core.decouple import run_stages_sequential


class BackendUnavailableError(RuntimeError):
    """Raised when a backend cannot run in the current environment."""


class Backend:
    """Base class: subclasses set ``name`` and implement ``execute``."""

    name: str = "?"
    kind: str = "execute"  # "execute" backends return fn's outputs

    def is_available(self, compiled: Any) -> bool:
        return True

    def execute(self, compiled: Any, args: Sequence[Any]) -> Any:
        raise NotImplementedError

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<backend {self.name!r} ({self.kind})>"


_REGISTRY: dict[str, Backend] = {}


def register_backend(backend: Any = None, *, overwrite: bool = False) -> Any:
    """Register a backend instance or class (instantiated with no args).
    Usable as a decorator."""
    if backend is None:
        return lambda b: register_backend(b, overwrite=overwrite)
    inst = backend() if isinstance(backend, type) else backend
    if inst.name in _REGISTRY and not overwrite:
        raise ValueError(f"backend {inst.name!r} already registered")
    _REGISTRY[inst.name] = inst
    return backend


def unregister_backend(name: str) -> None:
    _REGISTRY.pop(name, None)


def get_backend(name: str) -> Backend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown backend {name!r}; registered: "
            f"{sorted(_REGISTRY)}") from None


def registered_backends() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def execute_backends() -> tuple[str, ...]:
    """Names of backends that produce the function's outputs."""
    return tuple(sorted(n for n, b in _REGISTRY.items()
                        if b.kind == "execute"))


def available_backends(compiled: Any) -> tuple[str, ...]:
    return tuple(sorted(n for n, b in _REGISTRY.items()
                        if b.is_available(compiled)))


# ---------------------------------------------------------------------------
# Built-ins
# ---------------------------------------------------------------------------


def _one_microbatch(compiled: Any, args: Sequence[Any]) -> list[Any]:
    """Single-shot call → one-microbatch stream: the program's inputs,
    the leaves of stream args gaining a leading axis of 1."""
    flat = compiled.flatten_inputs(args)
    for i in compiled.schedule.stream_argnums:
        if i < len(flat):
            flat[i] = torch.as_tensor(flat[i])[None]
    return flat


@register_backend
class SequentialBackend(Backend):
    name = "sequential"

    def execute(self, compiled: Any, args: Sequence[Any]) -> Any:
        outs = run_stages_sequential(compiled.program,
                                     *compiled.flatten_inputs(args))
        return compiled.unflatten_outputs(outs)


@register_backend
class EmulatedBackend(Backend):
    name = "emulated"

    def execute(self, compiled: Any, args: Sequence[Any]) -> Any:
        outs = compiled.schedule.pipeline.run_emulated(
            *_one_microbatch(compiled, args))
        return compiled.unflatten_outputs([o[0] for o in outs])


@register_backend
class SystolicBackend(Backend):
    """Stage *s* on rank *s* of the initialised ``torch.distributed``
    group (:meth:`SystolicPipeline.build_sharded`); the first
    ``num_stages`` ranks run the stages and every rank gets the outputs.
    SPMD: every rank makes the same call.  Outside such a group it
    raises :class:`BackendUnavailableError` — the stages never run
    somewhere else instead."""

    name = "systolic"

    def is_available(self, compiled: Any) -> bool:
        return (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() >= compiled.num_stages)

    def _runner(self, compiled: Any):
        cached = compiled.runtime_cache.get(self.name)
        if cached is not None:
            return cached
        S = compiled.num_stages
        if not self.is_available(compiled):
            have = (f"a group of {dist.get_world_size()} ranks"
                    if dist.is_available() and dist.is_initialized()
                    else "no torch.distributed group")
            raise BackendUnavailableError(
                f"systolic backend needs {S} ranks (one per stage), have "
                f"{have}; run the call on every rank under "
                f"repro_torch.launch.mesh.spawn(fn, {S}, ...) or torchrun "
                f"--nproc-per-node {S}, or use the 'emulated' backend")
        run = compiled.schedule.pipeline.build_sharded()
        compiled.runtime_cache[self.name] = run
        return run

    def execute(self, compiled: Any, args: Sequence[Any]) -> Any:
        outs = self._runner(compiled)(*_one_microbatch(compiled, args))
        return compiled.unflatten_outputs([o[0] for o in outs])


@register_backend
class EagerBackend(Backend):
    """The fused baseline: call the original function unchanged.  This is
    the conventional-accelerator counterpart — the driver still yields
    the partition/schedule analysis around it."""

    name = "eager"

    def execute(self, compiled: Any, args: Sequence[Any]) -> Any:
        return compiled.fn(*args)


@register_backend
class SimulateBackend(Backend):
    """Discrete-event machine model (Fig. 2/5); ignores call arguments and
    returns a SimReport.  Also hosts the design-space sweep
    (``Compiled.sweep`` dispatches here)."""

    name = "simulate"
    kind = "analyze"

    def execute(self, compiled: Any, args: Sequence[Any]) -> Any:
        del args
        return compiled.simulate()

    def sweep(self, compiled: Any, **kwargs: Any) -> Any:
        from .schedule import sweep_schedule
        return sweep_schedule(compiled.schedule, **kwargs)
