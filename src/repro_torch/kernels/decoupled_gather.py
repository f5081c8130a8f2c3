"""Decoupled gather: the paper's template made explicit inside one kernel.

``out[i] = fn(table[idx[i]])`` with the three template roles written out
by hand, as in the reference's Pallas kernel: an **access stage** that
loads the indices and issues the row copies ahead, a **FIFO channel** of
row slots in shared memory guarded per slot, and an **execute stage**
that computes each resident row while later ones are in flight.  Two
designs, see ``csrc/decoupled_gather.cu``; :func:`gather_route` picks one
from the row width and the alignment, before the launch:

* ``"bulk-copy ring"`` — rows a multiple of 16 bytes on a 16-byte-aligned
  table: a persistent grid whose producer warp issues one 1-D bulk copy
  (``cp.async.bulk``) per row (2 KB pieces of wider rows) into a 32-slot
  ring guarded by full / empty mbarriers, drained by eight consumer warps;
* ``"cp.async ring"`` — other rows of a multiple of 4 bytes: each warp
  walks its own run of rows through a two-slot ``cp.async`` ring; its
  rows must fit the ring (29,056 bytes at most).

Indices wrap (negative ones, once, by R) and then clamp into [0, R), as
the reference's jnp indexing does, on every path.

A kernel cannot run a Python callable, so on the card ``fn`` is one of a
named set (:data:`ROW_FNS`): ``None``, the reference's default
``tanh(2·row)``, and ``"identity"``.  The plain version
(:func:`decoupled_gather_ref`) and the compiler-derived
:func:`decoupled_gather_staged` take those names or any elementwise
callable.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

from .._device import get_device
from . import _lib

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

BULK = "bulk-copy ring"
CP_ASYNC = "cp.async ring"
_ENTRY = {BULK: "decoupled_gather_bulk", CP_ASYNC: "decoupled_gather_cp_async"}


def _tanh2(row: torch.Tensor) -> torch.Tensor:
    return torch.tanh(row * 2.0)


def _identity(row: torch.Tensor) -> torch.Tensor:
    return row


#: the row functions the kernel computes, by the name ``fn`` gives them,
#: in the order of the kernel's ``fn`` codes
ROW_FNS: dict[str | None, Callable[[torch.Tensor], torch.Tensor]] = {
    None: _tanh2, "identity": _identity}
_FN_CODE = {name: code for code, name in enumerate(ROW_FNS)}


def _row_fn(fn: str | Callable | None) -> Callable:
    if callable(fn):
        return fn
    if fn in ROW_FNS:
        return ROW_FNS[fn]
    raise ValueError(f"unknown row function {fn!r}: name one of "
                     f"{sorted(map(repr, ROW_FNS))} or pass a callable")


def decoupled_gather_ref(idx: torch.Tensor, table: torch.Tensor,
                         fn: str | Callable | None = None) -> torch.Tensor:
    """Plain version: ``fn(table[idx])``, each index wrapped by R if it is
    negative and then clamped into [0, R), as the reference's jnp indexing
    is.  ``fn`` is a name of :data:`ROW_FNS` or an elementwise callable (as
    the reference's ``vmap`` of a row function is, for an elementwise
    one)."""
    R = table.shape[0]
    rows = idx.long()
    rows = torch.where(rows < 0, rows + R, rows).clamp(0, max(R - 1, 0))
    return _row_fn(fn)(table[rows])


def gather_route(table: torch.Tensor) -> str:
    """The design ``decoupled_gather`` takes on the card for a contiguous
    ``table`` whose rows are a multiple of 4 bytes: the bulk-copy ring for
    rows of a multiple of 16 bytes on a 16-byte-aligned base, else the
    ``cp.async`` ring."""
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes % 16 == 0 and table.data_ptr() % 16 == 0:
        return BULK
    return CP_ASYNC


def decoupled_gather(idx: torch.Tensor, table: torch.Tensor, *,
                     fn: str | Callable | None = None) -> torch.Tensor:
    """``out[i] = fn(table[idx[i]])`` with explicit access/execute
    decoupling.  idx: (N,) integer, cast to int32 as the reference casts
    it; table: (R, D) float32 or bfloat16; returns (N, D) in the table's
    dtype.  Negative indices wrap once, then every index clamps into
    [0, R), as in the reference.

    A CPU tensor takes the plain version, with any ``fn``; a CUDA tensor
    launches the kernel of its :func:`gather_route`, which computes
    ``fn=None`` (``tanh(2·row)`` in fp32, rounded once; for bf16 by the
    hardware's tanh, within one bf16 ulp of the plain version) or
    ``fn="identity"``, and raises on anything else.  The ``cp.async``
    ring's rows must fit its shared memory; it reports a CUDA error
    (raised here) for wider ones.
    """
    _lib.forbid_autograd("decoupled_gather", table)
    if idx.ndim != 1 or table.ndim != 2:
        raise ValueError(f"decoupled_gather: idx {tuple(idx.shape)} is not "
                         f"(N,) or table {tuple(table.shape)} is not (R, D)")
    idx = idx.to(torch.int32).contiguous()   # the kernel reads it densely
    if table.device.type == "cpu":
        return decoupled_gather_ref(idx, table, fn)
    if callable(fn) or fn not in _FN_CODE:
        raise ValueError(
            f"decoupled_gather on the card computes a named fn: None "
            f"(tanh(2*row)) or 'identity', not {fn!r}; a Python callable "
            f"runs in decoupled_gather_ref or decoupled_gather_staged")
    if table.device.type != "cuda" or idx.device != table.device:
        raise ValueError("decoupled_gather: idx and table must lie on one "
                         "CUDA device (or both on the CPU)")
    if table.dtype not in _SUFFIX:
        raise TypeError(f"decoupled_gather kernel takes a float32 or "
                        f"bfloat16 table, got {table.dtype}")
    row_bytes = table.shape[1] * table.element_size()
    if not table.is_contiguous() or row_bytes % 4 \
            or table.data_ptr() % 4:
        raise ValueError("decoupled_gather kernel takes a contiguous table "
                         "whose rows are a multiple of 4 bytes")
    return _launch(idx, table, fn, gather_route(table))


def _launch(idx: torch.Tensor, table: torch.Tensor, fn: str | None,
            design: str) -> torch.Tensor:
    """Launch the kernel of ``design`` on checked CUDA tensors."""
    (R, D), N = table.shape, idx.shape[0]
    out = torch.empty((N, D), dtype=table.dtype, device=table.device)
    if out.numel() == 0:
        return out
    if R == 0:
        raise IndexError("decoupled_gather: gather from an empty table")
    with torch.cuda.device(table.device):
        err = getattr(_lib.lib("decoupled_gather"),
                      f"{_ENTRY[design]}_{_SUFFIX[table.dtype]}")(
            idx.data_ptr(), table.data_ptr(), out.data_ptr(), N, R, D,
            _FN_CODE[fn], _lib.stream())
        _lib.LAUNCHES["decoupled_gather"] += 1
        _lib.ROUTES["decoupled_gather"][design] += 1
    _lib.check("decoupled_gather", err)
    return out


@functools.lru_cache(maxsize=None)
def _staged_gather(fn: Callable, backend: str, device: torch.device):
    from ..dataflow import dataflow_jit

    def gather_fn(idx, table):
        return fn(table[idx])

    return dataflow_jit(gather_fn, stream_argnums=(0,), backend=backend,
                        device=device)


def decoupled_gather_staged(idx: torch.Tensor, table: torch.Tensor, *,
                            fn: str | Callable | None = None,
                            backend: str = "sequential") -> torch.Tensor:
    """The same decoupling, derived by the compiler driver instead of
    written by hand: :mod:`repro_torch.dataflow` partitions
    ``fn(table[idx])`` at the gather (Algorithm 1) and runs the stages on
    ``backend``, on the port's default device.  Bit-identical to
    :func:`decoupled_gather_ref` on the same device.

    The driver wrapper is memoised per (fn, backend, device), so repeated
    calls skip retracing (``fn`` must be a stable function object)."""
    return _staged_gather(_row_fn(fn), backend, get_device())(idx, table)


def _lower_staged(idx: torch.Tensor, table: torch.Tensor, *,
                  fn: str | Callable | None = None,
                  backend: str = "sequential"):
    return _staged_gather(_row_fn(fn), backend, get_device()).lower(idx,
                                                                    table)


#: the compiled program behind a call (its ``report()``, plan and
#: backends), as ``dataflow_jit``'s ``.lower`` gives it
decoupled_gather_staged.lower = _lower_staged
