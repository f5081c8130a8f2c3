"""Decoupled gather: the paper's template made explicit inside one kernel.

``out[i] = fn(table[idx[i]])`` with the three template roles written out
by hand, as in the reference's Pallas kernel:

* **access stage**: row ``idx[i+1]``'s copy is issued (``cp.async``)
  before row ``i`` is computed — the memory stage running ahead;
* **FIFO channel**: a two-slot ring in shared memory, one copy group per
  slot — the bounded queue between the stages;
* **execute stage**: waits on its own slot and computes the resident row
  while the next one is in flight.

Each warp runs that pipeline over its own run of rows and loads the
run's indices first, so the address stream is ahead of the data stream.
See ``csrc/decoupled_gather.cu``.

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
    """Plain version: ``fn(table[idx])``.  ``fn`` is a name of
    :data:`ROW_FNS` or an elementwise callable (as the reference's ``vmap``
    of a row function is, for an elementwise one)."""
    return _row_fn(fn)(table[idx])


def decoupled_gather(idx: torch.Tensor, table: torch.Tensor, *,
                     fn: str | Callable | None = None) -> torch.Tensor:
    """``out[i] = fn(table[idx[i]])`` with explicit access/execute
    decoupling.  idx: (N,) integer, cast to int32 as the reference casts
    it; table: (R, D) float32 or bfloat16; returns (N, D) in the table's
    dtype.  Negative indices wrap as in Python.

    A CPU tensor takes the plain version, with any ``fn``; a CUDA tensor
    launches the kernel, which computes ``fn=None`` (``tanh(2·row)`` in
    fp32, rounded once) or ``fn="identity"``, and raises on anything else.
    The kernel's rows must fit its shared-memory ring; it reports a CUDA
    error (raised here) for wider ones.
    """
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
    R, D = table.shape
    row_bytes = D * table.element_size()
    if not table.is_contiguous() or row_bytes % 4 \
            or table.data_ptr() % 4:
        raise ValueError("decoupled_gather kernel takes a contiguous table "
                         "whose rows are a multiple of 4 bytes")
    out = torch.empty((idx.shape[0], D), dtype=table.dtype,
                      device=table.device)
    if out.numel() == 0:
        return out
    if R == 0:
        raise IndexError("decoupled_gather: gather from an empty table")
    with torch.cuda.device(table.device):
        err = getattr(_lib.lib("decoupled_gather"),
                      f"decoupled_gather_{_SUFFIX[table.dtype]}")(
            idx.data_ptr(), table.data_ptr(), out.data_ptr(), idx.shape[0],
            R, D, _FN_CODE[fn], _lib.stream())
        _lib.LAUNCHES["decoupled_gather"] += 1
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
