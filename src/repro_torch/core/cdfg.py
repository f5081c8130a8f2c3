"""CDFG construction from ``torch.fx`` graphs — the port's front end.

The paper (Cheng & Wawrzynek 2016) operates on the control-dataflow graph
of a performance-critical loop nest, produced by the LLVM front end from
C.  The reference package traces with ``jax.make_jaxpr``; the port traces
with ``torch.fx.symbolic_trace`` (``make_fx`` cannot trace a loop body
that indexes with a 0-d tensor: ``cols[j]`` calls
``aten._local_scalar_dense``) and *lowers* each FX node into the
reference's primitive vocabulary through one table (:data:`_LOWERING`):

* a ``__getitem__`` with a 0-d integer index expands into the five
  equations the jaxpr of ``x[j]`` has — ``lt, add, select_n,
  dynamic_slice, squeeze`` (negative-index wrap, then a one-row slice);
  with a 1-D integer index vector, into those of ``x[idx]`` — ``lt, add,
  select_n, broadcast_in_dim, gather`` (the wrap, the (N, 1) index, then
  a gather of whole rows);
* :func:`at_set` (the port's ``x.at[i].set(v)``) into the five
  equations of the jaxpr's out-of-place store — ``lt, add, select_n,
  broadcast_in_dim, scatter`` (the wrap, the (1,) index, then a scatter
  that drops an index still out of range);
* :func:`at_add` (the port's ``x.at[idx].add(v)``) into those of
  ``x.at[idx].add(v)`` — the wrap, the (N, 1) index, one ``scatter-add``
  that drops an index still out of range; :func:`scan` (the port's
  ``jax.lax.scan``) into one ``scan`` equation whose body is the step's
  own lowered sub-graph, and :func:`checkpoint` (``jax.checkpoint`` of a
  scan body) into one ``remat2`` equation whose body is the body's; a
  function marked with a ``primitive`` (the MoE's ``top_k``) into one
  equation of it;
* inside :func:`leaves`, a function named there as an ``index`` leaf
  (``x[idx]`` with the reference's wrap-then-clamp read) into those of
  ``x[idx]``, one named as a ``scan`` leaf (a loop kept inside one
  call: a model segment's repeats) into one ``scan`` equation, as
  ``jax.lax.scan`` is one in the jaxpr, and one named as a ``grad``
  leaf (``value_and_grad`` of a loss) into the loss's equations and
  their transposes (:mod:`repro_torch.core.autodiff`);
* a static index (``...`` too) into ``slice`` / ``squeeze`` /
  ``broadcast_in_dim`` (one with a negative int into ``jnp``'s
  ``dynamic_slice``), ``x.mean`` into ``reduce_sum, broadcast_in_dim,
  div``, ``x.var`` into one ``jit`` (``jnp.var`` is a jitted function),
  as are ``torch.clamp`` (``jnp.clip``), ``%`` (``jnp.remainder``),
  ``torch.where`` and ``masked_fill`` (``jnp.where``),
  ``torch.log_softmax``, ``F.silu``, ``torch.tril``,
  ``F.pad``, ``x.cumsum`` and a function with a ``jit_name``,
  ``x.float()`` / ``x.to(dtype)`` into ``convert_element_type``
  (nothing when the dtype stays), a two-operand ``torch.einsum`` (as
  ``jnp.einsum`` spells it, a ``transpose`` after where it takes one)
  and ``torch.bmm`` into ``dot_general``, ``reshape`` / ``permute`` /
  ``transpose`` / ``split`` / ``chunk`` / ``expand`` /
  ``repeat_interleave`` into the jaxpr's layout equations,
  ``torch.arange(n)`` into ``iota`` (of several numbers: a constant),
  ``torch.full`` / ``torch.zeros`` / ``torch.ones`` into a
  ``broadcast_in_dim`` of a literal, ``clamp_min`` / ``amax`` into ``max`` / ``reduce_max``,
  ``x ** 2`` into ``integer_pow``, rank and dtype promotion into a
  ``broadcast_in_dim`` / ``convert_element_type``, and
  ``t.new_tensor(c)`` into a weakly typed literal (``jnp``'s Python
  numbers: a typed operand beside a weak value converts it) — what the
  decode step's and the train step's top levels need (every proxy's
  shape is static: :class:`_Proxy`);
* ``operator.mul`` → ``mul``, ``operator.add`` → ``add``, and so on.

So :data:`MEMORY_PRIMITIVES`, :data:`DEFAULT_LATENCY`,
:data:`CHEAP_PRIMITIVES` and Algorithm 1 apply unchanged, and a body
compiles to the same plan as its JAX twin.  The lowered program is a
:class:`Graph` of :class:`Eqn` records over :class:`Var` values; each
``Var`` carries an :class:`Aval` (``shape`` and a ``torch.dtype``, whose
``itemsize`` is all the partitioner reads).  Closed-over tensors become
constants named ``const{k}`` in first-use order, as in the reference.
A tuple argument is flattened into one input per leaf, in order, as the
jaxpr's invars are, and keyword examples follow the positional ones by
sorted name; outputs are flattened likewise.

Two views are provided:

* :func:`CDFG.from_function` — acyclic dataflow graph of a traced function.
* :func:`CDFG.from_loop_body` — the faithful §III view: the body of a loop
  is traced, and back-edges are added from each carry output to the
  matching carry input, recreating the cyclic CDFG on which Algorithm 1's
  ``allStronglyConnComps`` runs for real.

Memory-dependence edges (§III-A) are inserted between memory operations
that touch the same *region*, found by tracing each memory op's operand
back through layout-only ops to a graph input or constant, or set by user
annotation — the analogue of the paper's user-guided alias results.
"""

from __future__ import annotations

import builtins
import contextlib
import dataclasses
import functools
import inspect
import math
import operator
from typing import Any, Callable, Iterable, Iterator, Mapping, Sequence

import torch
import torch.fx as fx
import torch.utils._pytree as pytree
from torch.fx.passes.shape_prop import ShapeProp

from .. import tree
from .._device import get_device

# ---------------------------------------------------------------------------
# Operation classification (the paper's "long latency" table, §III-A) —
# the reference's tables, unchanged, so the lowered graph is classified
# exactly like its jaxpr twin.
# ---------------------------------------------------------------------------

#: primitives that perform data-dependent / strided memory traffic — the
#: template's "memory operations".
MEMORY_PRIMITIVES: frozenset[str] = frozenset({
    "gather",
    "scatter",
    "scatter-add",
    "scatter-mul",
    "scatter-min",
    "scatter-max",
    "scatter_add",
    "dynamic_slice",
    "dynamic_update_slice",
    "take",
    "argsort",  # permutation materialization reads/writes memory irregularly
})

#: default per-primitive latency (abstract cycles).  Anything > 1 is "long
#: latency" in the Algorithm-1 sense.  Unlisted primitives default to 1.
DEFAULT_LATENCY: dict[str, int] = {
    # contraction
    "dot_general": 8,
    "conv_general_dilated": 8,
    # transcendentals (multi-pass)
    "exp": 4, "log": 4, "log1p": 4, "tanh": 4, "logistic": 4, "erf": 4,
    "sin": 4, "cos": 4, "pow": 4, "integer_pow": 2, "rsqrt": 4, "sqrt": 4,
    "div": 4, "cbrt": 4, "exp2": 4,
    # float multiply-class ops: the paper's canonical 4-cycle example
    "mul": 4,
    # reductions / scans are multi-pass
    "reduce_sum": 2, "reduce_max": 2, "reduce_min": 2, "reduce_prod": 2,
    "cumsum": 4, "cumlogsumexp": 4, "cummax": 4, "cumprod": 4,
    "sort": 8, "top_k": 8,
    # loop / control primitives carry their body's latency; treated long
    "scan": 8, "while": 8, "cond": 2, "pjit": 8, "custom_call": 8,
    # memory ops: the *issue* cost; the stall cost is the memory model's job
    "gather": 2, "scatter": 2, "scatter-add": 2,
    "dynamic_slice": 2, "dynamic_update_slice": 2,
}

#: layout-only primitives that are transparent when tracing a memory operand
#: back to its root buffer.  In-place-update ops (scatter, dus) are also
#: transparent on operand 0: the functional output aliases the input buffer,
#: so loads from the updated array belong to the same memory region.
_TRANSPARENT = frozenset({
    "convert_element_type", "reshape", "transpose", "broadcast_in_dim",
    "squeeze", "bitcast_convert_type", "copy", "rev", "slice",
    "scatter", "scatter-add", "scatter-mul", "scatter-min", "scatter-max",
    "dynamic_update_slice",
})

# integer "cheap" ops eligible for duplication instead of a channel (§III-B1)
CHEAP_PRIMITIVES: frozenset[str] = frozenset({
    "add", "sub", "and", "or", "xor", "not", "lt", "le", "gt", "ge", "eq",
    "ne", "select_n", "max", "min", "shift_left", "shift_right_logical",
    "shift_right_arithmetic", "convert_element_type", "broadcast_in_dim",
    "reshape", "squeeze", "iota", "concatenate", "pad", "slice", "transpose",
    "rem", "sign", "neg", "abs", "floor", "ceil", "round", "clamp",
})


@dataclasses.dataclass
class LatencyModel:
    """Maps primitives to abstract cycle latencies (paper §III-A).

    ``table`` overrides :data:`DEFAULT_LATENCY`; ``default`` is used for
    unknown primitives.  ``long_threshold`` is the Algorithm-1 cut: ops that
    "cannot be completed within one clock cycle".
    """

    table: Mapping[str, int] = dataclasses.field(default_factory=dict)
    default: int = 1
    long_threshold: int = 1

    def latency(self, prim_name: str) -> int:
        if prim_name in self.table:
            return self.table[prim_name]
        return DEFAULT_LATENCY.get(prim_name, self.default)

    def is_long(self, prim_name: str) -> bool:
        return self.latency(prim_name) > self.long_threshold


# ---------------------------------------------------------------------------
# The lowered program
# ---------------------------------------------------------------------------

_SHORT = {torch.float32: "f32", torch.float64: "f64", torch.float16: "f16",
          torch.bfloat16: "bf16", torch.int64: "i64", torch.int32: "i32",
          torch.int16: "i16", torch.int8: "i8", torch.uint8: "u8",
          torch.bool: "bool"}


@dataclasses.dataclass(frozen=True)
class Aval:
    """Abstract value: what the partitioner reads of a graph value."""

    shape: tuple[int, ...]
    dtype: torch.dtype
    #: a value made of Python numbers alone (``jnp.maximum(1.0, 200)``):
    #: JAX's weak type, which a binary op with a typed operand first
    #: converts (one ``convert_element_type``)
    weak: bool = False

    def __str__(self) -> str:
        dims = ",".join(str(d) for d in self.shape)
        return f"{_SHORT.get(self.dtype, str(self.dtype))}[{dims}]"


class Var:
    """One SSA value of the lowered graph (hashed by identity)."""

    __slots__ = ("aval", "name")

    def __init__(self, aval: Aval, name: str):
        self.aval = aval
        self.name = name

    def __repr__(self) -> str:
        return f"{self.name}:{self.aval}"


@dataclasses.dataclass(frozen=True)
class Literal:
    """A Python scalar operand (never a channel payload)."""

    val: Any
    aval: Aval


@dataclasses.dataclass(eq=False)
class Eqn:
    """One primitive application: ``outvars = impl(*invars, **params)``.
    ``source`` names the FX node it was lowered from; ``name`` is a
    ``jit`` equation's function name (the jaxpr's ``name`` param)."""

    prim: str
    invars: list[Any]
    outvars: list[Var]
    params: dict[str, Any]
    impl: Callable[..., Any]
    source: str
    name: str = ""

    def eval(self, *invals: Any) -> Any:
        return self.impl(*invals, **self.params)


@dataclasses.dataclass(eq=False)
class Graph:
    """The lowered program of a traced function — the port's counterpart
    of a closed jaxpr: equations, inputs, outputs, and the closed-over
    constants (``constvars[k]`` is bound to ``consts[k]``).  ``code`` is
    the FX graph's text (part of the compile-cache key)."""

    eqns: list[Eqn]
    invars: list[Var]
    outvars: list[Any]
    constvars: list[Var]
    consts: list[torch.Tensor]
    code: str

    def __str__(self) -> str:
        lines = [f"{{ consts {self.constvars}; inputs {self.invars}"]
        for e in self.eqns:
            args = ", ".join(repr(v.val) if isinstance(v, Literal) else
                             repr(v) for v in e.invars)
            lines.append(f"    {e.outvars[0]!r} = {e.prim}({args})")
        lines.append(f"  out {self.outvars} }}")
        return "\n".join(lines)


# -- primitive implementations (the stage programs evaluate these) ----------

def _extremum(pick: Callable, python: Callable) -> Callable:
    """``max`` / ``min`` of tensors or numbers (a literal operand takes
    the other operand's dtype and device, as in the jaxpr)."""
    def impl(a: Any, b: Any) -> Any:
        if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
            return python(a, b)
        like = a if isinstance(a, torch.Tensor) else b
        return pick(*(torch.as_tensor(v, dtype=like.dtype, device=like.device)
                      for v in (a, b)))
    return impl


def _select_n(pred: Any, on_false: Any, on_true: Any) -> Any:
    if not isinstance(pred, torch.Tensor):     # an equation of literals
        return on_true if pred else on_false
    return torch.where(pred, on_true, on_false)


def _dynamic_slice(operand: torch.Tensor, *starts: Any,
                   slice_sizes: tuple[int, ...]) -> torch.Tensor:
    # each start clamped into range like the reference's dynamic_slice; a
    # start that is a tensor (the lowering of x[j]) read on the device, a
    # number (a negative static index wrapped) a view
    out = operand
    for d, (start, n) in enumerate(zip(starts, slice_sizes)):
        hi = operand.shape[d] - n
        if isinstance(start, torch.Tensor):
            rows = torch.clamp(start, 0, hi).reshape(1).long()
            if n > 1:
                rows = rows + torch.arange(n, device=rows.device)
            out = torch.index_select(out, d, rows)
        elif n != operand.shape[d]:
            out = out.narrow(d, min(max(int(start), 0), hi), n)
    return out


def _dynamic_update_slice(operand: torch.Tensor, update: torch.Tensor,
                          *starts: Any) -> torch.Tensor:
    # the transpose of a dynamic_slice whose starts are numbers (``x[:,
    # -1]``): ``update`` written into a copy of ``operand`` at the clamped
    # starts
    out = operand.clone()
    view = out
    for d, (start, n) in enumerate(zip(starts, update.shape)):
        view = view.narrow(d, min(max(int(start), 0), operand.shape[d] - n), n)
    view.copy_(update)
    return out


def _squeeze(x: torch.Tensor, *, dimensions: tuple[int, ...]) -> torch.Tensor:
    return torch.squeeze(x, dim=dimensions)


def _broadcast_in_dim(x: Any, *, shape: tuple[int, ...],
                      broadcast_dimensions: tuple[int, ...],
                      dtype: torch.dtype | None = None) -> torch.Tensor:
    """``broadcast_in_dim``, also of a number (``lax.full``: a literal, or
    an equation of literals alone), which lands on the port's device in
    ``dtype``."""
    if not isinstance(x, torch.Tensor):
        return torch.full(shape, x, dtype=dtype, device=get_device(None))
    view = [1] * len(shape)
    for src, dst in enumerate(broadcast_dimensions):
        view[dst] = x.shape[src]
    return x.reshape(view).expand(shape)


def _gather(operand: torch.Tensor, indices: torch.Tensor, *,
            slice_sizes: tuple[int, ...]) -> torch.Tensor:
    # whole rows along axis 0 (the lowering of x[idx]); indices (..., 1)
    # are in range after the wrap, and clamped like the reference's gather
    rows = torch.clamp(indices[..., 0], 0, operand.shape[0] - 1)
    out = torch.index_select(operand, 0, rows.reshape(-1).long())
    return out.reshape(rows.shape + operand.shape[1:])


def _scatter(operand: torch.Tensor, indices: torch.Tensor,
             updates: Any) -> torch.Tensor:
    # one row along axis 0 at a (1,) index, out of place (the lowering of
    # at_set); an index out of range after the wrap is dropped, like the
    # reference's FILL_OR_DROP scatter: the row at the clamped index is
    # written back unchanged, so no value goes to the host
    idx = indices[0]
    keep = (idx >= 0) & (idx < operand.shape[0])
    row = torch.clamp(idx, 0, operand.shape[0] - 1).reshape(1).long()
    new = torch.where(keep, updates, operand.index_select(0, row)[0])
    return torch.index_put(operand, (row,), new.to(operand.dtype)[None])


def at_set(x: torch.Tensor, i: torch.Tensor, v: Any) -> torch.Tensor:
    """``x`` with row ``i`` set to ``v``, out of place: the port's
    ``x.at[i].set(v)``.  A negative ``i`` wraps once; an index still out
    of range drops the write (the reference's ``scatter`` mode
    ``FILL_OR_DROP``; loads clamp instead).  ``i`` is a 0-d integer
    tensor and ``v`` a tensor or a Python scalar.

    Under ``torch.fx`` tracing the call is one node, whatever name the
    caller reached it by (``torch.fx.wrap`` patches only the defining
    module's globals), and the front end lowers it to the jaxpr's five
    equations."""
    if any(isinstance(a, fx.Proxy) for a in (x, i, v)):
        tracer = next(a for a in (x, i, v) if isinstance(a, fx.Proxy)).tracer
        return tracer.create_proxy("call_function", at_set, (x, i, v), {})
    i = torch.as_tensor(i, device=x.device)
    idx = torch.where(i < 0, i + x.shape[0], i)
    return _scatter(x, idx.reshape(1), v)


def _scatter_add_drop(operand: torch.Tensor, indices: torch.Tensor,
                      updates: torch.Tensor) -> torch.Tensor:
    # rows along axis 0 at (N, 1) indices, out of place (the lowering of
    # at_add); an index out of range after the wrap is dropped, like the
    # reference's FILL_OR_DROP scatter-add: it lands in a spare row that
    # is cut off
    n = operand.shape[0]
    rows = indices[..., 0]
    rows = torch.where((rows >= 0) & (rows < n), rows, n).long()
    spare = torch.cat([operand, operand.new_zeros((1, *operand.shape[1:]))])
    return spare.index_add_(0, rows, updates.to(operand.dtype))[:-1]


def at_add(x: torch.Tensor, idx: torch.Tensor, v: torch.Tensor
           ) -> torch.Tensor:
    """``x`` with the rows of ``v`` added at the rows ``idx`` (an (N,)
    integer tensor), out of place: the port's ``x.at[idx].add(v)``.  A
    negative index wraps once; an index still out of range drops its row
    (the reference's ``scatter-add`` mode ``FILL_OR_DROP``).

    Under ``torch.fx`` tracing the call is one node, and the front end
    lowers it to the jaxpr's five equations (the wrap, the (N, 1) index,
    one ``scatter-add``)."""
    if any(isinstance(a, fx.Proxy) for a in (x, idx, v)):
        tracer = next(a for a in (x, idx, v) if isinstance(a, fx.Proxy)).tracer
        return tracer.create_proxy("call_function", at_add, (x, idx, v), {})
    n = x.shape[0]
    idx = torch.where(idx < 0, idx + n, idx)
    return _scatter_add_drop(x, idx[:, None], v)


def scan(f: Callable, init: Sequence[Any], xs: Sequence[Any],
         consts: Sequence[Any] = ()) -> tuple[tuple, tuple | None]:
    """The port's ``jax.lax.scan`` over the leading axis of the tensors
    ``xs``: ``f(consts, carry, x) -> (carry, y)`` with ``carry`` a tuple
    of tensors of ``init``'s shapes and dtypes, ``x`` the tuple of the
    ``xs``' rows, ``y`` a tuple of tensors or ``None``; the tensors the
    body reads from outside come in ``consts``.  Returns ``(carry,
    ys)``, ``ys`` the ``y``\\ s stacked (``None`` without them); over
    ``xs`` of no rows, each ``y`` stacked to length 0, its shape and
    dtype learnt from one call of ``f`` on ``meta`` rows.

    Under ``torch.fx`` tracing the call is one node and ``f`` is traced
    into a sub-graph of its own (its inputs the consts, the carry and one
    row of each ``xs``), lowered to one ``scan`` equation whose body is
    that sub-graph — which a ``grad`` leaf partially evaluates and
    transposes as JAX does (:mod:`repro_torch.core.autodiff`)."""
    init, xs, consts = tuple(init), tuple(xs), tuple(consts)
    if any(isinstance(t, fx.Proxy) for t in (*init, *xs, *consts)):
        return _trace_scan(f, init, xs, consts)
    if xs[0].shape[0] == 0:
        _, y = f(tuple(map(_to_meta, consts)), tuple(map(_to_meta, init)),
                 tuple(torch.empty(x.shape[1:], dtype=x.dtype, device="meta")
                       for x in xs))
        return init, (None if y is None else tuple(
            torch.empty((0, *t.shape), dtype=t.dtype, device=xs[0].device)
            for t in y))
    carry, ys = init, []
    # the rows as views made by one call each (``unbind``), not an index
    # a step: the host's cost of a step is the card's time on a recurrence
    for row in zip(*(x.unbind(0) for x in xs)):
        carry, y = f(consts, carry, row)
        carry = tuple(carry)
        if y is not None:
            ys.append(tuple(y))
    return carry, (tuple(map(torch.stack, zip(*ys))) if ys else None)


def _trace_scan(f: Callable, init: tuple, xs: tuple, consts: tuple
                ) -> tuple[tuple, tuple | None]:
    tracer = next(t for t in (*init, *xs, *consts)
                  if isinstance(t, fx.Proxy)).tracer
    c_ex = [_example_of(t) for t in consts]
    k_ex = [_example_of(t) for t in init]
    x_rows = [_example_of(t)[0] for t in xs]
    n_ys = []

    def body(c_flat, k_flat, x_flat):
        carry, y = f(tuple(c_flat), tuple(k_flat), tuple(x_flat))
        n_ys.append(0 if y is None else len(y))
        return (*carry, *(y or ()))

    gm = _symbolic_trace(body, [*c_ex, *k_ex, *x_rows],
                         {"c_flat": (fx.PH,) * len(consts),
                          "k_flat": (fx.PH,) * len(init),
                          "x_flat": (fx.PH,) * len(xs)})
    outs = _MetaShapeProp(gm).propagate(tuple(c_ex), tuple(k_ex),
                                        tuple(x_rows))
    # a ``y`` that is a number (a dense layer's load balance, 0.0) is a
    # literal output of the body, stacked as fp32
    outs = [torch.as_tensor(o, device="meta") for o in outs]
    length = _example_of(xs[0]).shape[0]
    example = (*map(torch.empty_like, k_ex),
               *(torch.empty((length, *o.shape), dtype=o.dtype,
                             device="meta") for o in outs[len(init):]))
    node = tracer.create_proxy("call_function", _loop_node,
                               (consts, init, xs), {})
    node.node.meta["loop"] = gm
    node.node.meta["example"] = example
    carry = tuple(node[i] for i in range(len(init)))
    ys = tuple(node[len(init) + i] for i in range(n_ys[0]))
    return carry, (ys if n_ys[0] else None)


def checkpoint(f: Callable) -> Callable:
    """The port's ``jax.checkpoint`` of a scan body ``f(consts, carry,
    x) -> (carry, y)`` (:func:`scan`'s): called on tensors, ``f``
    unchanged; traced, one ``remat2`` equation whose body is ``f``'s own
    lowered sub-graph (its inputs the body's constants, then the consts,
    the carry and the row), which a ``grad`` leaf linearizes as JAX's
    ``remat2`` with ``policy=None`` (:mod:`repro_torch.core.autodiff`):
    the forward keeps no residual of its own, the transpose recomputes
    the body."""
    @functools.wraps(f)
    def body(consts: Sequence[Any], carry: Sequence[Any], x: Sequence[Any]
             ) -> tuple:
        parts = (tuple(consts), tuple(carry), tuple(x))
        flat = [t for part in parts for t in part]
        if not any(isinstance(t, fx.Proxy) for t in flat):
            return f(*parts)
        tracer = next(t for t in flat if isinstance(t, fx.Proxy)).tracer
        n_ys = []

        def inner(c_flat, k_flat, x_flat):
            carry, y = f(tuple(c_flat), tuple(k_flat), tuple(x_flat))
            n_ys.append(0 if y is None else len(y))
            return (*carry, *(y or ()))
        ex = [[_example_of(t) for t in part] for part in parts]
        gm = _symbolic_trace(inner, [e for part in ex for e in part],
                             {"c_flat": (fx.PH,) * len(parts[0]),
                              "k_flat": (fx.PH,) * len(parts[1]),
                              "x_flat": (fx.PH,) * len(parts[2])})
        outs = _MetaShapeProp(gm).propagate(*map(tuple, ex))
        node = tracer.create_proxy("call_function", _remat_node, parts, {})
        node.node.meta["remat"] = gm
        node.node.meta["example"] = tuple(torch.as_tensor(o, device="meta")
                                          for o in outs)
        n_k = len(parts[1])
        return (tuple(node[i] for i in range(n_k)),
                tuple(node[n_k + i] for i in range(n_ys[0])) if n_ys[0]
                else None)
    return body


def _remat_node(consts: tuple, carry: tuple, x: tuple) -> tuple:
    """The call target of a traced :func:`checkpoint` (its body's graph
    lives in ``meta``; the lowered equation runs it)."""
    raise RuntimeError("a traced checkpoint runs through its lowered "
                       "equation")


def _run_graph(*args: Any, jaxpr: "Graph | None" = None,
               call_jaxpr: "Graph | None" = None, **_: Any) -> Any:
    """A ``remat2`` or ``closed_call`` equation: its body replayed."""
    from .decouple import _make_stage_fn
    body = jaxpr or call_jaxpr
    out = _make_stage_fn(body.eqns, body.invars, body.outvars)(*args)
    return out[0] if len(out) == 1 else out


def _loop_node(consts: tuple, init: tuple, xs: tuple) -> tuple:
    """The call target of a traced :func:`scan` (its body's graph lives
    in ``meta``; the lowered equation runs it)."""
    raise RuntimeError("a traced scan runs through its lowered equation")


def _run_loop(body: "Graph", n_consts: int, n_carry: int, *args: Any,
              reverse: bool = False) -> tuple:
    """A ``scan`` equation whose body is a lowered graph: ``body``'s
    inputs are the consts, the carry and one row of each scanned input,
    its outputs the new carry and one row of each stacked output."""
    from .decouple import _make_stage_fn
    run = _make_stage_fn(body.eqns, body.invars, body.outvars)
    consts, carry = args[:n_consts], args[n_consts:n_consts + n_carry]
    xs = args[n_consts + n_carry:]
    dev = xs[0].device
    ys = []
    steps = range(xs[0].shape[0])
    for i in (reversed(steps) if reverse else steps):
        out = run(*consts, *carry, *(x[i] for x in xs))
        carry = out[:n_carry]
        ys.append([y if isinstance(y, torch.Tensor) else torch.as_tensor(
            y, dtype=v.aval.dtype, device=dev)
            for y, v in zip(out[n_carry:], body.outvars[n_carry:])])
    if reverse:
        ys.reverse()
    out = (*carry, *map(torch.stack, zip(*ys)))
    return out[0] if len(out) == 1 else out


def _convert_element_type(x: Any, *, new_dtype: torch.dtype
                          ) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):     # an equation of literals
        return torch.tensor(x, dtype=new_dtype, device=get_device(None))
    return x.to(new_dtype)


def _reduce_sum(x: torch.Tensor, *, axes: tuple[int, ...]) -> torch.Tensor:
    return x.sum(dim=axes)


def _slice(x: torch.Tensor, *, start_indices: tuple[int, ...],
           limit_indices: tuple[int, ...], strides: Any) -> torch.Tensor:
    steps = strides or (1,) * x.ndim
    return x[tuple(slice(a, b, c) for a, b, c in
                   zip(start_indices, limit_indices, steps))]


def _var(x: torch.Tensor, correction: int, *, axes: tuple[int, ...]
         ) -> torch.Tensor:
    # the body of the reference's ``jnp.var``, which its jaxpr holds as one
    # opaque ``jit`` equation
    return x.var(dim=axes, correction=correction, keepdim=True)


def _clip(x: torch.Tensor, lo: Any, hi: Any) -> torch.Tensor:
    # ``jnp.clip``: one opaque ``jit`` equation in the reference's jaxpr
    return torch.clamp(x, lo, hi)


def _remainder(x: torch.Tensor, y: Any) -> torch.Tensor:
    # ``jnp.remainder`` (Python's ``%``, the sign of the divisor): one
    # opaque ``jit`` equation in the reference's jaxpr
    return torch.remainder(x, y)


def _concatenate(*xs: torch.Tensor, dimension: int) -> torch.Tensor:
    return torch.cat(xs, dimension)


def _einsum(a: torch.Tensor, b: torch.Tensor, *, equation: str
            ) -> torch.Tensor:
    return torch.einsum(equation, a, b)


def _dot_general(a: torch.Tensor, b: torch.Tensor, *,
                 dimension_numbers: tuple) -> torch.Tensor:
    (ac, bc), (ab, bb) = dimension_numbers
    letters = iter("abcdefghijklmnopqrstuvwxyz")
    la = [next(letters) for _ in range(a.ndim)]
    lb = [next(letters) for _ in range(b.ndim)]
    for i, j in (*zip(ac, bc), *zip(ab, bb)):
        lb[j] = la[i]
    out = ([la[i] for i in ab]
           + [la[i] for i in range(a.ndim) if i not in (*ac, *ab)]
           + [lb[j] for j in range(b.ndim) if j not in (*bc, *bb)])
    return torch.einsum(f"{''.join(la)},{''.join(lb)}->{''.join(out)}",
                        a, b)


def _where(c: Any, x: Any, y: Any) -> torch.Tensor:
    # ``jnp.where``: one opaque ``jit`` equation in the reference's jaxpr
    return torch.where(c, x, y)


def _reshape(x: torch.Tensor, *, new_sizes: tuple[int, ...]) -> torch.Tensor:
    return x.reshape(new_sizes)


def _transpose(x: torch.Tensor, *, permutation: tuple[int, ...]
               ) -> torch.Tensor:
    return x.permute(permutation)


def _split(x: torch.Tensor, *, sizes: tuple[int, ...], axis: int) -> tuple:
    return tuple(x.split(sizes, axis))


def _iota(*, dtype: torch.dtype, shape: tuple[int, ...], dimension: int
          ) -> torch.Tensor:
    return torch.arange(shape[dimension], dtype=dtype,
                        device=get_device(None))


def _reduce_max(x: torch.Tensor, *, axes: tuple[int, ...]) -> torch.Tensor:
    return x.amax(dim=axes)


def _integer_pow(x: torch.Tensor, *, y: int) -> torch.Tensor:
    return x ** y


def _bmm(a: torch.Tensor, b: torch.Tensor, *, dimension_numbers: tuple
         ) -> torch.Tensor:
    return torch.bmm(a, b)


def _cumsum(x: torch.Tensor, *, axis: int) -> torch.Tensor:
    # ``jnp.cumsum``: one opaque ``jit`` equation, in the operand's dtype
    return torch.cumsum(x, axis, dtype=x.dtype)


def _pad_jit(x: torch.Tensor, value: Any, *, pads: tuple[int, ...]
             ) -> torch.Tensor:
    # ``jnp.pad`` with a constant: one opaque ``jit`` equation
    return torch.nn.functional.pad(x, pads, value=float(value))


def _tril(x: torch.Tensor, diagonal: int = 0) -> torch.Tensor:
    # ``jnp.tril``: one ``jit`` equation
    return torch.tril(x, diagonal)


def _silu(x: torch.Tensor, inplace: bool = False) -> torch.Tensor:
    # ``jax.nn.silu``: one opaque ``jit`` equation
    return torch.nn.functional.silu(x)


def _relu(x: torch.Tensor, inplace: bool = False) -> torch.Tensor:
    # ``jax.nn.relu``: one ``jit`` equation (``max(x, 0)``)
    return torch.nn.functional.relu(x)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # ``jax.nn.softplus``: one ``jit`` equation of ``logaddexp(x, 0)``,
    # ``max(x, 0) + log1p(exp(-|x|))`` at every ``x`` (``F.softplus``
    # returns ``x`` itself above its threshold of 20)
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _softmax(x: torch.Tensor, *, dim: int = -1) -> torch.Tensor:
    # ``jax.nn.softmax``: one ``jit`` equation here
    return torch.softmax(x, dim)


def _log_softmax(x: torch.Tensor, *, dim: int = -1) -> torch.Tensor:
    # ``jax.nn.log_softmax``: one opaque ``jit`` equation
    return torch.log_softmax(x, dim)


@contextlib.contextmanager
def leaves(*, index: Sequence[tuple[Any, str]] = (),
           scan: Sequence[tuple[Any, str]] = (),
           grad: Sequence[tuple[Any, str]] = ()) -> Iterator[None]:
    """Inside the block, trace each named module function as one leaf.

    ``index`` names, as ``(module, name)``, functions ``f(x, idx)`` that
    read the rows of ``x`` at the integer ``idx`` as the jaxpr's
    ``x[idx]`` does (a negative index wraps once, then the gather
    clamps); each traces as the one node ``x[idx]``.  ``scan`` names
    functions ``f(carry, consts, state, **static) -> (carry,
    new_state)`` that keep a loop inside (a segment's repeats), where
    ``new_state`` has ``state``'s structure, shapes and dtypes; each
    traces as one node, lowered to one ``scan`` equation — the
    reference's ``jax.lax.scan`` over stacked repeats — whose inputs are
    the carry and the leaves of ``consts`` and ``state`` and whose
    outputs are the new carry and the leaves of the new state.  A
    function with a ``scan_ys(consts, **static)`` attribute returns, in
    place of a new state, per-repeat outputs (the scan's stacked ``ys``)
    of the structure, shapes and dtypes of the ``meta`` tensors that
    ``scan_ys`` gives.

    ``grad`` names functions ``f(params, *args) -> ((value, aux),
    grads)`` — ``jax.value_and_grad(g, has_aux=True)`` of the function
    ``f.value_fn`` = ``g`` — whose ``f.unstacked(params, *args)`` gives
    the tree ``g`` reads, of ``params``' leaves (a segment's stacked
    leaves ``g`` scans over with :func:`scan`, the body traced as a
    sub-graph).
    Each traces as one node, lowered by :mod:`repro_torch.core.autodiff`
    to ``g``'s equations, the residuals its JVP rules keep and the
    transpose of each, in reverse (the jaxpr of ``value_and_grad``); a
    scan's body partially evaluated as JAX does; ``grads`` has
    ``params``' structure, a stacked leaf's gradient stacked.

    Each function is replaced in its module's globals for the block, as
    ``torch.fx.wrap`` does for a trace; called on tensors, it runs
    unchanged."""
    saved = [(m, n, getattr(m, n)) for m, n in (*index, *scan, *grad)]
    try:
        for m, n in index:
            setattr(m, n, _index_leaf(getattr(m, n)))
        for m, n in scan:
            setattr(m, n, _scan_leaf(getattr(m, n)))
        for m, n in grad:
            setattr(m, n, _grad_leaf(getattr(m, n)))
        yield
    finally:
        for m, n, fn in reversed(saved):
            setattr(m, n, fn)


def _index_leaf(fn: Callable) -> Callable:
    @functools.wraps(fn)
    def leaf(x: Any, idx: Any) -> Any:
        if isinstance(x, fx.Proxy) or isinstance(idx, fx.Proxy):
            return x[idx]
        return fn(x, idx)
    return leaf


def _scan_leaf(fn: Callable) -> Callable:
    @functools.wraps(fn)
    def leaf(carry: Any, consts: Any, state: Any, **static: Any
             ) -> tuple[Any, Any]:
        if not isinstance(carry, fx.Proxy):
            return fn(carry, consts, state, **static)
        args = (carry, tuple(tree.leaves(consts)), tuple(tree.leaves(state)))
        second = state
        if hasattr(fn, "scan_ys"):
            second = fn.scan_ys(consts, **static)
            args += (tuple((tuple(t.shape), t.dtype)
                           for t in tree.leaves(second)),)
        out = carry.tracer.create_proxy("call_function", _scan_node, args, {})
        # the body rides on the node's meta, so the lowered equation runs it
        out.node.meta["scan"] = (functools.partial(fn, **static), consts,
                                 state)
        n_out = len(tree.leaves(second))
        return out[0], tree.unflatten(second, [out[1 + i]
                                               for i in range(n_out)])
    return leaf


def _scan_node(carry: Any, consts: tuple, state: tuple,
               ys: tuple | None = None) -> tuple:
    """The call target of a traced ``scan`` leaf (its node's body lives
    in ``meta``; the lowered equation runs it)."""
    raise RuntimeError("a traced scan runs through its lowered equation")


class _Leaf:
    """Leaf ``index`` of a tree, as a ``grad`` leaf's ``unstacked`` hook
    sees it."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index


def _example(proxy: Any) -> torch.Tensor:
    ex = proxy.node.meta.get("example") if isinstance(proxy, fx.Proxy) \
        else None
    if ex is None:
        raise NotImplementedError(
            "a grad leaf's traced arguments must be the trace's inputs")
    return ex


def _grad_leaf(fn: Callable) -> Callable:
    @functools.wraps(fn)
    def leaf(params: Any, *args: Any) -> tuple[Any, Any]:
        p_leaves = tree.leaves(params)
        if not any(isinstance(p, fx.Proxy) for p in p_leaves):
            return fn(params, *args)
        marks = fn.unstacked(tree.unflatten(
            params, [_Leaf(i) for i in range(len(p_leaves))]), *args)
        where = [m.index for m in tree.leaves(marks)]
        dyn = [i for i, a in enumerate(args)
               if any(isinstance(t, fx.Proxy) for t in tree.leaves(a))]
        a_leaves = [t for i in dyn for t in tree.leaves(args[i])]

        def value(p_flat, a_flat):
            full, it = list(args), iter(a_flat)
            for i in dyn:
                full[i] = tree.unflatten(
                    args[i], [next(it) for _ in tree.leaves(args[i])])
            return fn.value_fn(tree.unflatten(marks, list(p_flat)), *full)

        examples = [_example(p_leaves[i]) for i in where]
        examples += [_example(a) for a in a_leaves]
        gm = _symbolic_trace(value, examples,
                             {"p_flat": (fx.PH,) * len(where),
                              "a_flat": (fx.PH,) * len(a_leaves)})
        out_spec = gm.graph._codegen.pytree_info.out_spec
        tracer = next(p for p in p_leaves if isinstance(p, fx.Proxy)).tracer
        out = tracer.create_proxy("call_function", _grad_node,
                                  (tuple(p_leaves), tuple(a_leaves)), {})
        out.node.meta["grad"] = (gm, where)
        n_val = out_spec.num_leaves
        val = pytree.tree_unflatten([out[i] for i in range(n_val)], out_spec)
        return val, tree.unflatten(params, [out[n_val + i]
                                            for i in range(len(p_leaves))])
    return leaf


def _grad_node(p_leaves: tuple, a_leaves: tuple) -> tuple:
    """The call target of a traced ``grad`` leaf (its value function's
    graph lives in ``meta``; the lowering differentiates it)."""
    raise RuntimeError("a traced grad leaf runs through its lowered "
                       "equations")


def _run_scan(body: Callable, consts_like: Any, state_like: Any,
              n_consts: int, carry: Any, *leaves: Any) -> tuple:
    consts = tree.unflatten(consts_like, list(leaves[:n_consts]))
    state = tree.unflatten(state_like, list(leaves[n_consts:]))
    carry, new_state = body(carry, consts, state)
    return (carry, *tree.leaves(new_state))


#: FX node (call_function target, or call_method name) -> primitive name
_BINARY: dict[Any, str] = {
    operator.pow: "pow", torch.pow: "pow", "pow": "pow",
    operator.add: "add", torch.add: "add", "add": "add",
    operator.sub: "sub", torch.sub: "sub", "sub": "sub",
    operator.mul: "mul", torch.mul: "mul", "mul": "mul",
    operator.truediv: "div", torch.div: "div", "div": "div",
    operator.lt: "lt", torch.lt: "lt", "lt": "lt",
    operator.le: "le", torch.le: "le", "le": "le",
    operator.gt: "gt", torch.gt: "gt", "gt": "gt",
    operator.ge: "ge", torch.ge: "ge", "ge": "ge",
    operator.eq: "eq", torch.eq: "eq", "eq": "eq",
    operator.ne: "ne", torch.ne: "ne", "ne": "ne",
    operator.and_: "and", operator.or_: "or", operator.xor: "xor",
    torch.maximum: "max", "maximum": "max",
    torch.minimum: "min", "minimum": "min",
    operator.matmul: "dot_general", torch.matmul: "dot_general",
    "matmul": "dot_general",
}
_UNARY: dict[Any, str] = {
    operator.neg: "neg", torch.neg: "neg", "neg": "neg",
    torch.abs: "abs", "abs": "abs",
    torch.exp: "exp", "exp": "exp", torch.log: "log", "log": "log",
    torch.tanh: "tanh", "tanh": "tanh", torch.sigmoid: "logistic",
    "sigmoid": "logistic", torch.sqrt: "sqrt", "sqrt": "sqrt",
    torch.rsqrt: "rsqrt", "rsqrt": "rsqrt",
    torch.sin: "sin", "sin": "sin", torch.cos: "cos", "cos": "cos",
    torch.square: "square", "square": "square",
}
#: FX node target -> (the body of the reference's jitted function, its
#: operand count, its name, the names of its static arguments), lowered
#: to one ``jit`` equation; the arguments after the operands, and the
#: keywords, are static
_JITTED: dict[Any, tuple[Callable[..., Any], int, str, tuple[str, ...]]] = {
    torch.clamp: (_clip, 3, "clip", ()), "clamp": (_clip, 3, "clip", ()),
    operator.mod: (_remainder, 2, "remainder", ()),
    torch.remainder: (_remainder, 2, "remainder", ()),
    "remainder": (_remainder, 2, "remainder", ()),
    torch.where: (_where, 3, "_where", ()),
    torch.log_softmax: (_log_softmax, 1, "log_softmax", ("dim",)),
    "log_softmax": (_log_softmax, 1, "log_softmax", ("dim",)),
    torch.nn.functional.silu: (_silu, 1, "silu", ("inplace",)),
    torch.nn.functional.relu: (_relu, 1, "relu", ("inplace",)),
    torch.nn.functional.softplus: (_softplus, 1, "softplus", ()),
    torch.softmax: (_softmax, 1, "softmax", ("dim",)),
    torch.tril: (_tril, 1, "tril", ("diagonal",)),
    "softmax": (_softmax, 1, "softmax", ("dim",)),
}
#: FX node target -> the ``_Lowering`` method of a layout op, a factory
#: or another call the jaxpr spells its own way
_LAYOUT: dict[Any, str] = {
    "reshape": "lower_reshape", "view": "lower_reshape",
    torch.reshape: "lower_reshape",
    "permute": "lower_transpose", torch.permute: "lower_transpose",
    "transpose": "lower_transpose", torch.transpose: "lower_transpose",
    "split": "lower_split", torch.split: "lower_split",
    "chunk": "lower_split", torch.chunk: "lower_split",
    "expand": "lower_expand", "repeat_interleave": "lower_repeat",
    torch.arange: "lower_arange", torch.full: "lower_full",
    torch.zeros: "lower_full", torch.zeros_like: "lower_full",
    torch.ones: "lower_full",
    "clamp_min": "lower_clamp_min", torch.clamp_min: "lower_clamp_min",
    "amax": "lower_amax", torch.amax: "lower_amax",
    "cumsum": "lower_cumsum", torch.cumsum: "lower_cumsum",
    torch.bmm: "lower_bmm", torch.nn.functional.pad: "lower_pad",
    "masked_fill": "lower_masked_fill",
    torch.nn.functional.gelu: "lower_gelu",
    "detach": "lower_detach", "contiguous": "lower_contiguous",
}
#: primitive name -> implementation on tensors (and Python scalars)
_IMPL: dict[str, Callable[..., Any]] = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "div": operator.truediv, "lt": operator.lt, "le": operator.le,
    "gt": operator.gt, "ge": operator.ge, "eq": operator.eq,
    "ne": operator.ne, "and": operator.and_, "or": operator.or_,
    "xor": operator.xor, "max": _extremum(torch.maximum, builtins.max),
    "min": _extremum(torch.minimum, builtins.min),
    "dot_general": torch.matmul, "neg": operator.neg, "abs": torch.abs,
    "exp": torch.exp, "log": torch.log, "tanh": torch.tanh,
    "logistic": torch.sigmoid, "sqrt": torch.sqrt, "rsqrt": torch.rsqrt,
    "sin": torch.sin, "cos": torch.cos, "pow": operator.pow,
    "square": torch.square, "stop_gradient": torch.Tensor.detach,
    "select_n": _select_n, "dynamic_slice": _dynamic_slice,
    "dynamic_update_slice": _dynamic_update_slice,
    "squeeze": _squeeze, "broadcast_in_dim": _broadcast_in_dim,
    "gather": _gather, "scatter": _scatter,
    "convert_element_type": _convert_element_type, "reduce_sum": _reduce_sum,
    "slice": _slice,
}


class _Lowering:
    """Walks an FX graph and emits :class:`Eqn` records."""

    def __init__(self, gm: fx.GraphModule | None,
                 device: torch.device | None = None):
        self.gm = gm
        #: where the constants the lowering makes live (the examples')
        self.device = device
        self.env: dict[fx.Node, Any] = {}
        self.eqns: list[Eqn] = []
        self.invars: list[Var] = []
        self.constvars: list[Var] = []
        self.consts: list[torch.Tensor] = []
        #: get_attr target -> its constvar: fx emits one get_attr node per
        #: use of a closed-over tensor, the jaxpr one constvar per tensor
        self.const_of: dict[str, Var] = {}
        #: the output structure (a pytree spec over the flat outvars)
        self.out_tree: Any = None

    def emit(self, prim: str, invars: list[Any], aval: Aval, source: str,
             impl: Callable[..., Any] | None = None, name: str = "",
             **params: Any) -> Var:
        return self.emit_multi(prim, invars, [aval], source, impl, name,
                               **params)[0]

    def emit_multi(self, prim: str, invars: list[Any], avals: list[Aval],
                   source: str, impl: Callable[..., Any] | None = None,
                   name: str = "", **params: Any) -> list[Var]:
        """One equation of ``len(avals)`` outputs (its ``impl`` returns
        a tuple when there are several)."""
        k = len(self.eqns)
        outs = [Var(a, f"{source}.{k}" + (f".{i}" if len(avals) > 1
                                           else ""))
                for i, a in enumerate(avals)]
        self.eqns.append(Eqn(prim, invars, outs, params,
                             impl or _IMPL[prim], source, name))
        return outs

    def read(self, arg: Any, like: Aval | None = None) -> Any:
        if isinstance(arg, fx.Node):
            return self.env[arg]
        if isinstance(arg, (bool, int, float)):
            dtype = like.dtype if like is not None else torch.float32
            return Literal(arg, Aval((), dtype))
        raise NotImplementedError(
            f"operand {arg!r} is not lowered by the port's front end yet")

    def run(self) -> Graph:
        for node in self.gm.graph.nodes:
            if node.op == "placeholder":
                v = Var(_aval_of(node), node.name)
                self.invars.append(v)
                self.env[node] = v
            elif node.op == "get_attr":
                v = self.const_of.get(node.target)
                if v is None:
                    v = Var(_aval_of(node), node.name)
                    self.constvars.append(v)
                    self.consts.append(
                        operator.attrgetter(node.target)(self.gm))
                    self.const_of[node.target] = v
                self.env[node] = v
            elif node.op in ("call_function", "call_method"):
                self.env[node] = self.lower(node)
            elif node.op == "output":
                info = getattr(self.gm.graph._codegen, "pytree_info", None)
                if info is not None:   # traced with tuple arguments
                    flat, self.out_tree = list(node.args[0]), info.out_spec
                else:
                    flat, self.out_tree = pytree.tree_flatten(node.args[0])
                outvars = [self.read(o) for o in flat]
            else:
                raise NotImplementedError(
                    f"FX node {node.op} {node.target!r} is not lowered by "
                    f"the port's front end yet")
        return Graph(self.eqns, self.invars, outvars, self.constvars,
                     self.consts, str(self.gm.graph))

    def lower(self, node: fx.Node) -> Any:
        target = node.target
        if target in (operator.getitem, "__getitem__"):
            return self.lower_getitem(node)
        if target is at_set:
            return self.lower_at_set(node)
        if target is at_add:
            return self.lower_at_add(node)
        if target is _scan_node:
            return self.lower_scan(node)
        if target is _loop_node:
            return self.lower_loop(node)
        if target is _remat_node:
            return self.lower_remat(node)
        if hasattr(target, "primitive"):
            return self.lower_primitive(node)
        lowering = _LAYOUT.get(target)
        if lowering is not None:
            return getattr(self, lowering)(node)
        if target is _grad_node:
            from .autodiff import lower_value_and_grad
            return lower_value_and_grad(self, node)
        if target is builtins.getattr:
            return self.lower_getattr(node)
        if target in ("float", "to"):
            return self.lower_convert(node)
        if target in ("mean", "var", "sum"):
            return self.lower_reduction(node)
        if target is torch.einsum:
            return self.lower_einsum(node)
        if target is torch.cat:
            return self.lower_cat(node)
        if target in _JITTED or hasattr(target, "jit_name"):
            return self.lower_jitted(node)
        if target == "new_tensor":
            return self.lower_new_tensor(node)
        if node.kwargs:
            raise NotImplementedError(
                f"keyword arguments on {target!r} are not lowered yet")
        aval = _aval_of(node)
        if target in _BINARY and len(node.args) == 2:
            a, b = node.args
            like = self.env[a].aval if isinstance(a, fx.Node) \
                else self.env[b].aval
            prim = _BINARY[target]
            ops = [self.read(a, like), self.read(b, like)]
            if prim == "pow" and isinstance(b, int) and not isinstance(
                    b, bool):        # ``x ** 2``: jnp's ``integer_pow``
                return self.emit("integer_pow", [ops[0]], aval, node.name,
                                 impl=_integer_pow, y=b)
            if prim != "dot_general":
                ops = self.promote_ranks(self.promote_dtypes(
                    self.promote_weak(ops, node.name), node.name), node.name)
            if all(isinstance(o, Literal) or o.aval.weak for o in ops):
                aval = dataclasses.replace(aval, weak=True)
            return self.emit(prim, ops, aval, node.name)
        if target in _UNARY and len(node.args) == 1:
            return self.emit(_UNARY[target], [self.read(node.args[0])],
                             aval, node.name)
        raise NotImplementedError(
            f"FX node {node.op} {target!r} is not lowered by the port's "
            f"front end yet")

    def promote_weak(self, ops: list[Any], source: str) -> list[Any]:
        """A weakly typed value met by a typed one is converted to the
        typed one's dtype first, as ``jnp``'s promotion does (a literal
        operand just takes it)."""
        typed = [o for o in ops if isinstance(o, Var) and not o.aval.weak]
        if not typed:
            return ops
        dt = typed[0].aval.dtype
        return [self.emit("convert_element_type", [o],
                          Aval(o.aval.shape, dt), source, new_dtype=dt)
                if isinstance(o, Var) and o.aval.weak else o for o in ops]

    def promote_dtypes(self, ops: list[Any], source: str) -> list[Any]:
        """Two typed operands of different dtypes: the one whose dtype is
        not their promoted dtype is converted to it first (``bool`` times
        ``float32``, ``bfloat16`` times ``float32``), as ``jnp``'s
        promotion does."""
        typed = [o.aval.dtype for o in ops if isinstance(o, Var)]
        if len(set(typed)) < 2:
            return ops
        dt = functools.reduce(torch.promote_types, typed)
        return [self.emit("convert_element_type", [o],
                          Aval(o.aval.shape, dt), source, new_dtype=dt)
                if isinstance(o, Var) and o.aval.dtype != dt else o
                for o in ops]

    def promote_ranks(self, ops: list[Any], source: str) -> list[Any]:
        """numpy rank promotion as the jaxpr spells it: of two operands
        of rank ≥ 1, the lower-rank one is first broadcast (leading unit
        axes) by a ``broadcast_in_dim``; a scalar operand is not."""
        ranks = [len(o.aval.shape) if isinstance(o, Var) else 0
                 for o in ops]
        if min(ranks) == 0 or ranks[0] == ranks[1]:
            return ops
        r = max(ranks)
        out = []
        for o, k in zip(ops, ranks):
            if k < r:
                shape = (1,) * (r - k) + o.aval.shape
                o = self.emit("broadcast_in_dim", [o],
                              Aval(shape, o.aval.dtype), source,
                              shape=shape,
                              broadcast_dimensions=tuple(range(r - k, r)))
            out.append(o)
        return out

    def lower_getitem(self, node: fx.Node) -> Any:
        """``x[j]`` with a 0-d or N-d integer tensor → the jaxpr's five
        equations: wrap negative indices, then slice one row and drop the
        axis (0-d), or gather whole rows at an (..., 1) index (N-d).  A
        static index (ints, slices, ``None``) → ``slice`` / ``squeeze`` /
        ``broadcast_in_dim``; an int into a node's tuple of outputs picks
        one."""
        arr_n, idx_n = node.args
        arr = self.env[arr_n]
        if isinstance(arr, tuple):
            return arr[idx_n]
        if not isinstance(idx_n, fx.Node):
            return self.lower_static_index(node, arr, idx_n)
        idx = self.read(idx_n)
        if not (isinstance(idx, Var)
                and not idx.aval.dtype.is_floating_point
                and idx.aval.dtype != torch.bool):
            raise NotImplementedError(
                f"indexing {arr_n.name}[{idx_n!r}]: only an integer tensor "
                f"index is lowered yet")
        it, src, ishape = idx.aval.dtype, node.name, idx.aval.shape
        scalar = Aval((), it)
        neg = self.emit("lt", [idx, Literal(0, scalar)],
                        Aval(ishape, torch.bool), src)
        wrapped = self.emit("add", [idx, Literal(arr.aval.shape[0], scalar)],
                            Aval(ishape, it), src)
        sel = self.emit("select_n", [neg, idx, wrapped], Aval(ishape, it),
                        src)
        sizes = (1,) + tuple(arr.aval.shape[1:])
        if ishape:
            col = self.emit("broadcast_in_dim", [sel],
                            Aval(ishape + (1,), it), src,
                            shape=ishape + (1,),
                            broadcast_dimensions=tuple(range(len(ishape))))
            return self.emit("gather", [arr, col],
                             Aval(ishape + sizes[1:], arr.aval.dtype), src,
                             slice_sizes=sizes)
        zeros = [Literal(0, scalar)] * (len(sizes) - 1)
        row = self.emit("dynamic_slice", [arr, sel, *zeros],
                        Aval(sizes, arr.aval.dtype), src, slice_sizes=sizes)
        return self.emit("squeeze", [row], Aval(sizes[1:], arr.aval.dtype),
                         src, dimensions=(0,))

    def lower_static_index(self, node: fx.Node, arr: Var, index: Any
                           ) -> Var:
        """``x[:, 0]`` → ``slice`` then ``squeeze`` of the int axes;
        ``x[:, None]`` → ``broadcast_in_dim`` — the equations of a static
        basic index in the jaxpr."""
        index = index if isinstance(index, tuple) else (index,)
        shape, dt, src = arr.aval.shape, arr.aval.dtype, node.name
        if Ellipsis in index:
            k = index.index(Ellipsis)
            fill = len(shape) - sum(i is not None for i in index
                                    if i is not Ellipsis)
            index = index[:k] + (slice(None),) * fill + index[k + 1:]
        axes = [i for i in index if i is not None]
        if len(axes) > len(shape) or not all(
                isinstance(i, (int, slice)) for i in axes):
            raise NotImplementedError(
                f"indexing with {index!r} is not lowered yet")
        axes += [slice(None)] * (len(shape) - len(axes))
        if None not in index and any(isinstance(i, int) and i < 0
                                     for i in axes):
            return self.lower_negative_index(node, arr, axes)
        bounds, dropped = [], []
        for d, (i, n) in enumerate(zip(axes, shape)):
            if isinstance(i, int):
                k = i + n if i < 0 else i
                bounds.append((k, k + 1, 1))
                dropped.append(d)
            else:
                bounds.append(i.indices(n))
        out = arr
        if dropped or any(b != (0, n, 1) for b, n in zip(bounds, shape)):
            sizes = tuple(len(range(*b)) for b in bounds)
            steps = tuple(b[2] for b in bounds)
            out = self.emit("slice", [out], Aval(sizes, dt), src,
                            start_indices=tuple(b[0] for b in bounds),
                            limit_indices=tuple(b[1] for b in bounds),
                            strides=None if set(steps) == {1} else steps)
        if dropped:
            kept = tuple(n for d, n in enumerate(out.aval.shape)
                         if d not in dropped)
            out = self.emit("squeeze", [out], Aval(kept, dt), src,
                            dimensions=tuple(dropped))
        if any(i is None for i in index):
            final = tuple(_aval_of(node).shape)
            pos, k = [], 0
            for i in index:
                if i is None:
                    k += 1
                elif not isinstance(i, int):
                    pos.append(k)
                    k += 1
            pos += range(k, len(final))
            out = self.emit("broadcast_in_dim", [out], Aval(final, dt), src,
                            shape=final, broadcast_dimensions=tuple(pos))
        return out

    def lower_negative_index(self, node: fx.Node, arr: Var, axes: list
                             ) -> Var:
        """A static basic index with a negative int (``hs[:, -1]``) → the
        jaxpr's ``dynamic_slice`` of it: each negative start wrapped by
        ``lt, add, select_n`` of literals, the slices' starts literal,
        then ``dynamic_slice`` and ``squeeze`` of the int axes."""
        shape, dt, src = arr.aval.shape, arr.aval.dtype, node.name
        it = Aval((), torch.int32)
        starts, sizes, dropped = [], [], []
        for d, (i, n) in enumerate(zip(axes, shape)):
            if isinstance(i, slice):
                lo, hi, step = i.indices(n)
                if step != 1:
                    raise NotImplementedError(
                        f"indexing with a step and a negative int is not "
                        f"lowered yet")
                starts.append(Literal(lo, it))
                sizes.append(max(0, hi - lo))
                continue
            if i >= 0:
                starts.append(Literal(i, it))
            else:
                neg = self.emit("lt", [Literal(i, it), Literal(0, it)],
                                Aval((), torch.bool), src)
                wrapped = self.emit("add", [Literal(i, it), Literal(n, it)],
                                    it, src)
                starts.append(self.emit("select_n", [neg, Literal(i, it),
                                                     wrapped], it, src))
            sizes.append(1)
            dropped.append(d)
        row = self.emit("dynamic_slice", [arr, *starts],
                        Aval(tuple(sizes), dt), src, slice_sizes=tuple(sizes))
        return self.emit("squeeze", [row], Aval(tuple(
            n for d, n in enumerate(sizes) if d not in dropped), dt), src,
            dimensions=tuple(dropped))

    def lower_scan(self, node: fx.Node) -> tuple[Var, ...]:
        """A traced ``scan`` leaf → one ``scan`` equation: inputs the
        carry and the leaves of ``consts`` and ``state``, outputs the new
        carry and the leaves of the new state."""
        carry_n, const_ns, state_ns = node.args[:3]
        invars = [self.read(a) for a in (carry_n, *const_ns, *state_ns)]
        body, consts_like, state_like = node.meta["scan"]
        impl = functools.partial(_run_scan, body, consts_like, state_like,
                                 len(const_ns))
        return tuple(self.emit_multi(
            "scan", invars, [Aval(tuple(m.shape), m.dtype)
                             for m in node.meta["tensor_meta"]],
            node.name, impl))

    def lower_getattr(self, node: fx.Node) -> Any:
        """``x.dtype``: static, no equation; ``x.device`` (a factory's
        keyword: the lowered program places what it makes on the port's
        device): nothing."""
        x, name = node.args
        if name == "device":
            return None
        if name != "dtype":
            raise NotImplementedError(f"attribute {name!r} is not lowered "
                                      f"yet")
        return self.env[x].aval.dtype

    def const(self, value: torch.Tensor, name: str) -> Var:
        """A new constant of the program (``constvars``/``consts``)."""
        v = Var(Aval(tuple(value.shape), value.dtype), name)
        self.constvars.append(v)
        self.consts.append(value)
        return v

    def lower_reshape(self, node: fx.Node) -> Var:
        """``x.reshape(...)`` / ``x.view(...)`` → ``reshape``; nothing
        when the shape stays, as ``lax.reshape`` then returns its
        operand."""
        x, aval = self.env[node.args[0]], _aval_of(node)
        if aval.shape == x.aval.shape:
            return x
        return self.emit("reshape", [x], aval, node.name, impl=_reshape,
                         new_sizes=aval.shape)

    def lower_transpose(self, node: fx.Node) -> Var:
        """``x.permute(dims)`` / ``x.transpose(a, b)`` → ``transpose``."""
        x = self.env[node.args[0]]
        n = len(x.aval.shape)
        dims = [*node.args[1:], *node.kwargs.values()]
        if node.target in ("transpose", torch.transpose):
            perm = list(range(n))
            a, b = (d % n for d in dims)
            perm[a], perm[b] = perm[b], perm[a]
        else:
            if len(dims) == 1 and isinstance(dims[0], (tuple, list)):
                dims = dims[0]
            perm = [d % n for d in dims]
        return self.emit("transpose", [x], _aval_of(node), node.name,
                         impl=_transpose, permutation=tuple(perm))

    def lower_split(self, node: fx.Node) -> tuple[Var, ...]:
        """``x.split(sizes, dim)`` / ``x.chunk(n, dim)`` → one ``split``
        of the pieces' sizes (``jnp.split``)."""
        x = self.env[node.args[0]]
        dim = (*node.args[2:], *node.kwargs.values(), 0)[0]
        dim %= len(x.aval.shape)
        avals = [Aval(tuple(m.shape), m.dtype)
                 for m in node.meta["tensor_meta"]]
        sizes = tuple(a.shape[dim] for a in avals)
        return tuple(self.emit_multi("split", [x], avals, node.name,
                                     impl=_split, sizes=sizes, axis=dim))

    def lower_expand(self, node: fx.Node) -> Var:
        """``x.expand(*shape)`` → ``broadcast_in_dim`` onto the trailing
        axes (``jnp.broadcast_to``); nothing when the shape stays."""
        x, aval = self.env[node.args[0]], _aval_of(node)
        if aval.shape == x.aval.shape:
            return x
        lead = len(aval.shape) - len(x.aval.shape)
        return self.emit("broadcast_in_dim", [x], aval, node.name,
                         shape=aval.shape, broadcast_dimensions=tuple(
                             range(lead, len(aval.shape))))

    def lower_repeat(self, node: fx.Node) -> Var:
        """``x.repeat_interleave(r, dim)`` with an int ``r`` → ``jnp.repeat``'s
        ``broadcast_in_dim`` (a new axis of ``r`` after ``dim``) and
        ``reshape``."""
        x = self.env[node.args[0]]
        params = dict(zip(("repeats", "dim"), node.args[1:]), **node.kwargs)
        r, shape = params["repeats"], x.aval.shape
        if not isinstance(r, int) or params.get("dim") is None:
            raise NotImplementedError("repeat_interleave of other than an "
                                      "int along one dim")
        dim = params["dim"] % len(shape)
        wide = shape[:dim + 1] + (r,) + shape[dim + 1:]
        b = self.emit("broadcast_in_dim", [x], Aval(wide, x.aval.dtype),
                      node.name, shape=wide, broadcast_dimensions=tuple(
                          d if d <= dim else d + 1 for d in range(len(shape))))
        return self.emit("reshape", [b], _aval_of(node), node.name,
                         impl=_reshape, new_sizes=_aval_of(node).shape)

    def lower_arange(self, node: fx.Node) -> Var:
        """``torch.arange(n)`` → ``iota`` (``jnp.arange(n)``);
        ``torch.arange(start, stop, step)`` → a constant, as
        ``jnp.arange`` of several numbers is one."""
        aval = _aval_of(node)
        if len(node.args) == 1:
            return self.emit("iota", [], aval, node.name, impl=_iota,
                             dtype=aval.dtype, shape=aval.shape,
                             dimension=0)
        return self.const(torch.arange(*node.args, dtype=aval.dtype,
                                       device=self.device
                                       or get_device(None)), node.name)

    def lower_full(self, node: fx.Node) -> Var:
        """``torch.full(shape, c)`` / ``torch.zeros(shape)`` /
        ``torch.zeros_like(x)`` / ``torch.ones(shape)`` →
        ``broadcast_in_dim`` of the literal (``jnp.full``, ``jnp.zeros``,
        ``jnp.zeros_like``, ``jnp.ones``)."""
        aval = _aval_of(node)
        c = (node.args[1] if node.target is torch.full
             else int(node.target is torch.ones))
        if aval.dtype == torch.bool:
            c = bool(c)
        return self.emit("broadcast_in_dim", [Literal(c, Aval((),
                                                             aval.dtype))],
                         aval, node.name,
                         impl=functools.partial(_broadcast_in_dim,
                                                dtype=aval.dtype),
                         shape=aval.shape, broadcast_dimensions=())

    def lower_clamp_min(self, node: fx.Node) -> Var:
        """``x.clamp_min(c)`` → ``max`` of ``x`` and the literal
        (``jnp.maximum(x, c)``)."""
        x, c = (*node.args, *node.kwargs.values())[:2]
        x = self.env[x]
        return self.emit("max", [x, self.read(c, x.aval)], _aval_of(node),
                         node.name)

    def lower_amax(self, node: fx.Node) -> Var:
        """``x.amax(dim)`` → ``reduce_max`` (``x.max(axis)``)."""
        x = self.env[node.args[0]]
        params = dict(zip(("dim", "keepdim"), node.args[1:]), **node.kwargs)
        dim = params["dim"]
        axes = tuple(sorted(d % len(x.aval.shape) for d in (
            (dim,) if isinstance(dim, int) else dim)))
        if params.get("keepdim"):
            raise NotImplementedError("amax with keepdim=True")
        return self.emit("reduce_max", [x], _aval_of(node), node.name,
                         impl=_reduce_max, axes=axes)

    def lower_cumsum(self, node: fx.Node) -> Var:
        """``x.cumsum(dim)`` (in ``x``'s dtype) → one ``jit`` equation, as
        ``jnp.cumsum`` is a jitted function."""
        x, aval = self.env[node.args[0]], _aval_of(node)
        dim = (*node.args[1:], node.kwargs.get("dim"))[0]
        if aval.dtype != x.aval.dtype:
            raise NotImplementedError("cumsum into another dtype")
        return self.emit("jit", [x], aval, node.name,
                         impl=functools.partial(
                             _cumsum, axis=dim % len(aval.shape)),
                         name="cumsum")

    def lower_bmm(self, node: fx.Node) -> Var:
        """``torch.bmm(a, b)`` → ``dot_general`` over the leading batch
        axis (``jnp.einsum("ecd,edf->ecf")``)."""
        a, b = (self.read(n) for n in node.args)
        return self.emit("dot_general", [a, b], _aval_of(node), node.name,
                         impl=_bmm,
                         dimension_numbers=(((2,), (1,)), ((0,), (0,))))

    def lower_pad(self, node: fx.Node) -> Var:
        """``F.pad(x, pads)`` with a constant value → one ``jit``
        equation (``jnp.pad``), its operands ``x`` and the value."""
        x = self.env[node.args[0]]
        pads = tuple(node.args[1])
        value = node.kwargs.get("value") or 0
        if node.kwargs.get("mode", "constant") != "constant":
            raise NotImplementedError("F.pad of other than a constant")
        return self.emit("jit", [x, Literal(value, Aval((), torch.int32))],
                         _aval_of(node), node.name,
                         impl=functools.partial(_pad_jit, pads=pads),
                         name="_pad")

    def lower_detach(self, node: fx.Node) -> Var:
        """``x.detach()`` → ``stop_gradient`` (``lax.stop_gradient``)."""
        x = self.env[node.args[0]]
        return self.emit("stop_gradient", [x], x.aval, node.name)

    def lower_contiguous(self, node: fx.Node) -> Var:
        """``x.contiguous()`` → no equation: a jaxpr has no memory
        layout."""
        return self.env[node.args[0]]

    def lower_gelu(self, node: fx.Node) -> Var:
        """``F.gelu(x, approximate="tanh")`` → the equations of
        ``jax.nn.gelu(x)`` (its default, the tanh approximation):
        ``x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x**3))))``."""
        if node.kwargs.get("approximate") != "tanh" or len(node.args) != 1:
            raise NotImplementedError("F.gelu other than approximate='tanh'")
        x = self.env[node.args[0]]
        a, src = x.aval, node.name

        def lit(c):
            return Literal(c, Aval((), a.dtype))
        cube = self.emit("integer_pow", [x], a, src, impl=_integer_pow, y=3)
        t = self.emit("mul", [lit(0.044715), cube], a, src)
        t = self.emit("add", [x, t], a, src)
        t = self.emit("mul", [lit(math.sqrt(2 / math.pi)), t], a, src)
        t = self.emit("tanh", [t], a, src)
        t = self.emit("add", [lit(1.0), t], a, src)
        t = self.emit("mul", [lit(0.5), t], a, src)
        return self.emit("mul", [x, t], a, src)

    def lower_primitive(self, node: fx.Node) -> Any:
        """A function marked with the ``primitive`` it stands for (a
        leaf wrapped by ``torch.fx.wrap``) → one equation of it: the tensor
        arguments are its operands, the others its parameters."""
        fn = node.target
        bound = inspect.signature(fn).bind(*node.args, **node.kwargs)
        ops, static = [], {}
        for name, a in bound.arguments.items():
            if isinstance(a, fx.Node):
                ops.append(self.read(a))
            else:
                static[name] = a
        meta = node.meta["tensor_meta"]
        many = isinstance(meta, (tuple, list))
        avals = [Aval(tuple(m.shape), m.dtype)
                 for m in (meta if many else [meta])]
        outs = self.emit_multi(fn.primitive, ops, avals, node.name, impl=fn,
                               **static)
        return tuple(outs) if many else outs[0]

    def lower_convert(self, node: fx.Node) -> Var:
        """``x.float()``, ``x.to(dtype)`` → ``convert_element_type``;
        nothing when the dtype does not change, as ``astype`` to the
        same dtype traces to no equation."""
        x = self.env[node.args[0]]
        if node.target == "float":
            dtype = torch.float32
        else:
            args = [self.env[a] if isinstance(a, fx.Node) else a
                    for a in (*node.args[1:], *node.kwargs.values())]
            dtypes = [a for a in args if isinstance(a, torch.dtype)]
            if len(dtypes) != 1:
                raise NotImplementedError(
                    f"{node.target}{tuple(node.args[1:])}: only a dtype "
                    f"conversion is lowered yet")
            dtype = dtypes[0]
        if dtype == x.aval.dtype:
            return x
        return self.emit("convert_element_type", [x],
                         Aval(x.aval.shape, dtype), node.name,
                         new_dtype=dtype)

    def lower_reduction(self, node: fx.Node) -> Var:
        """``x.mean(dim, keepdim)`` → ``reduce_sum``, a
        ``broadcast_in_dim`` back to the kept axes, ``div`` by the count
        (``jnp.mean``); ``x.sum(dim, keepdim)`` the same without the
        ``div`` (no ``dim``: every axis); ``x.var(dim, keepdim=True,
        unbiased=False)`` → one ``jit`` equation, as ``jnp.var`` is a
        jitted function."""
        params = dict(zip(("dim", "keepdim"), node.args[1:]), **node.kwargs)
        x = self.env[node.args[0]]
        shape, dt, src = x.aval.shape, x.aval.dtype, node.name
        if params.pop("dtype", dt) != dt:
            raise NotImplementedError("a reduction into another dtype")
        dim = params.get("dim")
        dims = (range(len(shape)) if dim is None
                else (dim,) if isinstance(dim, int) else dim)
        axes = tuple(sorted(d % len(shape) for d in dims))
        keep = tuple(1 if d in axes else n for d, n in enumerate(shape))
        if node.target == "var":
            correction = params.get("correction",
                                    int(params.get("unbiased", True)))
            if not params.get("keepdim"):
                raise NotImplementedError("var without keepdim=True")
            return self.emit("jit", [x, Literal(correction,
                                                Aval((), torch.int32))],
                             Aval(keep, dt), src,
                             impl=functools.partial(_var, axes=axes),
                             name="_var")
        reduced = tuple(n for d, n in enumerate(shape) if d not in axes)
        out = self.emit("reduce_sum", [x], Aval(reduced, dt), src,
                        axes=axes)
        if params.get("keepdim"):
            out = self.emit("broadcast_in_dim", [out], Aval(keep, dt), src,
                            shape=keep,
                            broadcast_dimensions=tuple(
                                d for d in range(len(shape))
                                if d not in axes))
        if node.target == "sum":
            return out
        count = 1
        for d in axes:
            count *= shape[d]
        return self.emit("div", [out, Literal(float(count), Aval((), dt))],
                         out.aval, src)

    def lower_einsum(self, node: fx.Node) -> Var:
        """A two-operand ``torch.einsum`` → ``dot_general``, as
        ``jnp.einsum`` spells it: the batch axes in the output's order,
        then the first operand's free axes, then the second's — or, when
        that is not the output's order, ``dot_general`` of the second
        operand and the first, then a ``transpose`` to the output (an
        axis summed in one operand alone: one ``dot_general`` of the
        einsum)."""
        equation, *operands = node.args
        if len(operands) != 2:
            raise NotImplementedError("einsum of other than two operands")
        a, b = (self.read(o) for o in operands)
        eq = equation.replace(" ", "")
        lhs, rest = eq.split(",")
        rhs, out = rest.split("->")
        batch = [c for c in out if c in lhs and c in rhs]

        def free(x, y):
            return [c for c in x if c not in y]
        lone = any(c not in out for c in (*free(lhs, rhs), *free(rhs, lhs)))
        if "..." in eq or lone or (
                batch == [c for c in lhs if c in rhs and c in out]
                and batch + free(lhs, rhs) + free(rhs, lhs) == list(out)):
            return self.emit("dot_general", [a, b], _aval_of(node), node.name,
                             impl=functools.partial(_einsum,
                                                    equation=equation))
        contract = sorted(c for c in lhs if c in rhs and c not in out)
        for (x, xs), (y, ys) in (((a, lhs), (b, rhs)), ((b, rhs), (a, lhs))):
            names = batch + free(xs, ys) + free(ys, xs)
            dims = (([xs.index(c) for c in contract],
                     [ys.index(c) for c in contract]),
                    ([xs.index(c) for c in batch],
                     [ys.index(c) for c in batch]))
            if names == list(out) or x is b:
                break
        dims = tuple(tuple(map(tuple, d)) for d in dims)
        shape = dict(zip(lhs, a.aval.shape)) | dict(zip(rhs, b.aval.shape))
        aval = _aval_of(node)
        prod = self.emit("dot_general", [x, y], Aval(tuple(
            shape[c] for c in names), aval.dtype), node.name,
            impl=_dot_general, dimension_numbers=dims)
        if names == list(out):
            return prod
        return self.emit("transpose", [prod], aval, node.name,
                         impl=_transpose, permutation=tuple(
                             names.index(c) for c in out))

    def lower_cat(self, node: fx.Node) -> Var:
        """``torch.cat(xs, dim)`` → one ``concatenate`` equation."""
        xs, dim = (*node.args, *node.kwargs.values(), 0)[:2]
        aval = _aval_of(node)
        dim %= len(aval.shape)
        return self.emit("concatenate", [self.read(x) for x in xs], aval,
                         node.name, impl=functools.partial(_concatenate,
                                                           dimension=dim),
                         dimension=dim)

    def lower_jitted(self, node: fx.Node) -> Var:
        """``torch.clamp(x, lo, hi)``, ``x % y``, ``torch.where(c, x,
        y)``, ``torch.log_softmax(x, dim)`` and a function marked with a
        ``jit_name`` (all its arguments operands) → one ``jit``
        equation each, as ``jnp.clip``, ``jnp.remainder``,
        ``jnp.where``, ``jax.nn.log_softmax`` and the reference's other
        jitted functions are; Python-scalar operands stay literals, the
        arguments after the operands are static."""
        target = node.target
        if target in _JITTED:
            impl, arity, name, statics = _JITTED[target]
        else:       # the arguments past ``jit_arity`` are static
            arity = getattr(target, "jit_arity", len(node.args))
            impl, name = target, target.jit_name
            statics = tuple(inspect.signature(target).parameters)[arity:]
        static = dict(zip(statics, node.args[arity:]), **node.kwargs)
        if len(node.args) < arity or set(static) - set(statics):
            raise NotImplementedError(
                f"{target!r} with {len(node.args)} operands, "
                f"{sorted(node.kwargs)} keywords")
        aval = _aval_of(node)
        x = node.args[0]
        like = self.env[x].aval if isinstance(x, fx.Node) else aval
        if target is torch.where:       # the branches' dtype, not bool
            like = aval
        ops = [self.read(a, like) for a in node.args[:arity]]
        if static:
            impl = functools.partial(impl, **static)
        return self.emit("jit", ops, aval, node.name, impl=impl, name=name)

    def lower_masked_fill(self, node: fx.Node) -> Var:
        """``x.masked_fill(mask, c)`` → one ``jit`` equation of
        ``jnp.where(mask, c, x)``."""
        x_n, mask_n, c = (*node.args, *node.kwargs.values())[:3]
        x = self.env[x_n]
        return self.emit("jit", [self.read(mask_n), self.read(c, x.aval), x],
                         _aval_of(node), node.name, impl=_where, name="_where")

    def lower_new_tensor(self, node: fx.Node) -> Literal:
        """``t.new_tensor(c)`` of a Python number is the weakly typed
        literal ``c``, as a number is in ``jnp``."""
        c = node.args[1]
        if not isinstance(c, (bool, int, float)) or node.kwargs:
            raise NotImplementedError("new_tensor of other than a number")
        return Literal(c, Aval((), node.meta["tensor_meta"].dtype,
                               weak=True))

    def lower_loop(self, node: fx.Node) -> tuple[Var, ...]:
        """A traced :func:`scan` → one ``scan`` equation: inputs the
        consts (the constants the body makes first), the carry and the
        scanned inputs, outputs the new carry and the stacked outputs; its
        body the lowered sub-graph of the step (:func:`_run_loop` runs
        it)."""
        c_ns, k_ns, x_ns = node.args
        body = _Lowering(node.meta["loop"], self.device).run()
        # the constants the body makes are constants of this program and,
        # closure-converted as ``jax.lax.scan`` does, the scan's first
        # consts
        for v, c in zip(body.constvars, body.consts):
            self.constvars.append(v)
            self.consts.append(c)
        invars = [*body.constvars,
                  *(self.read(a) for a in (*c_ns, *k_ns, *x_ns))]
        n_consts = len(body.constvars) + len(c_ns)
        body = Graph(body.eqns, [*body.constvars, *body.invars],
                     body.outvars, [], [], body.code)
        impl = functools.partial(_run_loop, body, n_consts, len(k_ns))
        return tuple(self.emit_multi(
            "scan", invars, [Aval(tuple(m.shape), m.dtype)
                             for m in node.meta["tensor_meta"]],
            node.name, impl))

    def lower_remat(self, node: fx.Node) -> tuple[Var, ...]:
        """A traced :func:`checkpoint` → one ``remat2`` equation: inputs
        the constants its body makes (constants of this program, as
        ``jax.checkpoint`` passes its jaxpr's), then the consts, the carry
        and the row; its body the lowered sub-graph (:func:`_run_graph`
        runs it)."""
        body = _Lowering(node.meta["remat"], self.device).run()
        for v, c in zip(body.constvars, body.consts):
            self.constvars.append(v)
            self.consts.append(c)
        invars = [*body.constvars,
                  *(self.read(a) for part in node.args for a in part)]
        body = Graph(body.eqns, [*body.constvars, *body.invars],
                     body.outvars, [], [], body.code)
        return tuple(self.emit_multi(
            "remat2", invars, [Aval(tuple(m.shape), m.dtype)
                               for m in node.meta["tensor_meta"]],
            node.name, _run_graph, jaxpr=body, prevent_cse=True,
            differentiated=False, policy=None))

    def lower_at_add(self, node: fx.Node) -> Var:
        """``at_add(x, idx, v)`` with an (N,) integer ``idx`` → the
        jaxpr's five equations of ``x.at[idx].add(v)``: wrap negative
        indices, make them (N, 1), one ``scatter-add`` (which drops an
        index still out of range)."""
        arr, idx, upd = (self.read(n) for n in node.args)
        it, src, shape = idx.aval.dtype, node.name, idx.aval.shape
        scalar = Aval((), it)
        neg = self.emit("lt", [idx, Literal(0, scalar)],
                        Aval(shape, torch.bool), src)
        wrapped = self.emit("add", [idx, Literal(arr.aval.shape[0], scalar)],
                            Aval(shape, it), src)
        sel = self.emit("select_n", [neg, idx, wrapped], Aval(shape, it), src)
        col = self.emit("broadcast_in_dim", [sel], Aval(shape + (1,), it),
                        src, shape=shape + (1,),
                        broadcast_dimensions=tuple(range(len(shape))))
        return self.emit("scatter-add", [arr, col, upd], arr.aval, src,
                         impl=_scatter_add_drop)

    def lower_at_set(self, node: fx.Node) -> Var:
        """``at_set(x, i, v)`` with a 0-d integer tensor ``i`` → the
        jaxpr's five equations of ``x.at[i].set(v)``: wrap a negative
        index, make it a (1,) index, scatter ``v`` (a Python scalar stays
        a literal).  The scatter drops an index still out of range."""
        arr_n, idx_n, val_n = node.args
        arr, idx = self.env[arr_n], self.read(idx_n)
        if not (isinstance(idx, Var) and idx.aval.shape == ()
                and not idx.aval.dtype.is_floating_point
                and idx.aval.dtype != torch.bool):
            raise NotImplementedError(
                f"at_set({arr_n.name}, {idx_n!r}, ...): only a 0-d integer "
                f"tensor index is lowered yet")
        it, src = idx.aval.dtype, node.name
        scalar = Aval((), it)
        neg = self.emit("lt", [idx, Literal(0, scalar)],
                        Aval((), torch.bool), src)
        wrapped = self.emit("add", [idx, Literal(arr.aval.shape[0], scalar)],
                            scalar, src)
        sel = self.emit("select_n", [neg, idx, wrapped], scalar, src)
        col = self.emit("broadcast_in_dim", [sel], Aval((1,), it), src,
                        shape=(1,), broadcast_dimensions=())
        val = self.read(val_n, Aval((), arr.aval.dtype))
        return self.emit("scatter", [arr, col, val], arr.aval, src)


def _aval_of(node: fx.Node) -> Aval:
    meta = node.meta.get("tensor_meta")
    if meta is None:
        raise NotImplementedError(
            f"FX node {node.name} does not produce one tensor")
    return Aval(tuple(meta.shape), meta.dtype)


class _MetaShapeProp(ShapeProp):
    """``ShapeProp`` on meta tensors: shapes and dtypes without the data,
    so no index is checked against its array — an out-of-range index
    traces, and the lowered program clamps it as the reference's
    ``gather`` / ``dynamic_slice`` do.  ``x[j]`` with a 0-d integer ``j``
    would need ``j``'s value, and its shape does not: it is taken as
    ``x[0]``'s."""

    def run_node(self, n: fx.Node) -> Any:
        self._node = n
        return super().run_node(n)

    def call_function(self, target: Any, args: Any, kwargs: Any) -> Any:
        if target is _grad_node:        # value, aux, then grads
            gm, where = self._node.meta["grad"]
            p_metas, a_metas = args
            ex = [p_metas[i] for i in where]
            val = _MetaShapeProp(gm).propagate(tuple(ex), tuple(a_metas))
            return (*pytree.tree_leaves(val),
                    *map(torch.empty_like, p_metas))
        if target is operator.getitem and _scalar_index(args):
            return args[0].select(0, 0)
        if target is at_set or target is at_add:
            return torch.empty_like(args[0])
        if target is _loop_node or target is _remat_node:
            return self._node.meta["example"]
        if target is _scan_node:     # the carry and the state keep shapes
            if len(args) > 3:        # per-repeat outputs in place of state
                return (torch.empty_like(args[0]),
                        *(torch.empty(shape, dtype=dt, device="meta")
                          for shape, dt in args[3]))
            return (torch.empty_like(args[0]),
                    *map(torch.empty_like, args[2]))
        return super().call_function(target, args, kwargs)

    def call_method(self, target: Any, args: Any, kwargs: Any) -> Any:
        if target == "__getitem__" and _scalar_index(args):
            return args[0].select(0, 0)
        return super().call_method(target, args, kwargs)

    def fetch_attr(self, target: str) -> Any:
        return _to_meta(super().fetch_attr(target))


def _scalar_index(args: Any) -> bool:
    i = args[1]
    return isinstance(i, torch.Tensor) and i.ndim == 0 \
        and not i.is_floating_point() and i.dtype != torch.bool


def _to_meta(x: Any) -> Any:
    return x.to("meta") if isinstance(x, torch.Tensor) else x


class _Proxy(fx.Proxy):
    """A proxy whose value's ``shape`` and ``ndim`` are static, as a
    jaxpr's avals are (a trace may branch on them, and unpack them): its
    example, a ``meta`` tensor — a trace input's, or one computed from
    its arguments' examples (:func:`_example_of`)."""

    @property
    def shape(self) -> torch.Size:
        return _example_of(self).shape

    @property
    def ndim(self) -> int:
        return _example_of(self).ndim


def _example_of(proxy: Any) -> Any:
    """The ``meta`` example of a proxy's value (of a tensor: itself),
    computed once from its node's arguments and kept in the node's
    ``meta``.  A leaf's node whose result the leaf records after
    creating it (a ``grad`` leaf's) is computed when first asked for."""
    if not isinstance(proxy, fx.Proxy):
        return _to_meta(proxy)
    node = proxy.node
    if "example" not in node.meta:
        args = fx.node.map_aggregate(
            node.args, lambda a: _example_of(fx.Proxy(a, proxy.tracer))
            if isinstance(a, fx.Node) else a)
        kwargs = fx.node.map_aggregate(
            node.kwargs, lambda a: _example_of(fx.Proxy(a, proxy.tracer))
            if isinstance(a, fx.Node) else a)
        prop = _MetaShapeProp.__new__(_MetaShapeProp)
        prop._node = node
        if node.op == "call_function":
            ex = prop.call_function(node.target, args, kwargs)
        elif node.op == "call_method":
            ex = prop.call_method(node.target, args, kwargs)
        elif node.op == "get_attr":
            ex = _to_meta(operator.attrgetter(node.target)(
                proxy.tracer.root))
        else:
            raise NotImplementedError(f"no example for {node.op} "
                                      f"{node.target!r}")
        node.meta["example"] = ex
    return node.meta["example"]


class _Tracer(fx.Tracer):
    """``symbolic_trace``'s tracer, each input carrying its example (a
    ``meta`` tensor) in ``node.meta["example"]``, and every proxy it
    makes one whose value's shape is static (:class:`_Proxy`)."""

    def __init__(self, examples: Sequence[Any]):
        super().__init__()
        self._examples = iter(examples)

    def proxy(self, node: fx.Node) -> fx.Proxy:
        if node.op == "placeholder":
            ex = next(self._examples, None)
            if not isinstance(ex, torch.Tensor):
                return super().proxy(node)
            node.meta["example"] = _to_meta(ex)
        return _Proxy(node, self)

    def create_proxy(self, kind: str, target: Any, *args: Any,
                     **kwargs: Any) -> fx.Proxy:
        out = super().create_proxy(kind, target, *args, **kwargs)
        # examples made as the trace goes, so none is computed through a
        # long chain of arguments; a leaf's node records its result after
        # this returns
        if kind != "placeholder" and target not in (_grad_node, _loop_node,
                                                    _remat_node):
            try:
                _example_of(out)
            except Exception:       # noqa: BLE001 — raised when asked for
                pass
        return out


def _symbolic_trace(fn: Callable, examples: Sequence[Any],
                    concrete: Mapping[str, Any] | None
                    ) -> fx.GraphModule:
    """``fx.symbolic_trace(fn, concrete)`` whose inputs know their
    examples (the leaves of the arguments, in order)."""
    tracer = _Tracer(examples)
    graph = tracer.trace(fn, concrete_args=concrete or None)
    return fx.GraphModule(tracer.root, graph, fn.__name__)


def trace(fn: Callable, *example_args: Any, **example_kwargs: Any
          ) -> tuple[Graph, Any]:
    """Trace ``fn`` with ``torch.fx.symbolic_trace``, propagate shapes on
    meta copies of the examples and lower to a :class:`Graph`.  A tuple
    (or list) argument, nested or not, becomes one input per leaf
    (``concrete_args`` of placeholders).  The graph's inputs are the
    leaves of ``example_args`` in order, then those of
    ``example_kwargs`` by sorted name — the order of
    ``jax.make_jaxpr(fn)(*args, **kwargs)``'s invars (FX makes its
    placeholders in the signature's order).  Returns the graph and the
    output structure (a ``torch.utils._pytree`` spec over
    ``graph.outvars``).  Closed-over tensors must be module globals or
    closure variables: ``symbolic_trace`` does not accept default
    arguments, which would become inputs."""
    bound = inspect.signature(fn).bind(*example_args, **example_kwargs)
    concrete = {name: pytree.tree_map(lambda _: fx.PH, a)
                for name, a in bound.arguments.items()
                if isinstance(a, (tuple, list))}
    args = tuple(bound.arguments.values())
    gm = _symbolic_trace(fn, pytree.tree_leaves(args), concrete)
    _MetaShapeProp(gm).propagate(*pytree.tree_map(_to_meta, args))
    device = next((t.device for t in pytree.tree_leaves(args)
                   if isinstance(t, torch.Tensor)), None)
    lowering = _Lowering(gm, device)
    graph = lowering.run()
    if example_kwargs:
        graph.invars = _jaxpr_input_order(graph.invars, bound.arguments,
                                          len(example_args))
    return graph, lowering.out_tree


def _jaxpr_input_order(invars: list[Var], arguments: Mapping[str, Any],
                       n_positional: int) -> list[Var]:
    """``invars`` (one per leaf, arguments in the signature's order)
    with the positional arguments' leaves first, then the keyword
    arguments' by sorted name."""
    groups, k = {}, 0
    for name, a in arguments.items():
        n = len(pytree.tree_leaves(a)) if isinstance(a, (tuple, list)) \
            else 1
        groups[name] = invars[k:k + n]
        k += n
    if k != len(invars):
        raise NotImplementedError(
            f"{len(invars) - k} inputs beyond the examples (an argument "
            f"left to its default)")
    names = list(arguments)
    order = names[:n_positional] + sorted(names[n_positional:])
    return [v for name in order for v in groups[name]]


def carry_pairs(carry_example: Any, nonaliasing_carries: Sequence[int] = ()
                ) -> list[tuple[int, int]]:
    """One ``(output, input)`` pair per leaf of the carry, minus the
    leaves listed in ``nonaliasing_carries`` — the reference's rule."""
    skip = set(nonaliasing_carries)
    n_carry = len(pytree.tree_leaves(carry_example))
    return [(i, i) for i in range(n_carry) if i not in skip]


@dataclasses.dataclass
class Node:
    """One CDFG node == one lowered equation (before SCC collapse)."""

    id: int
    prim: str
    eqn: Eqn
    is_memory: bool
    latency: int
    region: str | None = None  # memory region for memory ops
    is_store: bool = False

    @property
    def is_long(self) -> bool:
        return self.latency > 1

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        tag = "M" if self.is_memory else ("L" if self.is_long else ".")
        return f"<n{self.id} {self.prim} [{tag}]>"


@dataclasses.dataclass
class Edge:
    src: int
    dst: int
    var: Any | None  # Var carried (None for memory-order / carry edges)
    kind: str = "data"  # "data" | "mem" | "carry"


class CDFG:
    """Control-dataflow graph over lowered equations.

    Nodes are equations; edges are SSA def-use pairs plus explicit
    memory-ordering edges and (for the loop view) carry back-edges.
    """

    def __init__(
        self,
        graph: Graph,
        nodes: list[Node],
        edges: list[Edge],
        region_of_invar: Mapping[int, str],
    ) -> None:
        self.graph = graph
        self.nodes = nodes
        self.edges = edges
        self.invars = list(graph.invars)
        self.outvars = list(graph.outvars)
        self.region_of_invar = dict(region_of_invar)
        self._by_id = {n.id: n for n in nodes}
        #: active TransformConfig, set by the driver's ``transform`` pass
        #: (None = untransformed); read by ``partition.materialize``
        self.transforms = None

    # -- construction -------------------------------------------------------

    @classmethod
    def from_function(
        cls,
        fn: Callable,
        *example_args: Any,
        latency_model: LatencyModel | None = None,
        regions: Mapping[int, str] | None = None,
        add_memory_edges: bool = True,
        **example_kwargs: Any,
    ) -> "CDFG":
        graph, _ = trace(fn, *example_args, **example_kwargs)
        return cls.from_graph(graph, latency_model=latency_model,
                              regions=regions,
                              add_memory_edges=add_memory_edges)

    @classmethod
    def from_graph(
        cls,
        graph: Graph,
        *,
        latency_model: LatencyModel | None = None,
        regions: Mapping[int, str] | None = None,
        add_memory_edges: bool = True,
        annotate_regions: bool = True,
        carry_pairs: Sequence[tuple[int, int]] = (),
    ) -> "CDFG":
        """Build the CDFG.  ``carry_pairs`` is a list of
        ``(outvar_index, invar_index)`` pairs: a back-edge is added from the
        producer of ``outvars[o]`` to every consumer of ``invars[i]``,
        recreating loop-carried dependence cycles (the §III loop view).

        ``annotate_regions=False`` defers the memory-dependence analysis
        (region discovery + ordering edges) so it can run as a separate
        compiler pass — see :func:`annotate_memory_regions` and
        :func:`add_memory_order_edges`.
        """
        lm = latency_model or LatencyModel()

        nodes: list[Node] = []
        producer: dict[Any, int] = {}  # var -> node id
        for i, eqn in enumerate(graph.eqns):
            prim = eqn.prim
            nodes.append(Node(
                id=i,
                prim=prim,
                eqn=eqn,
                is_memory=prim in MEMORY_PRIMITIVES,
                latency=lm.latency(prim),
                is_store=prim.startswith("scatter")
                or prim == "dynamic_update_slice",
            ))
            for ov in eqn.outvars:
                producer[ov] = i

        edges: list[Edge] = []
        for i, eqn in enumerate(graph.eqns):
            for iv in eqn.invars:
                if isinstance(iv, Literal):
                    continue
                if iv in producer:
                    edges.append(Edge(producer[iv], i, iv, "data"))

        cdfg = cls(graph, nodes, edges, dict(regions or {}))

        if annotate_regions or add_memory_edges:
            annotate_memory_regions(cdfg, regions, producer=producer)
        if add_memory_edges:
            add_memory_order_edges(cdfg)

        # loop-carried back-edges (the §III faithful view)
        for out_idx, in_idx in carry_pairs:
            ov = graph.outvars[out_idx]
            if isinstance(ov, Literal) or ov not in producer:
                continue
            src = producer[ov]
            iv = graph.invars[in_idx]
            for j, eqn in enumerate(graph.eqns):
                if any(x is iv for x in eqn.invars):
                    cdfg.edges.append(Edge(src, j, None, "carry"))

        return cdfg

    @classmethod
    def from_loop_body(
        cls,
        body_fn: Callable,
        carry_example: Any,
        *xs_example: Any,
        latency_model: LatencyModel | None = None,
        regions: Mapping[int, str] | None = None,
        nonaliasing_carries: Sequence[int] = (),
    ) -> "CDFG":
        """Trace ``body_fn(carry, *xs) -> new_carry`` and add carry
        back-edges so loop-carried dependence becomes a real cycle.

        ``carry_example`` may be a tuple: every leaf becomes one carry
        pair.  ``nonaliasing_carries`` is the paper's §III-A *user
        annotation*: carry leaves whose back-edge is dropped so Algorithm
        1 can pipeline across a false dependence.
        """
        graph, _ = trace(body_fn, carry_example, *xs_example)
        return cls.from_graph(
            graph, latency_model=latency_model, regions=regions,
            carry_pairs=carry_pairs(carry_example, nonaliasing_carries))

    # -- queries ------------------------------------------------------------

    def node(self, nid: int) -> Node:
        return self._by_id[nid]

    def successors(self, nid: int) -> Iterable[int]:
        return (e.dst for e in self.edges if e.src == nid)

    def to_networkx(self):
        import networkx as nx

        g = nx.MultiDiGraph()
        for n in self.nodes:
            g.add_node(n.id, prim=n.prim, is_memory=n.is_memory,
                       latency=n.latency, region=n.region)
        for e in self.edges:
            g.add_edge(e.src, e.dst, kind=e.kind)
        return g

    @property
    def memory_nodes(self) -> list[Node]:
        return [n for n in self.nodes if n.is_memory]

    @property
    def long_nodes(self) -> list[Node]:
        return [n for n in self.nodes if n.is_long]

    def summary(self) -> str:
        lines = [f"CDFG: {len(self.nodes)} nodes, {len(self.edges)} edges, "
                 f"{len(self.memory_nodes)} memory ops, "
                 f"{len(self.long_nodes)} long-latency ops"]
        for n in self.nodes:
            tag = "MEM" if n.is_memory else ("LONG" if n.is_long else "")
            reg = f" region={n.region}" if n.region else ""
            lines.append(f"  n{n.id:<3} {n.prim:<24} lat={n.latency}"
                         f" {tag}{reg}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Memory-dependence analysis (§III-A) — standalone so the compiler driver
# can schedule it as a named pass (repro_torch.dataflow.passes.MemoryDepPass).
# ---------------------------------------------------------------------------


def producer_map(cdfg: CDFG) -> dict[Any, int]:
    """var -> id of the node that defines it."""
    return {ov: n.id for n in cdfg.nodes for ov in n.eqn.outvars}


def annotate_memory_regions(
    cdfg: CDFG, regions: Mapping[int, str] | None = None,
    *, producer: Mapping[Any, int] | None = None,
) -> dict[int, str]:
    """Region discovery: walk each memory op's buffer operand back through
    layout ops to a graph input (or a closed-over constant) and record the
    region on the node.  ``regions`` overrides names per input index — the
    paper's user-guided alias annotation.  ``producer`` accepts a
    precomputed :func:`producer_map` to avoid rebuilding it."""
    graph = cdfg.graph
    if producer is None:
        producer = producer_map(cdfg)
    invar_index = {v: k for k, v in enumerate(graph.invars)}
    constvar_index = {v: k for k, v in enumerate(graph.constvars)}
    region_of_invar = cdfg.region_of_invar
    if regions:
        region_of_invar.update(regions)

    def root_invar(var: Any) -> int | None:
        seen = 0
        while True:
            if var in invar_index:
                return invar_index[var]
            if var in constvar_index:
                return -1 - constvar_index[var]  # consts: negative ids
            pid = producer.get(var)
            if pid is None:
                return None
            peqn = cdfg.nodes[pid].eqn
            if peqn.prim in _TRANSPARENT and peqn.invars:
                nxt = peqn.invars[0]
                if isinstance(nxt, Literal):
                    return None
                var = nxt
                seen += 1
                if seen > 100:
                    return None
            else:
                return None

    for node in cdfg.nodes:
        if not node.is_memory or not node.eqn.invars:
            continue
        op0 = node.eqn.invars[0]
        if isinstance(op0, Literal):
            continue
        ridx = root_invar(op0)
        if ridx is not None:
            default = (f"arg{ridx}" if ridx >= 0
                       else f"const{-1 - ridx}")
            name = region_of_invar.get(ridx, default)
            region_of_invar.setdefault(ridx, name)
            node.region = name
        else:
            node.region = "_anon"
    return region_of_invar


def add_memory_order_edges(cdfg: CDFG) -> list[Edge]:
    """§III-A: explicit ordering edges between memory ops of one region.
    Loads commute; stores serialize against everything in the region.
    Appends the new edges to ``cdfg.edges`` and returns them."""
    added: list[Edge] = []
    by_region: dict[str, list[Node]] = {}
    for n in cdfg.nodes:
        if n.is_memory and n.region is not None:
            by_region.setdefault(n.region, []).append(n)
    for reg_nodes in by_region.values():
        reg_nodes.sort(key=lambda n: n.id)
        last_store: Node | None = None
        loads_since_store: list[Node] = []
        for n in reg_nodes:
            if n.is_store:
                if last_store is not None:
                    added.append(Edge(last_store.id, n.id, None, "mem"))
                for ld in loads_since_store:
                    added.append(Edge(ld.id, n.id, None, "mem"))
                last_store = n
                loads_since_store = []
            else:
                if last_store is not None:
                    added.append(Edge(last_store.id, n.id, None, "mem"))
                loads_since_store.append(n)
    cdfg.edges.extend(added)
    return added
