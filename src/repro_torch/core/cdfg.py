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
* inside :func:`leaves`, a function named there as an ``index`` leaf
  (``x[idx]`` with the reference's wrap-then-clamp read) into those of
  ``x[idx]``, and one named as a ``scan`` leaf (a loop kept inside one
  call: a model segment's repeats) into one ``scan`` equation, as
  ``jax.lax.scan`` is one in the jaxpr;
* a static index into ``slice`` / ``squeeze`` / ``broadcast_in_dim``,
  ``x.mean`` into ``reduce_sum, broadcast_in_dim, div``, ``x.var`` into
  one ``jit`` (``jnp.var`` is a jitted function), ``x.float()`` /
  ``x.to(dtype)`` into ``convert_element_type`` (nothing when the dtype
  stays), a two-operand ``torch.einsum`` into ``dot_general``, and rank
  promotion into a ``broadcast_in_dim`` — what the decode step's top
  level needs;
* ``operator.mul`` → ``mul``, ``operator.add`` → ``add``, and so on.

So :data:`MEMORY_PRIMITIVES`, :data:`DEFAULT_LATENCY`,
:data:`CHEAP_PRIMITIVES` and Algorithm 1 apply unchanged, and a body
compiles to the same plan as its JAX twin.  The lowered program is a
:class:`Graph` of :class:`Eqn` records over :class:`Var` values; each
``Var`` carries an :class:`Aval` (``shape`` and a ``torch.dtype``, whose
``itemsize`` is all the partitioner reads).  Closed-over tensors become
constants named ``const{k}`` in first-use order, as in the reference.
A tuple argument is flattened into one input per leaf, in order, as the
jaxpr's invars are; outputs are flattened likewise.

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
import operator
from typing import Any, Callable, Iterable, Iterator, Mapping, Sequence

import torch
import torch.fx as fx
import torch.utils._pytree as pytree
from torch.fx.passes.shape_prop import ShapeProp

from .. import tree

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
    ``source`` names the FX node it was lowered from."""

    prim: str
    invars: list[Any]
    outvars: list[Var]
    params: dict[str, Any]
    impl: Callable[..., Any]
    source: str

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

def _select_n(pred: torch.Tensor, on_false: Any, on_true: Any) -> torch.Tensor:
    return torch.where(pred, on_true, on_false)


def _dynamic_slice(operand: torch.Tensor, start: torch.Tensor,
                   *other_starts: Any, slice_sizes: tuple[int, ...]
                   ) -> torch.Tensor:
    # only axis 0 is dynamic (the lowering of x[j]); the start is clamped
    # into range like the reference's dynamic_slice
    start = torch.clamp(start, 0, operand.shape[0] - slice_sizes[0])
    return torch.index_select(operand, 0, start.reshape(1).long())


def _squeeze(x: torch.Tensor, *, dimensions: tuple[int, ...]) -> torch.Tensor:
    return torch.squeeze(x, dim=dimensions)


def _broadcast_in_dim(x: torch.Tensor, *, shape: tuple[int, ...],
                      broadcast_dimensions: tuple[int, ...]) -> torch.Tensor:
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


def _convert_element_type(x: torch.Tensor, *, new_dtype: torch.dtype
                          ) -> torch.Tensor:
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


def _einsum(a: torch.Tensor, b: torch.Tensor, *, equation: str
            ) -> torch.Tensor:
    return torch.einsum(equation, a, b)


@contextlib.contextmanager
def leaves(*, index: Sequence[tuple[Any, str]] = (),
           scan: Sequence[tuple[Any, str]] = ()) -> Iterator[None]:
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
    outputs are the new carry and the leaves of the new state.

    Each function is replaced in its module's globals for the block, as
    ``torch.fx.wrap`` does for a trace; called on tensors, it runs
    unchanged."""
    saved = [(m, n, getattr(m, n)) for m, n in (*index, *scan)]
    try:
        for m, n in index:
            setattr(m, n, _index_leaf(getattr(m, n)))
        for m, n in scan:
            setattr(m, n, _scan_leaf(getattr(m, n)))
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
        n_state = len(tree.leaves(state))
        out = carry.tracer.create_proxy(
            "call_function", _scan_node,
            (carry, tuple(tree.leaves(consts)), tuple(tree.leaves(state))),
            {})
        # the body rides on the node's meta, so the lowered equation runs it
        out.node.meta["scan"] = (functools.partial(fn, **static), consts,
                                 state)
        return out[0], tree.unflatten(state, [out[1 + i]
                                              for i in range(n_state)])
    return leaf


def _scan_node(carry: Any, consts: tuple, state: tuple) -> tuple:
    """The call target of a traced ``scan`` leaf (its node's body lives
    in ``meta``; the lowered equation runs it)."""
    raise RuntimeError("a traced scan runs through its lowered equation")


def _run_scan(body: Callable, consts_like: Any, state_like: Any,
              n_consts: int, carry: Any, *leaves: Any) -> tuple:
    consts = tree.unflatten(consts_like, list(leaves[:n_consts]))
    state = tree.unflatten(state_like, list(leaves[n_consts:]))
    carry, new_state = body(carry, consts, state)
    return (carry, *tree.leaves(new_state))


#: FX node (call_function target, or call_method name) -> primitive name
_BINARY: dict[Any, str] = {
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
}
#: primitive name -> implementation on tensors (and Python scalars)
_IMPL: dict[str, Callable[..., Any]] = {
    "add": operator.add, "sub": operator.sub, "mul": operator.mul,
    "div": operator.truediv, "lt": operator.lt, "le": operator.le,
    "gt": operator.gt, "ge": operator.ge, "eq": operator.eq,
    "ne": operator.ne, "and": operator.and_, "or": operator.or_,
    "xor": operator.xor, "max": torch.maximum, "min": torch.minimum,
    "dot_general": torch.matmul, "neg": operator.neg, "abs": torch.abs,
    "exp": torch.exp, "log": torch.log, "tanh": torch.tanh,
    "logistic": torch.sigmoid, "sqrt": torch.sqrt, "rsqrt": torch.rsqrt,
    "sin": torch.sin, "cos": torch.cos,
    "select_n": _select_n, "dynamic_slice": _dynamic_slice,
    "squeeze": _squeeze, "broadcast_in_dim": _broadcast_in_dim,
    "gather": _gather, "scatter": _scatter,
    "convert_element_type": _convert_element_type, "reduce_sum": _reduce_sum,
    "slice": _slice,
}


class _Lowering:
    """Walks an FX graph and emits :class:`Eqn` records."""

    def __init__(self, gm: fx.GraphModule):
        self.gm = gm
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
             impl: Callable[..., Any] | None = None, **params: Any) -> Var:
        out = Var(aval, f"{source}.{len(self.eqns)}")
        self.eqns.append(Eqn(prim, invars, [out], params,
                             impl or _IMPL[prim], source))
        return out

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
        if target is _scan_node:
            return self.lower_scan(node)
        if target is builtins.getattr:
            return self.lower_getattr(node)
        if target in ("float", "to"):
            return self.lower_convert(node)
        if target in ("mean", "var"):
            return self.lower_reduction(node)
        if target is torch.einsum:
            return self.lower_einsum(node)
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
            if prim != "dot_general":
                ops = self.promote_ranks(ops, node.name)
            return self.emit(prim, ops, aval, node.name)
        if target in _UNARY and len(node.args) == 1:
            return self.emit(_UNARY[target], [self.read(node.args[0])],
                             aval, node.name)
        if target is torch.where and len(node.args) == 3:
            c, a, b = node.args
            return self.emit("select_n", [self.read(c), self.read(b, aval),
                                          self.read(a, aval)],
                             aval, node.name)
        raise NotImplementedError(
            f"FX node {node.op} {target!r} is not lowered by the port's "
            f"front end yet")

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
        axes = [i for i in index if i is not None]
        if len(axes) > len(shape) or not all(
                isinstance(i, (int, slice)) for i in axes):
            raise NotImplementedError(
                f"indexing with {index!r} is not lowered yet")
        axes += [slice(None)] * (len(shape) - len(axes))
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

    def lower_scan(self, node: fx.Node) -> tuple[Var, ...]:
        """A traced ``scan`` leaf → one ``scan`` equation: inputs the
        carry and the leaves of ``consts`` and ``state``, outputs the new
        carry and the leaves of the new state."""
        carry_n, const_ns, state_ns = node.args
        invars = [self.read(a) for a in (carry_n, *const_ns, *state_ns)]
        outs = tuple(Var(Aval(tuple(m.shape), m.dtype),
                         f"{node.name}.{len(self.eqns)}.{i}")
                     for i, m in enumerate(node.meta["tensor_meta"]))
        body, consts_like, state_like = node.meta["scan"]
        impl = functools.partial(_run_scan, body, consts_like, state_like,
                                 len(const_ns))
        self.eqns.append(Eqn("scan", invars, list(outs), {}, impl,
                             node.name))
        return outs

    def lower_getattr(self, node: fx.Node) -> Any:
        """``x.dtype``: static, no equation."""
        x, name = node.args
        if name != "dtype":
            raise NotImplementedError(f"attribute {name!r} is not lowered "
                                      f"yet")
        return self.env[x].aval.dtype

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
        (``jnp.mean``); ``x.var(dim, keepdim=True, unbiased=False)`` → one
        ``jit`` equation, as ``jnp.var`` is a jitted function."""
        params = dict(zip(("dim", "keepdim"), node.args[1:]), **node.kwargs)
        x = self.env[node.args[0]]
        shape, dt, src = x.aval.shape, x.aval.dtype, node.name
        dim = params["dim"]
        dims = (dim,) if isinstance(dim, int) else dim
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
                             impl=functools.partial(_var, axes=axes))
        reduced = tuple(n for d, n in enumerate(shape) if d not in axes)
        out = self.emit("reduce_sum", [x], Aval(reduced, dt), src,
                        axes=axes)
        if params.get("keepdim"):
            out = self.emit("broadcast_in_dim", [out], Aval(keep, dt), src,
                            shape=keep,
                            broadcast_dimensions=tuple(
                                d for d in range(len(shape))
                                if d not in axes))
        count = 1
        for d in axes:
            count *= shape[d]
        return self.emit("div", [out, Literal(float(count), Aval((), dt))],
                         out.aval, src)

    def lower_einsum(self, node: fx.Node) -> Var:
        """A two-operand ``torch.einsum`` → ``dot_general``."""
        equation, *operands = node.args
        if len(operands) != 2:
            raise NotImplementedError("einsum of other than two operands")
        return self.emit("dot_general", [self.read(o) for o in operands],
                         _aval_of(node), node.name,
                         impl=functools.partial(_einsum, equation=equation))

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

    def call_function(self, target: Any, args: Any, kwargs: Any) -> Any:
        if target is operator.getitem and _scalar_index(args):
            return args[0].select(0, 0)
        if target is at_set:
            return torch.empty_like(args[0])
        if target is _scan_node:     # the carry and the state keep shapes
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


def trace(fn: Callable, *example_args: Any) -> tuple[Graph, Any]:
    """Trace ``fn`` with ``torch.fx.symbolic_trace``, propagate shapes on
    meta copies of ``example_args`` and lower to a :class:`Graph`.  A
    tuple (or list) argument, nested or not, becomes one input per leaf
    (``concrete_args`` of placeholders), so the graph's inputs are the
    leaves of ``example_args`` in order.  Returns the graph and the
    output structure (a ``torch.utils._pytree`` spec over
    ``graph.outvars``).  Closed-over tensors must be module globals or
    closure variables: ``symbolic_trace`` does not accept default
    arguments, which would become inputs."""
    params = list(inspect.signature(fn).parameters)
    concrete = {name: pytree.tree_map(lambda _: fx.PH, a)
                for name, a in zip(params, example_args)
                if isinstance(a, (tuple, list))}
    gm = fx.symbolic_trace(fn, concrete_args=concrete or None)
    _MetaShapeProp(gm).propagate(*pytree.tree_map(_to_meta, example_args))
    lowering = _Lowering(gm)
    graph = lowering.run()
    return graph, lowering.out_tree


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
    ) -> "CDFG":
        graph, _ = trace(fn, *example_args)
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
