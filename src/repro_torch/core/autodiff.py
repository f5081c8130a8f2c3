"""Reverse-mode differentiation of a lowered graph, in the jaxpr's
vocabulary: the port's ``jax.value_and_grad`` for the dataflow front
end.

A ``grad`` leaf (:func:`repro_torch.core.cdfg.leaves`) traces the value
function into a sub-graph; :func:`lower_value_and_grad` then emits, into
the enclosing graph, what JAX's ``value_and_grad`` leaves in a jaxpr:

1. the sub-graph's equations in order, each with the residuals its JVP
   rule keeps (``rsqrt``: ``div(ans, x)``, ``mul(-0.5, ·)``; a jitted
   function: its extra outputs) — JAX's linearize, known side;
2. the tangent program's equations that read no tangent (a zero carry
   tangent a segment's scan needs), then each linear equation's
   transpose in reverse order, a cotangent reaching a value twice summed
   by ``add_any`` — JAX's ``backward_pass``;
3. a zero (``broadcast_in_dim`` of ``0``) for each parameter the value
   does not read.

Each rule follows the JVP and transpose rule JAX publishes for the
primitive (``jax._src.lax``): ``mul`` of two tangents is two linear
``mul``\\ s and an ``add_any``, transposed right operand first;
``_unbroadcast`` sums and reshapes a cotangent back to a broadcast
operand; ``dot_general``'s transposes are ``_dot_general_transpose_lhs``
/ ``_rhs``; ``slice`` → ``pad``, ``squeeze`` → ``broadcast_in_dim``
(``expand_dims``), ``reduce_sum`` ↔ ``broadcast_in_dim``, ``gather`` →
``broadcast_in_dim`` of zeros and ``scatter-add``.  The jitted
functions ``log_softmax``, ``take_along_axis`` and ``_var`` keep their
residuals as extra outputs of one ``jit`` equation and transpose to one
``jit`` equation, as JAX's partial evaluation of a ``jit`` does.

A scan whose body is a lowered graph (``cdfg.scan``: a segment over its
stacked repeats, the chunked attention, the WKV recurrence or Mamba's
selective scan inside it, DeepSeek-V3's MTP layer's attention at the
loss's top level)
follows JAX's linearization of a scan (:func:`_jvp_loop`): the body's
JVP splits it into its known part and the tangent program; the known
part, less what nothing needs, is partially evaluated on the consts
(:func:`_partial_eval`) — what reads only consts and literals is hoisted
ahead of the loop, a ``jit`` split as JAX splits one (a ``jit`` left
with no output among them), a scan in the body split by
:func:`_split_loop` (a segment's attention masks become a scan of their
own ahead of both loops); the forward scan stacks the residuals the
tangent program reads, and the transpose is one reverse scan of the
transposed body, a nested scan's transposed scan inside it — the
reference's equations.

A segment under ``cfg.remat`` is a scan of one ``remat2`` equation
(``cdfg.checkpoint``), linearized as JAX's remat with ``policy=None``
(:func:`_jvp_remat`): the forward scan runs the body's primal alone (a
scan in it one ``closed_call``), its only residuals the body's inputs;
the reverse scan's body is one ``remat2`` equation that recomputes the
primal, its residuals and the transposes — the JVP partially evaluated
as JAX does there (a few rules keep other residuals, and a nested scan
orders its residuals as JAX's partial evaluation makes them).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import operator
from typing import Any, Callable

import numpy as np
import torch

from .._device import get_device
from .cdfg import (Aval, Eqn, Graph, Literal, Var, _Lowering,
                   _broadcast_in_dim, _concatenate, _dot_general,
                   _dynamic_update_slice, _integer_pow, _pad_jit, _reshape,
                   _run_graph, _run_loop, _softplus, _split, _transpose,
                   _where)

__all__ = ["lower_value_and_grad", "JVP_RULES"]


class _Key:
    """One tangent of the tangent program (cotangents accumulate per
    key; a tangent passed through unchanged shares its operand's)."""

    __slots__ = ()


@dataclasses.dataclass
class _Linear:
    """A linear equation of the tangent program: ``transpose`` maps the
    cotangents of ``outs`` (``None`` for a zero) to ``(key, cotangent)``
    pairs, in operand order, emitting its equations."""

    outs: list[_Key]
    transpose: Callable[[list[Any]], list[tuple[_Key, Any]]]
    #: known values the tangent equation reads that its transpose does
    #: not (a zero tangent it instantiates): residuals all the same
    reads: list[Any] = dataclasses.field(default_factory=list)
    #: the tangent equation's operands in order (a key for a tangent, a
    #: value for a residual), where its transpose reads them in another
    #: (:func:`_tangent_parents`)
    ins: list[Any] | None = None


def _is_float(aval: Aval) -> bool:
    return aval.dtype.is_floating_point


def _shape(x: Any) -> tuple[int, ...]:
    return x.aval.shape


# -- implementations of the equations the backward emits ---------------------

def _pad(x: torch.Tensor, val: Any, *,
         padding_config: tuple[tuple[int, int, int], ...]) -> torch.Tensor:
    pads = []
    for lo, hi, interior in reversed(padding_config):
        if interior:
            raise NotImplementedError("pad with interior padding")
        pads += [lo, hi]
    return torch.nn.functional.pad(x, pads, value=float(val))


def _scatter_add(operand: torch.Tensor, indices: torch.Tensor,
                 updates: torch.Tensor) -> torch.Tensor:
    # the transpose of the ``gather`` of whole rows along axis 0 (the
    # lowering of ``x[idx]``): rows clamped as the gather clamps them;
    # a row hit twice sums in fp32, rounded once
    rows = torch.clamp(indices[..., 0], 0, operand.shape[0] - 1)
    return operand.float().index_add(
        0, rows.reshape(-1).long(),
        updates.reshape(-1, *operand.shape[1:]).float()).to(operand.dtype)


# -- the jitted functions' forward with residuals, and their transposes ------

def _log_softmax_fwd(x: torch.Tensor, *, dim: int = -1) -> tuple:
    e = torch.exp(x - x.amax(dim, keepdim=True))
    return torch.log_softmax(x, dim), e, e.sum(dim, keepdim=True)


def _log_softmax_vjp(e: torch.Tensor, s: torch.Tensor, ct: torch.Tensor, *,
                     dim: int = -1) -> torch.Tensor:
    return ct - e / s * ct.sum(dim, keepdim=True)


def _take_along_axis_fwd(take: Callable, x: torch.Tensor, idx: torch.Tensor
                         ) -> tuple:
    n = x.shape[-1]
    wrapped = torch.where(idx < 0, idx + n, idx)
    return take(x, idx), wrapped[..., None].to(torch.int32)


def _take_along_axis_vjp(res: torch.Tensor, ct: torch.Tensor, *, n: int
                         ) -> torch.Tensor:
    w = res[..., 0]
    valid = (w >= 0) & (w < n)
    out = ct.new_zeros((*w.shape[:-1], n))
    return out.scatter_add(-1, w.clamp(0, n - 1).long(),
                           torch.where(valid, ct, 0))


def _var_fwd(var: Callable, x: torch.Tensor, correction: int, *,
             axes: tuple[int, ...]) -> tuple:
    """``jnp.var``'s forward with its residuals: the centred operand, the
    count, whether it is positive, and the zero tangent of the ``nan``
    its ``jnp.where`` picks otherwise."""
    mean = x.mean(axes, keepdim=True)
    n = float(np.prod([x.shape[a] for a in axes]) - correction)
    return (var(x, correction, axes=axes), x - mean, x.new_tensor(n),
            torch.tensor(n > 0, device=x.device), torch.zeros_like(mean))


def _var_consts(correction: Any, *, count: int, shape: tuple[int, ...],
                dtype: torch.dtype) -> tuple:
    """The part of :func:`_var_fwd` that reads only the correction (a
    scan body's loop invariant): the count, whether it is positive, the
    zero tangent and the ``nan`` broadcast."""
    dev = get_device(None)
    n = torch.tensor(float(count - int(correction)), dtype=dtype, device=dev)
    return (n, n > 0, torch.zeros(shape, dtype=dtype, device=dev),
            torch.full(shape, math.nan, dtype=dtype, device=dev))


def _var_loop(x: torch.Tensor, n: torch.Tensor, ok: torch.Tensor,
              nan: torch.Tensor, *, axes: tuple[int, ...]) -> tuple:
    """The rest of :func:`_var_fwd`: the variance and the centred
    operand."""
    centered = x - x.mean(axes, keepdim=True)
    var = (centered * centered).sum(axes, keepdim=True) / n
    return torch.where(ok, var, nan), centered


def _var_vjp(centered: torch.Tensor, n: torch.Tensor, ok: torch.Tensor,
             zeros: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    return ct * 2 * centered / n


# -- the tape -----------------------------------------------------------------

class _Tape:
    """One ``value_and_grad``'s lowering into ``lo``'s graph."""

    def __init__(self, lo: _Lowering, source: str):
        self.lo, self.src = lo, source
        self.env: dict[Any, Any] = {}       # sub-graph var -> value here
        self.tan: dict[Any, _Key] = {}      # value here -> its tangent
        self.linear: list[_Linear] = []
        self.pre: list[Callable[[], Any]] = []
        #: emit the tangent program's equations that read no tangent where
        #: the JVP makes them (a ``remat2`` body's, which JAX partially
        #: evaluates as a whole), not ahead of the transposes
        self.eager_pre = False
        self.eager_made: list[Var] = []
        #: a body under ``jax.checkpoint``: the rules that differ between
        #: JAX's linearization and its JVP partially evaluated take the
        #: latter
        self.remat = False
        self.ct: dict[_Key, Any] = {}

    # emission
    def emit(self, prim: str, ins: list[Any], aval: Aval,
             impl: Callable | None = None, name: str = "",
             **params: Any) -> Var:
        return self.lo.emit(prim, ins, aval, self.src, impl=impl, name=name,
                            **params)

    def emit_multi(self, prim: str, ins: list[Any], avals: list[Aval],
                   impl: Callable | None = None, name: str = "",
                   **params: Any) -> list[Var]:
        return self.lo.emit_multi(prim, ins, avals, self.src, impl, name,
                                  **params)

    def copy(self, e: Eqn, ins: list[Any]) -> list[Var]:
        return self.emit_multi(e.prim, ins, [v.aval for v in e.outvars],
                               e.impl, e.name, **e.params)

    # tangents
    def has_tangent(self, x: Any) -> bool:
        return isinstance(x, Var) and x in self.tan

    def fresh(self, out: Var) -> _Key:
        self.tan[out] = key = _Key()
        return key

    def accum(self, key: _Key | None, ct: Any) -> None:
        if key is None:
            return
        old = self.ct.get(key)
        if old is None:
            self.ct[key] = ct
            return
        aval = old.aval if isinstance(old, Var) else ct.aval
        self.ct[key] = self.emit("add_any", [old, ct], aval,
                                 impl=operator.add)

    def unbroadcast(self, aval: Aval, t: Any) -> Any:
        """JAX's ``_unbroadcast``: a cotangent back to the shape of an
        operand the op broadcast."""
        tshape = _shape(t)
        if tshape == aval.shape:
            return t
        if not aval.shape:
            return self.emit("reduce_sum", [t], Aval((), t.aval.dtype),
                             axes=tuple(range(len(tshape))))
        dims = tuple(i for i, (a, b) in enumerate(zip(tshape, aval.shape))
                     if a != b)
        kept = tuple(n for i, n in enumerate(tshape) if i not in dims)
        r = self.emit("reduce_sum", [t], Aval(kept, t.aval.dtype), axes=dims)
        return self.reshape(r, aval.shape)

    def reshape(self, x: Any, shape: tuple[int, ...]) -> Any:
        if _shape(x) == shape:
            return x
        return self.emit("reshape", [x], Aval(shape, x.aval.dtype),
                         impl=_reshape, new_sizes=shape)

    def zeros(self, aval: Aval) -> Var:
        """``lax.full(shape, 0)``: a ``broadcast_in_dim`` of ``0``."""
        return self.broadcast(Literal(0, Aval((), aval.dtype)), aval.shape,
                              ())

    def broadcast(self, x: Any, shape: tuple[int, ...],
                  dims: tuple[int, ...]) -> Var:
        dt = x.aval.dtype
        return self.emit("broadcast_in_dim", [x], Aval(shape, dt),
                         impl=functools.partial(_broadcast_in_dim, dtype=dt),
                         shape=shape, broadcast_dimensions=dims)

    def defer(self, emit: Callable[[], Any]) -> None:
        """An equation of the tangent program that reads no tangent."""
        if self.eager_pre:
            self.eager_made.append(emit())
        else:
            self.pre.append(emit)

    # the two passes
    def forward(self, eqns: list[Eqn]) -> None:
        for e in eqns:
            ins = [v if isinstance(v, Literal) else self.env[v]
                   for v in e.invars]
            lin = [self.has_tangent(x) for x in ins]
            if not any(lin) or not any(_is_float(v.aval)
                                       for v in e.outvars):
                outs = self.copy(e, ins)
            else:
                rule = JVP_RULES.get(f"jit {e.name}" if e.prim == "jit"
                                     else e.prim)
                if rule is None:
                    what = f"jit {e.name}" if e.prim == "jit" else e.prim
                    raise NotImplementedError(
                        f"no differentiation rule for {what!r} yet "
                        f"(core/autodiff.py)")
                outs = rule(self, e, ins, lin)
            for v, o in zip(e.outvars, outs):
                self.env[v] = o

    def backward(self, value: Any) -> None:
        if not self.has_tangent(value):
            raise NotImplementedError("the value does not depend on the "
                                      "parameters")
        self.ct[self.tan[value]] = Literal(1.0, Aval((), value.aval.dtype))
        for emit in self.pre:
            emit()
        for rec in reversed(self.linear):
            cts = [self.ct.pop(k, None) for k in rec.outs]
            if all(c is None for c in cts):
                continue
            for key, ct in rec.transpose(cts):
                self.accum(key, ct)

    def grad(self, p: Var) -> Any:
        ct = self.ct.get(self.tan[p])
        return self.zeros(p.aval) if ct is None else ct


# -- JVP rules (each emits the primal equation and its residuals, records
# its linear equations, and returns the primal outputs) -----------------------

def _linear1(transpose: Callable) -> Callable:
    """A primitive linear in its one operand (or in operand 0): the
    tangent is the primitive of the tangent; ``transpose(tape, e, x,
    ct)`` gives the operand's cotangent."""
    def rule(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
        if any(lin[1:]):
            raise NotImplementedError(f"{e.prim} linear in operand > 0")
        outs = tape.copy(e, ins)
        x, out = ins[0], outs[0]
        kx, ko = tape.tan[x], tape.fresh(out)
        tape.linear.append(_Linear(
            [ko], lambda cts: [(kx, transpose(tape, e, x, cts[0]))]))
        return outs
    return rule


def _t_neg(tape, e, x, ct):
    return tape.emit("neg", [ct], x.aval)


def _t_convert(tape, e, x, ct):
    dt = x.aval.dtype
    return tape.emit("convert_element_type", [ct], Aval(_shape(ct), dt),
                     new_dtype=dt)


def _t_reduce_sum(tape, e, x, ct):
    axes = e.params["axes"]
    return tape.broadcast(ct, _shape(x), tuple(
        d for d in range(len(_shape(x))) if d not in axes))


def _expand_dims(tape, t, shape, dims):
    if not dims:
        return t
    return tape.broadcast(t, shape, tuple(d for d in range(len(shape))
                                         if d not in dims))


def _t_broadcast_in_dim(tape, e, x, ct):
    shape, bdims = e.params["shape"], e.params["broadcast_dimensions"]
    unit = [i for i, n in enumerate(_shape(x)) if n == 1]
    kept = [d for i, d in enumerate(bdims) if i not in unit]
    axes = tuple(d for d in range(len(shape)) if d not in kept)
    if not axes:
        raise NotImplementedError("transpose of a broadcast_in_dim that "
                                  "adds no axis")
    r = tape.emit("reduce_sum", [ct],
                  Aval(tuple(shape[d] for d in kept), ct.aval.dtype),
                  axes=axes)
    return _expand_dims(tape, r, _shape(x), unit)


def _t_squeeze(tape, e, x, ct):
    return _expand_dims(tape, ct, _shape(x), e.params["dimensions"])


def _t_slice(tape, e, x, ct):
    if e.params["strides"] is not None and set(e.params["strides"]) != {1}:
        raise NotImplementedError("transpose of a strided slice")
    config = tuple((lo, n - hi, 0) for lo, hi, n in zip(
        e.params["start_indices"], e.params["limit_indices"], _shape(x)))
    return tape.emit("pad", [ct, Literal(0.0, Aval((), ct.aval.dtype))],
                     x.aval, impl=_pad, padding_config=config)


def _reverse_cumsum(ct: torch.Tensor, *, axis: int) -> torch.Tensor:
    # ``cumsum[reverse=True]``: the transpose of a cumulative sum
    return torch.cumsum(ct.flip(axis), axis, dtype=ct.dtype).flip(axis)


def _t_cumsum(tape, e, x, ct):
    """``jnp.cumsum`` is linear: its transpose one ``jit cumsum`` of the
    cotangent, a ``cumsum[reverse=True]`` inside."""
    axis = e.impl.keywords["axis"]
    return tape.emit("jit", [ct], x.aval, functools.partial(
        _reverse_cumsum, axis=axis), "cumsum")


def _jvp_dynamic_slice(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
    """Linear in the operand (the starts are integers, with no tangent);
    the transpose writes the cotangent into zeros at the starts
    (``dynamic_update_slice``)."""
    if any(lin[1:]):
        raise NotImplementedError("dynamic_slice differentiated in a start")
    outs = tape.copy(e, ins)
    x, starts = ins[0], ins[1:]
    kx, ko = tape.tan[x], tape.fresh(outs[0])

    def transpose(cts):
        z = tape.zeros(x.aval)
        return [(kx, tape.emit("dynamic_update_slice", [z, cts[0], *starts],
                               x.aval, impl=_dynamic_update_slice))]
    tape.linear.append(_Linear([ko], transpose))
    return outs


def _jvp_add_sub(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
    """``add``: a tangent alone passes through (``_maybe_broadcast``);
    two make one linear ``add``.  ``sub``: alike, the right one alone
    negated (a linear ``neg``)."""
    outs = tape.copy(e, ins)
    (x, y), out = ins, outs[0]
    if lin[0] and lin[1]:
        kx, ky, ko = tape.tan[x], tape.tan[y], tape.fresh(out)

        def transpose(cts):
            ct = cts[0]
            cx = tape.unbroadcast(x.aval, ct)
            cy = (tape.emit("neg", [ct], ct.aval) if e.prim == "sub"
                  else ct)
            return [(kx, cx), (ky, tape.unbroadcast(y.aval, cy))]
        tape.linear.append(_Linear([ko], transpose))
        return outs
    z = x if lin[0] else y
    if _shape(z) != _shape(out):
        raise NotImplementedError(f"{e.prim} broadcasting one tangent")
    if e.prim == "sub" and lin[1]:
        kz, ko = tape.tan[z], tape.fresh(out)
        tape.linear.append(_Linear(
            [ko], lambda cts: [(kz, tape.emit("neg", [cts[0]], z.aval))]))
    else:
        tape.tan[out] = tape.tan[z]
    return outs


def _jvp_mul(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
    """``mul(ẋ, y)`` and ``mul(x, ẏ)``, summed by ``add_any`` when both
    are there; transposed right operand first."""
    outs = tape.copy(e, ins)
    (x, y), out = ins, outs[0]
    ko = tape.fresh(out)
    parts = [_Key() if l else None for l in lin]

    def t_left(cts):     # mul(ẋ, y) → mul(ct, y)
        return [(tape.tan[x], tape.unbroadcast(
            x.aval, tape.emit("mul", [cts[0], y], out.aval)))]

    def t_right(cts):    # mul(x, ẏ) → mul(x, ct)
        return [(tape.tan[y], tape.unbroadcast(
            y.aval, tape.emit("mul", [x, cts[0]], out.aval)))]

    if lin[0] and lin[1]:
        tape.linear.append(_Linear([parts[0]], t_left))
        tape.linear.append(_Linear([parts[1]], t_right))
        tape.linear.append(_Linear(
            [ko], lambda cts: [(parts[0], cts[0]), (parts[1], cts[0])]))
    else:
        tape.linear.append(_Linear([ko], t_left if lin[0] else t_right))
    return outs


def _jvp_div(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
    """``div(ẋ, y)``; a differentiated divisor adds
    ``mul(mul(neg(ẏ), x), integer_pow(y, -2))`` (its ``integer_pow`` in
    the forward) and an ``add_any``, transposed divisor first."""
    outs = tape.copy(e, ins)
    (x, y), out = ins, outs[0]
    ko = tape.fresh(out)
    if not lin[1]:
        kx = tape.tan[x]
        tape.linear.append(_Linear([ko], lambda cts: [(kx, tape.unbroadcast(
            x.aval, tape.emit("div", [cts[0], y], out.aval)))]))
        return outs
    ipow = tape.emit("integer_pow", [y], y.aval, impl=_integer_pow, y=-2)
    kx = _Key() if lin[0] else None
    kn, km, ky = _Key(), _Key(), (_Key() if lin[0] else ko)
    if lin[0]:
        tape.linear.append(_Linear([kx], lambda cts: [(
            tape.tan[x], tape.unbroadcast(x.aval, tape.emit(
                "div", [cts[0], y], out.aval)))]))
    tape.linear.append(_Linear([kn], lambda cts: [(
        tape.tan[y], tape.emit("neg", [cts[0]], y.aval))]))
    tape.linear.append(_Linear([km], lambda cts: [(
        kn, tape.unbroadcast(y.aval, tape.emit("mul", [cts[0], x],
                                               out.aval)))]))
    tape.linear.append(_Linear([ky], lambda cts: [(
        km, tape.emit("mul", [cts[0], ipow], out.aval))]))
    if lin[0]:
        tape.linear.append(_Linear(
            [ko], lambda cts: [(kx, cts[0]), (ky, cts[0])]))
    return outs


def _jvp_rsqrt(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
    """``mul(ẋ, mul(-0.5, div(ans, x)))``: the residual in the forward."""
    outs = tape.copy(e, ins)
    x, out = ins[0], outs[0]
    r = tape.emit("div", [out, x], x.aval)
    r = tape.emit("mul", [Literal(-0.5, Aval((), x.aval.dtype)), r], x.aval)
    kx, ko = tape.tan[x], tape.fresh(out)
    tape.linear.append(_Linear(
        [ko], lambda cts: [(kx, tape.emit("mul", [cts[0], r], x.aval))]))
    return outs


def _dot_dims(e: Eqn, a: Any, b: Any) -> tuple:
    """The ``dot_general`` dimension numbers of a lowered equation (an
    einsum's, or ``dimension_numbers``)."""
    if "dimension_numbers" in e.params:
        return e.params["dimension_numbers"]
    eq = getattr(e.impl, "keywords", {}).get("equation")
    if eq is None:
        if len(_shape(b)) != 2 or not _shape(a):
            raise NotImplementedError("dot_general of a matmul whose right "
                                      "operand is not 2-D")
        # ``x @ w``: x's last axis against w's first, as ``jnp.matmul``
        return ((len(_shape(a)) - 1,), (0,)), ((), ())
    lhs, rest = eq.replace(" ", "").split(",")
    rhs, out = rest.split("->")
    free = iter(c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ" if c not in eq)
    ell = "".join(next(free) for _ in range(max(
        len(_shape(a)) - len(lhs.replace("...", "")),
        len(_shape(b)) - len(rhs.replace("...", "")))))
    lhs, rhs, out = (s.replace("...", ell[len(ell) - (n - len(
        s.replace("...", ""))):] if "..." in s else "") for s, n in (
        (lhs, len(_shape(a))), (rhs, len(_shape(b))),
        (out, len(_shape(e.outvars[0])))))
    contract = [c for c in lhs if c in rhs and c not in out]
    batch = [c for c in lhs if c in rhs and c in out]
    std = batch + [c for c in lhs if c not in rhs] + [c for c in rhs
                                                      if c not in lhs]
    if "".join(std) != out:
        raise NotImplementedError(f"einsum {eq!r}: the output is not in "
                                  f"dot_general's order")
    return (([lhs.index(c) for c in contract], [rhs.index(c)
                                                for c in contract]),
            ([lhs.index(c) for c in batch], [rhs.index(c) for c in batch]))


def _dot_shape(a: tuple, b: tuple, dims: tuple) -> tuple:
    (ac, bc), (ab, bb) = dims
    return (tuple(a[i] for i in ab)
            + tuple(n for i, n in enumerate(a) if i not in (*ac, *ab))
            + tuple(n for j, n in enumerate(b) if j not in (*bc, *bb)))


def _ranges_like(*xs):
    start = 0
    for x in xs:
        yield list(range(start, start + len(x)))
        start += len(x)


def _dot_transpose_lhs(tape: _Tape, g: Any, x_aval: Aval, y: Any,
                       dims: tuple, swap_ans: bool = False) -> Var:
    """``jax._src.lax.lax._dot_general_transpose_lhs``."""
    (x_contract, y_contract), (x_batch, y_batch) = dims
    x_kept = [i for i in range(len(x_aval.shape))
              if i not in (*x_contract, *x_batch)]
    y_kept = [i for i in range(len(_shape(y)))
              if i not in (*y_contract, *y_batch)]
    if swap_ans:
        ans_batch, ans_y, _ = _ranges_like(x_batch, y_kept, x_kept)
    else:
        ans_batch, _, ans_y = _ranges_like(x_batch, x_kept, y_kept)
    new = ((tuple(ans_y), tuple(y_kept)), (tuple(ans_batch), tuple(y_batch)))
    shape = _dot_shape(_shape(g), _shape(y), new)
    out = tape.emit("dot_general", [g, y], Aval(shape, g.aval.dtype),
                    impl=_dot_general, dimension_numbers=new)
    x_contract_by_y = list(np.take(x_contract, np.argsort(y_contract)))
    perm = tuple(int(i) for i in np.argsort(list(x_batch) + x_kept
                                            + x_contract_by_y))
    if perm != tuple(range(len(perm))):
        out = tape.emit("transpose", [out], Aval(tuple(
            shape[i] for i in perm), out.aval.dtype), impl=_transpose,
            permutation=perm)
    return out


def _jvp_dot_general(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
    outs = tape.copy(e, ins)
    (x, y), out = ins, outs[0]
    dims = _dot_dims(e, x, y)
    (xc, yc), (xb, yb) = dims
    ko = tape.fresh(out)
    parts = [_Key() if l else None for l in lin]

    def t_left(cts):
        return [(tape.tan[x], _dot_transpose_lhs(tape, cts[0], x.aval, y,
                                                 dims))]

    def t_right(cts):
        return [(tape.tan[y], _dot_transpose_lhs(
            tape, cts[0], y.aval, x, ((yc, xc), (yb, xb)), swap_ans=True))]

    right = [x, tape.tan[y]] if lin[1] else None
    if lin[0] and lin[1]:
        tape.linear.append(_Linear([parts[0]], t_left))
        tape.linear.append(_Linear([parts[1]], t_right, ins=right))
        tape.linear.append(_Linear(
            [ko], lambda cts: [(parts[0], cts[0]), (parts[1], cts[0])]))
    else:
        tape.linear.append(_Linear([ko], t_left if lin[0] else t_right,
                                   ins=None if lin[0] else right))
    return outs


def _jvp_gather(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
    """Linear in the operand; the transpose scatters the cotangent's
    rows into zeros (``scatter-add``)."""
    if lin[1]:
        raise NotImplementedError("gather differentiated in its indices")
    outs = tape.copy(e, ins)
    (x, idx), out = ins, outs[0]
    kx, ko = tape.tan[x], tape.fresh(out)

    def transpose(cts):
        z = tape.zeros(x.aval)
        return [(kx, tape.emit("scatter-add", [z, idx, cts[0]], x.aval,
                               impl=_scatter_add))]
    tape.linear.append(_Linear([ko], transpose))
    return outs


def _jvp_jit(fwd: Callable, res_avals: Callable, vjp: Callable) -> Callable:
    """A jitted function differentiated in operand 0: one ``jit``
    equation of the output and the residuals (``fwd(e, *ins)``, the
    residuals' avals ``res_avals(e, *ins)``), transposed to one ``jit``
    equation of the residuals and the cotangent (``vjp(e, *ins)`` its
    implementation)."""
    def rule(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
        if any(lin[1:]):
            raise NotImplementedError(f"jit {e.name} differentiated in "
                                      f"operand > 0")
        x, out_aval = ins[0], e.outvars[0].aval
        out, *res = tape.emit_multi(
            "jit", ins, [out_aval, *res_avals(e, *ins)], fwd(e, *ins),
            e.name)
        kx, ko = tape.tan[x], tape.fresh(out)
        tape.linear.append(_Linear([ko], lambda cts: [(kx, tape.emit(
            "jit", [*res, cts[0]], x.aval, vjp(e, *ins), e.name))]))
        return [out]
    return rule


def _static(e: Eqn) -> dict:
    return dict(getattr(e.impl, "keywords", None) or {})


def _keep(aval: Aval, axes: tuple[int, ...]) -> Aval:
    return Aval(tuple(1 if i in axes else n for i, n in
                      enumerate(aval.shape)), aval.dtype)


_jvp_log_softmax = _jvp_jit(
    lambda e, x: functools.partial(_log_softmax_fwd, **_static(e)),
    lambda e, x: [x.aval, _keep(x.aval, (_static(e).get("dim", -1)
                                         % len(_shape(x)),))],
    lambda e, x: functools.partial(_log_softmax_vjp, **_static(e)))
_jvp_take_along_axis = _jvp_jit(
    lambda e, x, idx: functools.partial(_take_along_axis_fwd, e.impl),
    lambda e, x, idx: [Aval((*_shape(idx), 1), torch.int32)],
    lambda e, x, idx: functools.partial(_take_along_axis_vjp,
                                        n=_shape(x)[-1]))
_jvp_var = _jvp_jit(
    lambda e, x, c: functools.partial(_var_fwd, e.impl.func,
                                      **e.impl.keywords),
    lambda e, x, c: [x.aval, Aval((), x.aval.dtype), Aval((), torch.bool),
                     _keep(x.aval, e.impl.keywords["axes"])],
    lambda e, x, c: _var_vjp)


def _jvp_scan(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
    """A scan whose body is a lowered graph (``cdfg.scan``), partially
    evaluated as JAX does (:func:`_jvp_loop`); a ``scan`` leaf (a
    segment's repeats kept in one call) is not differentiated."""
    if getattr(e.impl, "func", None) is not _run_loop:
        raise NotImplementedError("a scan leaf differentiated: a grad leaf's "
                                  "segments scan their stacked leaves")
    return _jvp_loop(tape, e, ins, lin)


def _jvp_concatenate(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
    """Linear in every operand; the transpose is one ``split`` of the
    cotangent into the operands' pieces."""
    outs = tape.copy(e, ins)
    # an operand without a tangent gets a zero one (JAX's
    # ``linear_jvp`` instantiates it), a residual its transpose does not
    # read
    zeros = [tape.zeros(x.aval) for x, d in zip(ins, lin) if not d]
    ko = tape.fresh(outs[0])
    axis = e.params["dimension"]
    sizes = tuple(_shape(x)[axis] for x in ins)

    def transpose(cts):
        ct = cts[0]
        got = tape.emit_multi(
            "split", [ct], [Aval(_shape(x), ct.aval.dtype) for x in ins],
            functools.partial(_split, sizes=sizes, axis=axis),
            sizes=sizes, axis=axis)
        return [(tape.tan[x], g) for x, g, d in zip(ins, got, lin) if d]
    tape.linear.append(_Linear([ko], transpose, zeros))
    return outs


# -- layout ops ----------------------------------------------------------------

def _t_reshape(tape, e, x, ct):
    return tape.reshape(ct, _shape(x))


def _t_transpose(tape, e, x, ct):
    perm = tuple(int(i) for i in np.argsort(e.params["permutation"]))
    return tape.emit("transpose", [ct], x.aval, impl=_transpose,
                     permutation=perm)


def _jvp_split(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
    """Linear; the transpose is one ``concatenate`` of the pieces'
    cotangents (a zero piece instantiated)."""
    outs = tape.copy(e, ins)
    x, axis = ins[0], e.params["axis"]
    kx = tape.tan[x]

    def transpose(cts):
        parts = [tape.zeros(o.aval) if c is None else c
                 for c, o in zip(cts, outs)]
        return [(kx, tape.emit("concatenate", parts, x.aval,
                               impl=functools.partial(_concatenate,
                                                      dimension=axis),
                               dimension=axis))]
    tape.linear.append(_Linear([tape.fresh(o) for o in outs], transpose))
    return outs


# -- elementwise ---------------------------------------------------------------

def _ones_like(tape: _Tape, aval: Aval, c: float) -> Var:
    """``lax.full_like(x, c)``: a ``broadcast_in_dim`` of the literal."""
    return tape.broadcast(Literal(c, Aval((), aval.dtype)), aval.shape, ())


def _jvp_scaled(jac: Callable) -> Callable:
    """A primitive whose tangent is ``mul(ṫ, J)``, ``J`` made in the
    forward by ``jac(tape, e, ins, out)`` from the primal values: the
    transpose is ``mul(ct, J)``."""
    def rule(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
        if any(lin[1:]):
            raise NotImplementedError(f"{e.prim} differentiated in operand "
                                      f"> 0")
        outs = tape.copy(e, ins)
        x, out = ins[0], outs[0]
        j = jac(tape, e, ins, out)
        kx, ko = tape.tan[x], tape.fresh(out)
        tape.linear.append(_Linear([ko], lambda cts: [(kx, tape.unbroadcast(
            x.aval, tape.emit("mul", [cts[0], j], out.aval)))]))
        return outs
    return rule


def _logistic_jac(tape, e, ins, out):
    """``ans·(1 − ans)``."""
    one_minus = tape.emit("sub", [Literal(1.0, Aval((), out.aval.dtype)),
                                  out], out.aval)
    return tape.emit("mul", [out, one_minus], out.aval)


def _integer_pow_jac(tape, e, ins, out):
    """``y·x^(y−1)``."""
    x, y = ins[0], e.params["y"]
    p = tape.emit("integer_pow", [x], x.aval, impl=_integer_pow, y=y - 1)
    return tape.emit("mul", [Literal(float(y), Aval((), x.aval.dtype)), p],
                     x.aval)


def _square_jac(tape, e, ins, out):
    """``mul(2, x)``."""
    x = ins[0]
    return tape.emit("mul", [Literal(2.0, Aval((), x.aval.dtype)), x],
                     x.aval)


#: ``exp``: ``mul(ṫ, ans)``
_jvp_exp = _jvp_scaled(lambda tape, e, ins, out: out)


def _jvp_stop_gradient(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
    """``stop_gradient``: the output has no tangent."""
    return tape.copy(e, ins)


def _jvp_tanh(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
    """``mul(add(ṫ, mul(ṫ, ans)), sub(1, ans))``, as ``jax.lax``'s
    ``tanh`` rule (``sub(1, ans)`` in the forward); transposed, the
    cotangent times ``sub(1, ans)`` reaches ``ṫ`` directly and through
    ``mul(·, ans)``."""
    outs = tape.copy(e, ins)
    x, out = ins[0], outs[0]
    r = tape.emit("sub", [Literal(1.0, Aval((), out.aval.dtype)), out],
                  out.aval)
    kx, km, ka, ko = tape.tan[x], _Key(), _Key(), tape.fresh(out)
    tape.linear.append(_Linear([km], lambda cts: [(kx, tape.emit(
        "mul", [cts[0], out], out.aval))]))
    tape.linear.append(_Linear([ka], lambda cts: [(kx, cts[0]),
                                                  (km, cts[0])]))
    tape.linear.append(_Linear([ko], lambda cts: [(ka, tape.emit(
        "mul", [cts[0], r], out.aval))]))
    return outs


def _jvp_pow(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
    """``x ** y`` with a literal exponent (``mul(ṫ, mul(y, pow(x, sub(y,
    1))))``) or a literal base (``mul(ṫ, mul(log(x), ans))``, the base
    through ``_replace_zero``), as ``jax.lax``'s ``pow`` rules."""
    x, y = ins
    if lin[0] and isinstance(y, Literal):
        def jac(tape, e, ins, out):
            f = Aval((), out.aval.dtype)
            ym1 = tape.emit("sub", [Literal(y.val, f), Literal(1.0, f)], f)
            p = tape.emit("pow", [x, ym1], out.aval)
            return tape.emit("mul", [Literal(y.val, f), p], out.aval)
        return _jvp_scaled(jac)(tape, e, ins, lin)
    if lin[1] and isinstance(x, Literal):
        outs = tape.copy(e, ins)
        out = outs[0]
        f = Aval((), out.aval.dtype)
        zero = tape.emit("eq", [Literal(x.val, f), Literal(0.0, f)],
                         Aval((), torch.bool))
        base = tape.emit("select_n", [zero, Literal(x.val, f),
                                      Literal(1.0, f)], f)
        log = tape.emit("log", [base], f, impl=_log)
        j = tape.emit("mul", [log, out], out.aval)
        ky, ko = tape.tan[y], tape.fresh(out)
        tape.linear.append(_Linear([ko], lambda cts: [(ky, tape.unbroadcast(
            y.aval, tape.emit("mul", [cts[0], j], out.aval)))]))
        return outs
    raise NotImplementedError("pow of two differentiated operands")


def _log(x: Any) -> Any:
    return torch.log(x) if isinstance(x, torch.Tensor) else math.log(x)


def _balanced_eq(tape: _Tape, x: Any, z: Var, y: Any) -> Var:
    """``jax.lax``'s ``_balanced_eq(x, z, y)``: 1 where ``x`` is the
    extremum ``z`` (½ where ``y`` ties it), else 0."""
    b = Aval(_shape(z), torch.bool)
    eq_x = tape.emit("eq", [x, z], b)
    ones, zeros = _ones_like(tape, z.aval, 1.0), _ones_like(tape, z.aval, 0.0)
    num = tape.emit("select_n", [eq_x, zeros, ones], z.aval)
    eq_y = tape.emit("eq", [y, z], b)
    twos, ones = _ones_like(tape, z.aval, 2.0), _ones_like(tape, z.aval, 1.0)
    den = tape.emit("select_n", [eq_y, ones, twos], z.aval)
    return tape.emit("div", [num, den], z.aval)


def _jvp_max(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
    """``mul(ẋ, _balanced_eq(x, ans, y))`` and ``mul(ẏ, _balanced_eq(y,
    ans, x))``, summed by ``add_any`` when both are there."""
    outs = tape.copy(e, ins)
    (x, y), out = ins, outs[0]
    ko = tape.fresh(out)
    parts = []
    for k, (a, b) in enumerate(((x, y), (y, x))):
        if not lin[k]:
            continue
        w = _balanced_eq(tape, a, out, b)
        key = _Key() if all(lin) else ko
        tape.linear.append(_Linear([key], lambda cts, a=a, w=w: [(
            tape.tan[a], tape.unbroadcast(a.aval, tape.emit(
                "mul", [cts[0], w], out.aval)))]))
        parts.append(key)
    if all(lin):
        tape.linear.append(_Linear(
            [ko], lambda cts: [(parts[0], cts[0]), (parts[1], cts[0])]))
    return outs


def _jvp_reduce_max(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
    """``jax.lax``'s ``_reduce_chooser_jvp_rule``: the locations of the
    maximum (``eq`` of the operand and the reshaped answer, as floats)
    and their count in the forward; the tangent ``div(reduce_sum(mul(ṫ,
    locations)), count)``."""
    outs = tape.copy(e, ins)
    x, out = ins[0], outs[0]
    axes = e.params["axes"]
    keep = tuple(1 if d in axes else n for d, n in enumerate(_shape(x)))
    ans = tape.reshape(out, keep)
    where = tape.emit("eq", [x, ans], Aval(_shape(x), torch.bool))
    loc = tape.emit("convert_element_type", [where], x.aval,
                    new_dtype=x.aval.dtype)
    count = tape.emit("reduce_sum", [loc], out.aval, axes=axes)
    km, ks, ko = _Key(), _Key(), tape.fresh(out)
    tape.linear.append(_Linear([km], lambda cts: [(
        tape.tan[x], tape.emit("mul", [cts[0], loc], x.aval))]))
    tape.linear.append(_Linear([ks], lambda cts: [(
        km, _t_reduce_sum(tape, e, x, cts[0]))]))
    tape.linear.append(_Linear([ko], lambda cts: [(
        ks, tape.emit("div", [cts[0], count], out.aval))]))
    return outs


# -- gathers and scatters --------------------------------------------------------

def _take_last(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    # ``top_k``'s tangent: the gather of ``x`` at the (..., k, 1) indices
    # along the last axis, batched over the others
    return x.gather(-1, indices[..., 0].long())


def _scatter_add_last(operand: torch.Tensor, indices: torch.Tensor,
                      updates: torch.Tensor) -> torch.Tensor:
    # its transpose: the scatter-add of ``updates`` into ``operand``
    return operand.scatter_add(-1, indices[..., 0].long(), updates)


def _gather_fill(operand: torch.Tensor, indices: torch.Tensor, *,
                 slice_sizes: tuple[int, ...]) -> torch.Tensor:
    # the transpose of a dropping scatter-add (at_add): the rows at the
    # (N, 1) indices, a row out of range read as zeros (FILL_OR_DROP)
    n = operand.shape[0]
    rows = indices[..., 0]
    hit = (rows >= 0) & (rows < n)
    out = operand.index_select(0, rows.clamp(0, n - 1).reshape(-1).long())
    out = out.reshape(rows.shape + operand.shape[1:])
    return out * hit.reshape(hit.shape + (1,) * (out.ndim - hit.ndim)).to(
        out.dtype)


def _jvp_top_k(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
    """The values' tangent is a ``gather`` of the tangent at the indices
    (made ``(…, k, 1)`` by a ``reshape`` in the forward); its transpose a
    ``scatter-add`` into zeros."""
    outs = tape.copy(e, ins)
    x, (vals, idx) = ins[0], outs
    at = tape.reshape(idx, (*_shape(idx), 1))
    kx, ko = tape.tan[x], tape.fresh(vals)

    def transpose(cts):
        z = tape.zeros(x.aval)
        return [(kx, tape.emit("scatter-add", [z, at, cts[0]], x.aval,
                               impl=_scatter_add_last))]
    tape.linear.append(_Linear([ko], transpose))
    return outs


def _jvp_scatter_add(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
    """``scatter-add(ẋ, idx, u̇)``, an operand or updates without a
    tangent instantiated as zeros in the forward; transposed, the
    operand's cotangent is the cotangent, the updates' a ``gather`` of
    it at the indices."""
    if lin[1]:
        raise NotImplementedError("scatter-add differentiated in its "
                                  "indices")
    outs = tape.copy(e, ins)
    (x, idx, upd), out = ins, outs[0]
    zeros = [tape.zeros(v.aval) for v, l in ((x, lin[0]), (upd, lin[2]))
             if not l]
    ko = tape.fresh(out)

    def transpose(cts):
        got = []
        if lin[0]:
            got.append((tape.tan[x], cts[0]))
        if lin[2]:
            got.append((tape.tan[upd], tape.emit(
                "gather", [cts[0], idx], upd.aval, impl=_gather_fill,
                slice_sizes=(1, *_shape(x)[1:]))))
        return got
    tape.linear.append(_Linear([ko], transpose, zeros))
    return outs


# -- jitted functions: the forward with its residuals, one transpose ----------

def _silu_fwd(x: torch.Tensor, **_: Any) -> tuple:
    s = torch.sigmoid(x)
    return x * s, s * (1 - s), s


def _silu_vjp(ds: torch.Tensor, s: torch.Tensor, x: torch.Tensor,
              ct: torch.Tensor) -> torch.Tensor:
    return ct * s + x * ct * ds


def _silu_vjp_remat(ds: torch.Tensor, x: torch.Tensor, s: torch.Tensor,
                    ct: torch.Tensor) -> torch.Tensor:
    return _silu_vjp(ds, s, x, ct)


def _jvp_silu(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
    """``jax.nn.silu``: one ``jit`` of the output and two residuals
    (``s·(1−s)`` and ``s``, ``s`` the logistic); the transpose one ``jit``
    of them, the operand and the cotangent."""
    x, out_aval = ins[0], e.outvars[0].aval
    out, *res = tape.emit_multi("jit", ins, [out_aval] * 3, _silu_fwd,
                                e.name)
    kx, ko = tape.tan[x], tape.fresh(out)
    # the residuals in the order JAX's linearization reads them, or (a body
    # under ``jax.checkpoint``) its JVP partially evaluated
    ops = [res[0], x, res[1]] if tape.remat else [*res, x]
    vjp = _silu_vjp_remat if tape.remat else _silu_vjp
    tape.linear.append(_Linear([ko], lambda cts: [(kx, tape.emit(
        "jit", [*ops, cts[0]], x.aval, vjp, e.name))]))
    return [out]


def _jvp_relu(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
    """``jax.nn.relu``'s ``custom_jvp``: ``select_n(gt(x, 0), zeros,
    ṫ)``, the predicate and the zero tangent made in the forward (the
    zero a residual its transpose does not read); transposed, a
    ``select_n`` of the predicate, fresh zeros and the cotangent."""
    outs = tape.copy(e, ins)
    x, out = ins[0], outs[0]
    f = Aval((), x.aval.dtype)
    pred = tape.emit("gt", [x, Literal(0.0, f)], Aval(_shape(x), torch.bool))
    zero = tape.zeros(x.aval)
    kx, ko = tape.tan[x], tape.fresh(out)
    tape.linear.append(_Linear([ko], lambda cts: [(kx, tape.emit(
        "select_n", [pred, tape.zeros(x.aval), cts[0]], x.aval))], [zero]))
    return outs


def _replace_inf(x: Any, zeros: Any) -> Any:
    # ``jax._src.lax.other._replace_inf``: ``x`` with ``+inf`` replaced
    # by the zeros
    return torch.where(x == math.inf, zeros, x)


def _softplus_loop(x: torch.Tensor, q: torch.Tensor, r: torch.Tensor,
                   s: torch.Tensor, t: torch.Tensor) -> tuple:
    """``jax.nn.softplus``'s forward with its residuals, given the part
    that reads no operand (:func:`_softplus_consts`): ``logaddexp(x,
    0)``, the tangent's factor ``exp(x − ans)`` and the zero tangent of
    the ``0`` times its own factor (each ``_replace_inf``'d as
    ``logaddexp``'s ``custom_jvp`` does)."""
    ans = _softplus(x)
    y = torch.exp(_replace_inf(x, q) - _replace_inf(ans, r))
    return ans, y, 0.0 * torch.exp(s - _replace_inf(ans, t))


def _softplus_consts(*, shape: tuple[int, ...], dtype: torch.dtype
                     ) -> tuple:
    """The part of :func:`_softplus_loop` that reads no operand: three
    zeros of the operand's shape and the ``0`` with ``+inf`` replaced."""
    dev = get_device(None)
    z = torch.zeros(shape, dtype=dtype, device=dev)
    return z, z, torch.zeros((), dtype=dtype, device=dev), z


def _softplus_fwd(x: torch.Tensor) -> tuple:
    return _softplus_loop(x, *_softplus_consts(shape=tuple(x.shape),
                                               dtype=x.dtype))


def _softplus_vjp(y: torch.Tensor, z: torch.Tensor, ct: torch.Tensor
                  ) -> torch.Tensor:
    return ct * y


#: ``jax.nn.softplus`` (``logaddexp(x, 0)``, through ``logaddexp``'s
#: ``custom_jvp``): one ``jit`` of the output and two residuals
#: (:func:`_softplus_loop`); the transpose one ``jit`` of them and the
#: cotangent, ``ct·exp(x − ans)``
_jvp_softplus = _jvp_jit(lambda e, x: _softplus_fwd,
                         lambda e, x: [x.aval, x.aval],
                         lambda e, x: _softplus_vjp)


def _softmax_vjp(y: torch.Tensor, ct: torch.Tensor, *, dim: int = -1
                 ) -> torch.Tensor:
    return y * (ct - (ct * y).sum(dim, keepdim=True))


def _jvp_softmax(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
    """``softmax``: the output is the residual; the transpose one ``jit``
    of it and the cotangent, ``y·(ct − Σ ct·y)``."""
    outs = tape.copy(e, ins)
    x, out = ins[0], outs[0]
    kx, ko = tape.tan[x], tape.fresh(out)
    tape.linear.append(_Linear([ko], lambda cts: [(kx, tape.emit(
        "jit", [out, cts[0]], x.aval,
        functools.partial(_softmax_vjp, **_static(e)), e.name))]))
    return outs


def _pad_fwd(x: torch.Tensor, value: Any, *, pads: tuple[int, ...]
             ) -> tuple:
    return (torch.nn.functional.pad(x, pads, value=float(value)),
            torch.tensor(value, dtype=x.dtype, device=x.device))


def _pad_vjp(value: torch.Tensor, ct: torch.Tensor, *,
             pads: tuple[int, ...]) -> torch.Tensor:
    for k in range(len(pads) // 2):
        d, lo, hi = ct.ndim - 1 - k, pads[2 * k], pads[2 * k + 1]
        ct = ct.narrow(d, lo, ct.shape[d] - lo - hi)
    return ct


_jvp_pad_linearized = _jvp_jit(
    lambda e, x, v: functools.partial(_pad_fwd, **e.impl.keywords),
    lambda e, x, v: [Aval((), x.aval.dtype)],
    lambda e, x, v: functools.partial(_pad_vjp, **e.impl.keywords))


def _pad_ct(ct: torch.Tensor, *, pads: tuple[int, ...]) -> torch.Tensor:
    return _pad_vjp(None, ct, pads=pads)


def _jvp_pad(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
    """``jnp.pad``: its linearization keeps the tangent's padding value
    (a zero) as a residual; in a body under ``jax.checkpoint`` (JVP, then
    partial evaluation) that value is a literal of the tangent ``jit``,
    so the forward is the primal ``jit`` and the transpose one ``jit`` of
    the cotangent alone."""
    if not tape.remat:
        return _jvp_pad_linearized(tape, e, ins, lin)
    if any(lin[1:]):
        raise NotImplementedError("jit _pad differentiated in its value")
    outs = tape.copy(e, ins)
    x, kx, ko = ins[0], tape.tan[ins[0]], tape.fresh(outs[0])
    tape.linear.append(_Linear([ko], lambda cts: [(kx, tape.emit(
        "jit", [cts[0]], x.aval, functools.partial(
            _pad_ct, **e.impl.keywords), e.name))]))
    return outs


def _where_fwd(c: torch.Tensor, x: Any, y: Any, *, shape: tuple[int, ...],
               cb: bool, zeros: bool) -> tuple:
    """``jnp.where``'s forward with its residuals: the predicate
    broadcast to the output (when it is not), a zero tangent (when a
    branch has none)."""
    out = torch.where(c, x, y)
    res = [c.expand(shape)] if cb else []
    res += [torch.zeros_like(out)] if zeros else []
    return (out, *res) if res else out


def _where_vjp(*args: Any, which: tuple[bool, bool]) -> Any:
    cb, ct = args[0], args[-1]
    got = [torch.where(cb, ct, 0), torch.where(cb, 0, ct)]
    got = [g for g, w in zip(got, which) if w]
    return got[0] if len(got) == 1 else tuple(got)


def _jvp_where(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
    """``jnp.where(c, x, y)``: one ``jit`` of the output and its residuals
    (:func:`_where_fwd`); the transpose one ``jit`` of them and the
    cotangent, giving the differentiated branches' cotangents."""
    (c, x, y), out_aval = ins, e.outvars[0].aval
    if lin[0] or any(l and _shape(v) != out_aval.shape
                     for v, l in zip(ins, lin)):
        raise NotImplementedError("jnp.where differentiated in its "
                                  "predicate or a broadcast branch")
    shape = out_aval.shape
    cb, zeros = _shape(c) != shape, not (lin[1] and lin[2])
    avals = [out_aval] + ([Aval(shape, torch.bool)] if cb else []) + (
        [out_aval] if zeros else [])
    out, *res = tape.emit_multi(
        "jit", ins, avals, functools.partial(_where_fwd, shape=shape, cb=cb,
                                             zeros=zeros), e.name)
    reads = res if cb else [c, *res]
    which = (lin[1], lin[2])
    ko = tape.fresh(out)

    def transpose(cts):
        branches = [v for v, w in zip((x, y), which) if w]
        got = tape.emit_multi("jit", [*reads, cts[0]],
                              [v.aval for v in branches],
                              functools.partial(_where_vjp, which=which),
                              e.name)
        return [(tape.tan[v], g) for v, g in zip(branches, got)]
    tape.linear.append(_Linear([ko], transpose, ins=[
        tape.tan[v] for v, w in zip((x, y), which) if w] + reads))
    return [out]


def _split_where(e: Eqn, known: list[bool]) -> tuple | None:
    """A scan body's forward ``jnp.where`` (:func:`_jvp_where`) split as
    JAX's partial evaluation splits a ``jit``, or ``None`` where it does
    not split so:

    * one branch known, the predicate not: a ``jit`` of that branch
      gives the zero tangent and the branch broadcast; the rest keeps a
      ``jit`` of the predicate, the other branch and that broadcast;
    * the predicate known: a ``jit`` of the predicate (and a known
      branch) gives the predicate broadcast (when it is a residual); the
      rest keeps a ``jit`` selecting by it;
    * the predicate broadcast alone (the part above), its predicate
      unknown: a ``jit`` of the known branch gives nothing.

    A ``jnp.where`` of the primal alone (``_where``, in a body under
    ``jax.checkpoint``) splits the same way, with no zero tangent: the
    known part gives the known predicate and branches broadcast where
    they are not yet of the output's shape (nothing when they are)."""
    if e.impl is _where or getattr(e.impl, "func", None) is _where_at:
        return _split_primal_where(e, known)
    kw = e.impl.keywords
    out, *res = e.outvars
    if e.impl.func is _where_known:
        if known[0] or not all(known[1:]):
            return None
        cb = e.outvars[:1] if kw["cb"] else []
        return (Eqn("jit", e.invars[1:], e.outvars[len(cb):], {},
                    functools.partial(_where_known_branches, **{
                        k: kw[k] for k in ("shape", "dtype", "zeros",
                                           "bcast")}),
                    e.source, e.name),
                Eqn("jit", e.invars[:1], cb, {},
                    functools.partial(_where_mask, shape=kw["shape"])
                    if cb else _nothing, e.source, e.name))
    if e.impl.func is not _where_fwd:
        return None
    if known[0]:
        shape = kw["shape"]
        k = [j for j in (1, 2) if known[j]]
        made = (res[:1] if kw["cb"] else []) + (res[-1:] if kw["zeros"]
                                                 else [])
        ins = list(e.invars)
        if kw["cb"]:
            ins[0] = res[0]
        for j in k:         # a known branch not yet of the output's shape
            if _shape(e.invars[j]) != shape:
                ins[j] = Var(out.aval, f"{out.name}.b{j}")
                made.append(ins[j])
        return (Eqn("jit", [e.invars[0], *(e.invars[j] for j in k)], made,
                    {}, functools.partial(
                        _where_known, shape=shape, dtype=out.aval.dtype,
                        cb=kw["cb"], zeros=kw["zeros"],
                        bcast=tuple(_shape(e.invars[j]) != shape
                                    for j in k)),
                    e.source, e.name),
                _where_rest(e, ins, known))
    if not kw["zeros"] or known[1] == known[2]:
        return None
    k = 1 if known[1] else 2
    zeros = res[-1]
    bcast = Var(out.aval, f"{out.name}.b")
    hoisted = Eqn("jit", [e.invars[k]], [zeros, bcast], {},
                  functools.partial(_where_known_branches, shape=kw["shape"],
                                    dtype=out.aval.dtype, zeros=True,
                                    bcast=(True,)), e.source, e.name)
    ins = list(e.invars)
    ins[k] = bcast
    loop = Eqn("jit", ins, [out, *res[:-1]], {},
               functools.partial(_where_fwd, shape=kw["shape"], cb=kw["cb"],
                                 zeros=False), e.source, e.name)
    return hoisted, loop


def _where_at(*args: Any, at: tuple[int, int, int]) -> torch.Tensor:
    """``jnp.where`` whose predicate and branches are the operands at
    ``at``: the part of a split ``jnp.where`` that reads an unknown
    operand."""
    c, x, y = (args[i] for i in at)
    return torch.where(c, x, y)


def _where_rest(e: Eqn, ins: list, known: list[bool]) -> Eqn:
    """The part of a split ``jnp.where`` (predicate and branches ``ins``)
    that reads an unknown operand, as JAX's partial evaluation of a
    ``jit`` stages it: the unknown operands first, then the residuals —
    the predicate, the second branch, the first, as ``select_n`` reads
    them."""
    order = [j for j in range(3) if not known[j]] + [
        j for j in (0, 2, 1) if known[j]]
    return Eqn("jit", [ins[j] for j in order], e.outvars[:1], {},
               functools.partial(_where_at, at=tuple(
                   order.index(j) for j in range(3))), e.source, e.name)


def _split_primal_where(e: Eqn, known: list[bool]) -> tuple | None:
    """:func:`_split_where` of a ``jnp.where`` of the primal alone
    (``_where``, or the rest :func:`_where_rest` left)."""
    at = getattr(e.impl, "keywords", {}).get("at", (0, 1, 2))
    roles, role_known = [e.invars[i] for i in at], [known[i] for i in at]
    if all(role_known) or not any(role_known):
        return None
    out = e.outvars[0]
    shape = out.aval.shape
    ins, made = list(roles), []
    for j in range(3):
        if role_known[j] and _shape(roles[j]) != shape:
            ins[j] = Var(Aval(shape, torch.bool if j == 0 else out.aval.dtype),
                         f"{out.name}.b{j}")
            made.append(ins[j])
    k = [j for j in (1, 2) if role_known[j]]
    bcast = tuple(_shape(roles[j]) != shape for j in k)
    kin = [v for v, kn in zip(e.invars, known) if kn]
    if not made:
        impl = _nothing
    elif kin != [roles[j] for j in range(3) if role_known[j]]:
        raise NotImplementedError("a split jnp.where broadcasting operands "
                                  "out of order")
    elif role_known[0]:
        impl = functools.partial(_where_known, shape=shape,
                                 dtype=out.aval.dtype,
                                 cb=_shape(roles[0]) != shape, zeros=False,
                                 bcast=bcast)
    else:
        impl = functools.partial(_where_known_branches, shape=shape,
                                 dtype=out.aval.dtype, zeros=False,
                                 bcast=bcast)
    return (Eqn("jit", kin, made, {}, impl, e.source, e.name),
            _where_rest(e, ins, role_known))


def _where_branches(*branches: Any, shape: tuple[int, ...],
                    dtype: torch.dtype, zeros: bool,
                    bcast: tuple[bool, ...]) -> list:
    """The part of a ``jnp.where``'s forward that its known branches
    alone determine: the zero tangent, and each known branch not yet of
    the output's shape broadcast to it."""
    dev = next((v.device for v in branches if isinstance(v, torch.Tensor)),
               None) or get_device(None)
    out = [torch.zeros(shape, dtype=dtype, device=dev)] if zeros else []
    for v, b in zip(branches, bcast):
        if b:
            out.append(torch.full(shape, v, dtype=dtype, device=dev)
                       if not isinstance(v, torch.Tensor)
                       else v.to(dtype).expand(shape))
    return out


def _one_or_tuple(out: list) -> Any:
    return out[0] if len(out) == 1 else tuple(out)


def _where_known(c: torch.Tensor, *branches: Any, shape: tuple[int, ...],
                 dtype: torch.dtype, cb: bool, zeros: bool,
                 bcast: tuple[bool, ...]) -> Any:
    """The part of a ``jnp.where``'s forward (:func:`_where_fwd`) that a
    known predicate and known branches determine: the predicate
    broadcast (a residual), then :func:`_where_branches`."""
    return _one_or_tuple(([c.expand(shape)] if cb else []) + _where_branches(
        *branches, shape=shape, dtype=dtype, zeros=zeros, bcast=bcast))


def _where_known_branches(*branches: Any, **kw: Any) -> Any:
    return _one_or_tuple(_where_branches(*branches, **kw))


def _where_mask(c: torch.Tensor, *, shape: tuple[int, ...]
                ) -> torch.Tensor:
    """The predicate of a ``jnp.where`` broadcast to its output."""
    return c.expand(shape)


def _split_var(e: Eqn, known: list[bool]) -> tuple | None:
    """``jnp.var``'s forward (:func:`_var_fwd`) on an unknown operand: a
    ``jit`` of the correction gives the count, whether it is positive,
    the zero tangent and the ``nan`` broadcast (:func:`_var_consts`); the
    rest keeps a ``jit`` of the operand and those (:func:`_var_loop`)."""
    if known[0] or not known[1] or getattr(e.impl, "func", None) \
            is not _var_fwd:
        return None
    var, centered, n, ok, zeros = e.outvars
    axes = e.impl.keywords["axes"]
    shape = e.invars[0].aval.shape
    nan = Var(var.aval, f"{var.name}.nan")
    count = int(np.prod([shape[a] for a in axes]))
    return (Eqn("jit", e.invars[1:], [n, ok, zeros, nan], {},
                functools.partial(_var_consts, count=count,
                                  shape=var.aval.shape, dtype=var.aval.dtype),
                e.source, e.name),
            Eqn("jit", [e.invars[0], n, ok, nan], [var, centered], {},
                functools.partial(_var_loop, axes=axes), e.source, e.name))


def _one_hot_classes(*, num_classes: int, ndim: int) -> torch.Tensor:
    return torch.arange(num_classes, dtype=torch.int32,
                        device=get_device(None)).reshape(
        (1,) * ndim + (num_classes,))


def _one_hot_of(x: torch.Tensor, classes: torch.Tensor) -> torch.Tensor:
    return (x[..., None] == classes).to(torch.int32)


def _split_one_hot(e: Eqn, known: list[bool]) -> tuple | None:
    """``jax.nn.one_hot`` of an unknown operand: a ``jit`` of nothing
    gives the classes (``iota``, shaped to broadcast); the rest keeps a
    ``jit`` comparing the operand with them."""
    if any(known):
        return None
    n = e.impl.keywords["num_classes"]
    nd = len(_shape(e.invars[0]))
    classes = Var(Aval((1,) * nd + (n,), torch.int32),
                  f"{e.outvars[0].name}.classes")
    return (Eqn("jit", [], [classes], {},
                functools.partial(_one_hot_classes, num_classes=n, ndim=nd),
                e.source, e.name),
            Eqn("jit", [e.invars[0], classes], e.outvars, {}, _one_hot_of,
                e.source, e.name))


def _dce(eqns: list[Eqn], needed: list[Any]) -> list[Eqn]:
    """``eqns`` less those none of whose outputs ``needed`` (or a kept
    equation) reads; a kept ``closed_call`` less its unread outputs and
    what only they need (:func:`_dce_call`)."""
    live = {v for v in needed if isinstance(v, Var)}
    kept = []
    for e in reversed(eqns):
        if any(o in live for o in e.outvars):
            if e.prim == "closed_call":
                e = _dce_call(e, [o in live for o in e.outvars])
            kept.append(e)
            live.update(v for v in e.invars if isinstance(v, Var))
    return kept[::-1]


def _dce_call(e: Eqn, used: list[bool]) -> Eqn:
    """JAX's dead-code elimination of a ``closed_call``: the outputs
    nothing reads go, its body is cut to what the rest need (a scan in
    it by :func:`_dce_loop`), and the operands the body no longer reads
    go."""
    g = e.params["call_jaxpr"]
    outs = [v for v, u in zip(g.outvars, used) if u]
    live = {v for v in outs if isinstance(v, Var)}
    kept = []
    for q in reversed(g.eqns):
        u = [o in live for o in q.outvars]
        if not any(u):
            continue
        if q.prim == "scan" and getattr(q.impl, "func", None) is _run_loop:
            q = _dce_loop(q, u)
        kept.append(q)
        live.update(v for v in q.invars if isinstance(v, Var))
    kept.reverse()
    ins = [v in live for v in g.invars]
    return Eqn("closed_call", [v for v, i in zip(e.invars, ins) if i],
               [o for o, u in zip(e.outvars, used) if u],
               {"call_jaxpr": Graph(kept, [v for v, i in zip(g.invars, ins)
                                           if i], outs, [], [], "")},
               e.impl, e.source)


def _dce_loop(e: Eqn, used: list[bool]) -> Eqn:
    """JAX's dead-code elimination of a scan of a lowered body: a carry
    kept while its output or the body's other kept outputs need it (a
    fixpoint), an unread ``ys`` output gone, then the consts and scanned
    inputs the body no longer reads."""
    body, n_c, n_k = e.impl.args
    u_k, u_y = list(used[:n_k]), list(used[n_k:])
    while True:
        keep = _dce(body.eqns, [v for v, u in zip(body.outvars, u_k + u_y)
                                if u])
        live = {v for q in keep for v in q.invars if isinstance(v, Var)}
        live.update(v for v, u in zip(body.outvars, u_k + u_y)
                    if u and isinstance(v, Var))
        new = [a or v in live for a, v in zip(u_k, body.invars[n_c:n_c + n_k])]
        if new == u_k:
            break
        u_k = new
    ins = [v in live for v in body.invars[:n_c]] + u_k + [
        v in live for v in body.invars[n_c + n_k:]]
    outs = u_k + u_y
    graph = Graph(keep, [v for v, i in zip(body.invars, ins) if i],
                  [v for v, o in zip(body.outvars, outs) if o], [], [], "")
    return Eqn("scan", [v for v, i in zip(e.invars, ins) if i],
               [v for v, o in zip(e.outvars, outs) if o], {},
               functools.partial(_run_loop, graph, sum(ins[:n_c]), sum(u_k),
                                 **e.impl.keywords), e.source)


def _pad_value(value: Any, *, dtype: torch.dtype) -> tuple:
    dev = get_device(None)
    return (torch.zeros((), dtype=dtype, device=dev),
            torch.tensor(value, dtype=dtype, device=dev))


def _split_pad(e: Eqn, known: list[bool]) -> tuple | None:
    """``jnp.pad``'s forward (:func:`_pad_fwd`) of an unknown operand: a
    ``jit`` of the padding value gives the tangent's (zero) padding value
    (the transpose's residual) and the value in the operand's dtype; the
    rest keeps a ``jit`` padding the operand with it."""
    if getattr(e.impl, "func", None) is _pad_jit:
        return _split_primal_pad(e, known)
    if known[0] or not known[1] or getattr(e.impl, "func", None) \
            is not _pad_fwd:
        return None
    out, res = e.outvars
    value = Var(res.aval, f"{res.name}.v")
    return (Eqn("jit", e.invars[1:], [res, value], {},
                functools.partial(_pad_value, dtype=res.aval.dtype),
                e.source, e.name),
            Eqn("jit", [e.invars[0], value], [out], {},
                functools.partial(_pad_jit, **e.impl.keywords), e.source,
                e.name))


def _split_primal_pad(e: Eqn, known: list[bool]) -> tuple | None:
    """``jnp.pad``'s primal (``_pad_jit``, in a body under
    ``jax.checkpoint``) of an unknown operand: a ``jit`` of the padding
    value gives it in the operand's dtype; the rest keeps a ``jit``
    padding the operand with it."""
    if known[0] or not known[1]:
        return None
    out = e.outvars[0]
    value = Var(Aval((), out.aval.dtype), f"{out.name}.v")
    return (Eqn("jit", e.invars[1:], [value], {}, functools.partial(
                _pad_value1, dtype=out.aval.dtype), e.source, e.name),
            Eqn("jit", [e.invars[0], value], [out], {}, e.impl, e.source,
                e.name))


def _pad_value1(value: Any, *, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype, device=get_device(None))


def _nothing(*_: Any) -> tuple:
    return ()


def _split_softplus(e: Eqn, known: list[bool]) -> tuple | None:
    """``jax.nn.softplus``'s forward (:func:`_softplus_fwd`) of an
    unknown operand: a ``jit`` of nothing gives what reads no operand
    (:func:`_softplus_consts`); the rest keeps a ``jit`` of the operand
    and those (:func:`_softplus_loop`)."""
    if known[0] or e.impl is not _softplus_fwd:
        return None
    out = e.outvars[0]
    consts = [Var(a, f"{out.name}.c{i}") for i, a in enumerate(
        (out.aval, out.aval, Aval((), out.aval.dtype), out.aval))]
    return (Eqn("jit", [], consts, {}, functools.partial(
                _softplus_consts, shape=out.aval.shape,
                dtype=out.aval.dtype), e.source, e.name),
            Eqn("jit", [e.invars[0], *consts], e.outvars, {},
                _softplus_loop, e.source, e.name))


#: ``jit`` name -> its split (:func:`_split_jit`)
_JIT_SPLITS: dict[str, Callable] = {
    "_where": _split_where, "_var": _split_var, "_one_hot": _split_one_hot,
    "_pad": _split_pad, "softplus": _split_softplus,
}


def _split_jit(e: Eqn, known: list[bool]) -> tuple[Eqn, Eqn]:
    """A ``jit`` equation not all of whose operands are known, split as
    JAX's partial evaluation of a ``jit`` splits it: a ``jit`` of the
    known operands giving what they alone determine — emitted even with
    no output, as JAX emits it — and a ``jit`` of the rest."""
    split = _JIT_SPLITS.get(e.name)
    got = split(e, known) if split is not None else None
    if got is not None:
        return got
    if not any(known):
        return Eqn("jit", [], [], {}, _nothing, e.source, e.name), e
    raise NotImplementedError(
        f"no partial evaluation of jit {e.name!r} on its known operands "
        f"{known} yet (core/autodiff.py)")


def _partial_eval(eqns: list[Eqn], known: set) -> tuple[list, list]:
    """``eqns`` split as JAX's partial evaluation splits a jaxpr whose
    inputs in ``known`` are known: the equations that read only known
    values (and literals), in order, and the rest.  A ``jit`` that reads
    both is split (:func:`_split_jit`), a ``scan`` whose body is a
    lowered graph too (:func:`_split_loop`).  ``known`` gains every
    known value."""
    kn, un = [], []
    for e in eqns:
        mask = [isinstance(v, Literal) or v in known for v in e.invars]
        if all(mask):
            kn.append(e)
            known.update(e.outvars)
            continue
        if e.prim == "jit":
            k, e = _split_jit(e, mask)
            kn.append(k)
            known.update(k.outvars)
        elif e.prim == "closed_call":
            k, e = _split_call(e, mask)
            kn.append(k)
            known.update(k.outvars)
        elif e.prim == "scan" and getattr(e.impl, "func", None) is _run_loop:
            ks, e = _split_loop(e, mask)
            kn.extend(ks)
            for k in ks:
                known.update(k.outvars)
            if e is None:
                continue
        un.append(e)
    return kn, un


def _split_loop(e: Eqn, mask: list[bool]) -> tuple[list[Eqn], Eqn | None]:
    """A ``scan`` of a lowered body some of whose operands are known,
    split as JAX's ``_scan_partial_eval`` splits it: the carries that
    stay known found by a fixpoint; the body partially evaluated
    (:func:`_partial_eval`); the known part one ``scan`` (when it has an
    output) of the known consts, carries and scanned inputs, whose
    outputs are the known carries and ``ys`` and the residuals the rest
    reads, stacked — itself hoisted first, its equations that read only
    its consts emitted ahead of it; the rest one ``scan`` of the
    residuals that do not vary (hoisted, or a known const) as consts,
    the unknown consts, the unknown carries, the unknown scanned inputs
    and the stacked residuals (a known scanned input forwarded).
    Returns the equations of this level (the hoisted ones, the known
    scan) and the unknown scan (``None`` when nothing is unknown)."""
    body, n_c, n_k = e.impl.args
    reverse = e.impl.keywords.get("reverse", False)
    ins, outs = e.invars, e.outvars
    c_kn, x_kn = mask[:n_c], mask[n_c + n_k:]
    k_kn = list(mask[n_c:n_c + n_k])
    for _ in range(n_k + 1):
        known = {v for v, m in zip(body.invars, c_kn + k_kn + x_kn) if m}
        kn, un = _partial_eval(body.eqns, known)
        o_kn = [isinstance(v, Literal) or v in known for v in body.outvars]
        new = [a and b for a, b in zip(k_kn, o_kn)]
        if new == k_kn:
            break
        k_kn = new
    o_kn = k_kn + o_kn[n_k:]
    b_c, b_k = body.invars[:n_c], body.invars[n_c:n_c + n_k]
    b_x = body.invars[n_c + n_k:]
    outer = dict(zip(body.invars, ins))

    # the residuals: the known values the rest reads, in order
    res: dict[Var, None] = {}
    for q in un:
        res.update((v, None) for v in q.invars
                   if isinstance(v, Var) and v in known)
    res.update((v, None) for v, k in zip(body.outvars, o_kn)
               if not k and isinstance(v, Var) and v in known)

    # the known part, hoisted (JAX's ``_scan_known_hoisting``)
    inv = {v for v, m in zip(b_c, c_kn) if m}
    hoisted, kloop = _partial_eval(kn, inv)
    here = [dataclasses.replace(q, invars=[
        outer.get(v, v) if isinstance(v, Var) else v for v in q.invars])
        for q in hoisted]
    fwd_c = [v for v in res if v in b_c]
    fwd_x = [v for v in res if v in b_x]
    int_res = [v for v in res if v in inv and v not in b_c] + fwd_c
    ext = [v for v in res if v not in inv and v not in b_x]
    R = _shape(ins[n_c + n_k])[0]

    def stack(a: Aval) -> Aval:
        return Aval((R, *a.shape), a.dtype)
    k_outs = [v for v, k in zip(body.outvars, o_kn) if k]
    used: dict[Var, None] = {}
    for q in kloop:
        used.update((v, None) for v in q.invars
                    if isinstance(v, Var) and v in inv)
    used.update((v, None) for v in (*k_outs, *ext)
                if isinstance(v, Var) and v in inv)
    k_consts = list(used)
    k_carry = [v for v, k in zip(b_k, k_kn) if k]
    k_xs = [v for v, k in zip(b_x, x_kn) if k]
    ext_out = [Var(stack(v.aval), f"{e.source}.res{i}")
               for i, v in enumerate(ext)]
    if k_outs or ext:
        here.append(Eqn(
            "scan", [*(outer.get(v, v) for v in k_consts),
                     *(outer[v] for v in (*k_carry, *k_xs))],
            [o for o, k in zip(outs, o_kn) if k] + ext_out, {},
            functools.partial(_run_loop, Graph(
                kloop, [*k_consts, *k_carry, *k_xs], [*k_outs, *ext], [],
                [], ""), len(k_consts), len(k_carry), reverse=reverse),
            e.source))
    if all(o_kn):
        return here, None
    stacked = dict(zip(ext, ext_out))
    u_c = [v for v, m in zip(b_c, c_kn) if not m]
    u_k = [v for v, k in zip(b_k, k_kn) if not k]
    u_x = [v for v, m in zip(b_x, x_kn) if not m]
    e_res = ext + fwd_x
    loop = Eqn(
        "scan", [*(outer.get(v, v) for v in int_res),
                 *(outer[v] for v in (*u_c, *u_k, *u_x)),
                 *(stacked[v] if v in stacked else outer[v] for v in e_res)],
        [o for o, k in zip(outs, o_kn) if not k], {},
        functools.partial(_run_loop, Graph(
            un, [*int_res, *u_c, *u_k, *u_x, *e_res],
            [v for v, k in zip(body.outvars, o_kn) if not k], [], [], ""),
            len(int_res) + len(u_c), len(u_k), reverse=reverse),
        e.source)
    return here, loop


# -- a scan whose body is a lowered graph: JAX's partial evaluation ----------

def _tangents_out(body: Graph, lin: list[bool]) -> list[bool]:
    """Which of ``body``'s outputs depend on an input ``lin`` marks (a
    float output of an equation that reads such a value)."""
    has = {v for v, l in zip(body.invars, lin) if l}
    for e in body.eqns:
        got = [isinstance(v, Var) and v in has for v in e.invars]
        if e.prim == "remat2" and any(got):    # a literal output has none
            has.update(o for o, t in zip(e.outvars, _tangents_out(
                e.params["jaxpr"], got)) if t)
        elif any(got):
            has.update(o for o in e.outvars if _is_float(o.aval))
    return [isinstance(v, Var) and v in has for v in body.outvars]


def _tangent_parents(cts: list, got: list, eqns: list[Eqn],
                     reads: list) -> list:
    """A linear equation's operands in order, from its transpose: each
    equation the transpose emits read in order, a cotangent (or what a
    cotangent made) standing for the tangents the equation reads (the
    keys the transpose gives), any other value a residual."""
    keys = [k for k, _ in got]
    carried, out, put = {id(c) for c in cts}, [], False
    for q in eqns:
        hit = False
        for v in q.invars:
            if isinstance(v, Literal):
                continue
            if id(v) in carried:
                hit = True
                if not put:
                    out += keys
                    put = True
            else:
                out.append(v)
        if hit:
            carried.update(id(o) for o in q.outvars)
    return (out if put else keys + out) + list(reads)


class _Use:
    """One use of a residual by a linear equation (JAX instantiates a
    constant tracer for each)."""

    __slots__ = ("var",)

    def __init__(self, var: Var):
        self.var = var


def _toposort(ends: list, parents: Callable[[Any], list]) -> list:
    """``jax._src.util.toposort``: Kahn's algorithm from ``ends``,
    reversed."""
    ends = list(dict.fromkeys(ends))
    counts: dict[Any, int] = {}
    stack = list(ends)
    while stack:
        node = stack.pop()
        if node in counts:
            counts[node] += 1
        else:
            counts[node] = 1
            stack.extend(parents(node))
    for node in ends:
        counts[node] -= 1
    out, free = [], [n for n in ends if counts[n] == 0]
    while free:
        node = free.pop()
        out.append(node)
        for p in parents(node):
            if counts[p] == 1:
                free.append(p)
            else:
                counts[p] -= 1
    return out[::-1]


def _toposort_residuals(sub: _Tape, parents: dict, res: dict, ins: list,
                        outs: list) -> dict:
    """The residuals ``res`` of a scan's body in the order JAX's partial
    evaluation of the body's JVP makes them (``tracers_to_jaxpr``: its
    constants in :func:`_toposort` order of the tangent program, from
    the tangent inputs and outputs): each linear equation's outputs
    nodes whose parents are its operands (``parents``, by record), each
    use of a residual a node of its own."""
    rec_of = {k: i for i, rec in enumerate(sub.linear) for k in rec.outs}
    uses: dict[tuple[int, int], _Use] = {}

    def parents_of(node):
        i = rec_of.get(node) if isinstance(node, _Key) else None
        if i is None or i not in parents:
            return []
        out = []
        for j, p in enumerate(parents[i]):
            if isinstance(p, _Key):
                out.append(p)
            elif isinstance(p, Var) and p in res:
                out.append(uses.setdefault((i, j), _Use(p)))
        return out
    order = dict.fromkeys(n.var for n in _toposort([*ins, *outs], parents_of)
                          if isinstance(n, _Use))
    return order | {v: None for v in res if v not in order}


def _jvp_loop(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
    """A ``scan`` whose body is a lowered graph (``cdfg.scan``),
    partially evaluated as JAX's ``_scan_partial_eval`` does:

    * the carries that get a tangent are found by a fixpoint; one that
      starts without gets a zero tangent in the tangent program;
    * the body's JVP splits it into a known part (the primal and what
      the rules keep) and the tangent program's linear equations, whose
      transposes, in reverse, are the transposed scan's body; the known
      values they read are the residuals, in the order the tangent
      program first reads them.  A scan in the body is itself split so
      (this function, one level down): its known loop in the known
      part, its transposed scan in the transposed body;
    * the known part is partially evaluated on the consts
      (:func:`_partial_eval`): what reads only consts and literals is
      hoisted ahead of the loop — a ``jit`` split as JAX splits one, a
      scan in the body split by :func:`_split_loop` (the part of a
      segment's attention scan that reads only loop invariants, its
      masks, becomes a scan of its own ahead of both loops); a residual
      so hoisted, or a const itself, is an intensive residual of the
      transposed scan, the others extensive: stacked outputs of the
      forward scan (a carry's value at each step among them), or a
      scanned input forwarded;
    * the forward is one ``scan`` of the known loop body, its outputs the
      carries and the extensive residuals; the transpose, one reverse
      ``scan`` of the intensive residuals, the consts' cotangent
      accumulators (zeros), the carries' cotangents (a zero one
      instantiated) and the extensive residuals, whose outputs are the
      consts', the carries' and the scanned inputs' cotangents — of
      those the tangent program reads: an input whose tangent it never
      reads has none, as JAX's dead-code elimination leaves it."""
    body, n_c, n_k = e.impl.args
    consts, init, xs = ins[:n_c], ins[n_c:n_c + n_k], ins[n_c + n_k:]

    def lin_of(v):
        return tape.has_tangent(v) and _is_float(v.aval)
    c_lin, k_lin, x_lin = ([lin_of(v) for v in part]
                           for part in (consts, init, xs))
    i_lin = list(k_lin)
    for _ in range(n_k + 1):
        out = _tangents_out(body, c_lin + k_lin + x_lin)[:n_k]
        new = [a or b for a, b in zip(k_lin, out)]
        if new == k_lin:
            break
        k_lin = new

    # the body's JVP: known equations, and the linear records
    known = _Lowering(None)
    sub = _Tape(known, tape.src)
    sub.remat = tape.remat
    kin = [Var(v.aval, f"{tape.src}.in{i}") for i, v in enumerate(body.invars)]
    for v, k, l in zip(body.invars, kin, c_lin + k_lin + x_lin):
        sub.env[v] = k
        if l:
            sub.tan[k] = _Key()
    sub.forward(body.eqns)
    k_out = [v if isinstance(v, Literal) else sub.env[v]
             for v in body.outvars]
    ys_lin = _tangents_out(body, c_lin + k_lin + x_lin)[n_k:]

    # the transposed body: the tangent program's equations that read no
    # tangent (a nested scan's zero carry tangents), then the records'
    # transposes in reverse
    trans = _Lowering(None)
    sub.lo = trans
    for emit in sub.pre:
        emit()
    ct_k = [Var(v.aval, f"{tape.src}.ct{i}")
            for i, (v, l) in enumerate(zip(k_out[:n_k], k_lin)) if l]
    ct_y = [Var(v.aval, f"{tape.src}.cty{i}")
            for i, (v, l) in enumerate(zip(k_out[n_k:], ys_lin)) if l]
    c_lin0, x_lin0 = list(c_lin), list(x_lin)
    # each const's cotangent accumulates onto its accumulator (the
    # transposed scan's carry) as each part of it is made, as JAX's
    # ``ValAccum`` seeded with it does
    c_keys = [sub.tan[v] for v, l in zip(kin[:n_c], c_lin) if l]
    acc = [Var(v.aval, f"{tape.src}.acc{i}")
           for i, (v, l) in enumerate(zip(kin[:n_c], c_lin)) if l]
    sub.ct.update(zip(c_keys, acc))
    outs_lin = [v for v, l in zip(k_out, k_lin + ys_lin) if l]
    for v, c in zip(outs_lin, ct_k + ct_y):
        sub.accum(sub.tan.get(v), c)
    spans, parents = [], {}
    for i in reversed(range(len(sub.linear))):
        rec = sub.linear[i]
        cts = [sub.ct.pop(k, None) for k in rec.outs]
        if all(c is None for c in cts):
            continue
        start = len(trans.eqns)
        got = rec.transpose(cts)
        spans.append((i, rec.reads, start, len(trans.eqns)))
        if tape.remat:
            parents[i] = rec.ins if rec.ins is not None else \
                _tangent_parents([c for c in cts if c is not None], got,
                                 trans.eqns[start:], rec.reads)
        for key, ct in got:
            sub.accum(key, ct)

    def ct_of(v):
        ct = sub.ct.pop(sub.tan[v], None)
        return sub.zeros(v.aval) if ct is None else ct
    # an input's tangent the tangent program never reads: no cotangent
    got = [sub.ct.pop(k) for k in c_keys]
    read = iter([g is not a for g, a in zip(got, acc)])
    c_lin = [l and next(read) for l in c_lin]
    acc, acc_out = map(list, zip(*[(a, g) for a, g in zip(acc, got)
                                   if g is not a])) if any(c_lin) else ([], [])
    x_lin = [l and sub.tan[v] in sub.ct
             for v, l in zip(kin[n_c + n_k:], x_lin)]
    carry_out = [ct_of(v) for v, l in zip(kin[n_c:n_c + n_k], k_lin) if l]
    xs_out = [ct_of(v) for v, l in zip(kin[n_c + n_k:], x_lin) if l]

    # the residuals, in the order the tangent program reads them (JAX's
    # linearization of a scan) or, in a body under ``jax.checkpoint``
    # (its JVP partially evaluated), in JAX's topological order of the
    # tangent program (:func:`_toposort_residuals`)
    made = set(kin) | {o for q in known.eqns for o in q.outvars}
    res: dict[Var, None] = {}
    for _, reads, a, b in sorted(spans, key=lambda t: t[0]):
        res.update((v, None) for v in reads if v in made)
        for q in trans.eqns[a:b]:
            res.update((v, None) for v in q.invars
                       if isinstance(v, Var) and v in made)
    if tape.remat:
        res = _toposort_residuals(
            sub, parents, res,
            [sub.tan[k] for k, l in zip(kin, c_lin0 + k_lin + x_lin0) if l],
            [sub.tan[v] for v in outs_lin if sub.has_tangent(v)])

    # hoisting: the known part, less what neither the primal outputs nor
    # the residuals need (JAX's linearization of a scan drops it),
    # partially evaluated on the consts
    for a, (v, l) in zip(k_lin, zip(init, i_lin)):
        if a and not l:      # a zero carry tangent, in the tangent program
            tape.defer(lambda a=v.aval: tape.zeros(a))
    inv = set(kin[:n_c])
    hoisted, loop = _partial_eval(_dce(known.eqns, [*k_out, *res]), inv)
    outer = dict(zip(kin[:n_c], consts))
    for q in hoisted:
        got = tape.emit_multi(q.prim, [v if isinstance(v, Literal) else
                                       outer[v] for v in q.invars],
                              [o.aval for o in q.outvars], q.impl, q.name,
                              **q.params)
        outer.update(zip(q.outvars, got))
    ires = [v for v in res if v in inv]
    eres = [v for v in res if v not in inv]
    stacked = [v for v in eres if v not in kin[n_c + n_k:]]

    # the forward: one scan of the known loop body
    used: dict[Var, None] = {}
    for q in loop:
        used.update((v, None) for v in q.invars
                    if isinstance(v, Var) and v in inv)
    used.update((v, None) for v in (*k_out, *stacked)
                if isinstance(v, Var) and v in inv)
    k_consts = list(used)
    fwd_body = Graph(loop, [*k_consts, *kin[n_c:]], [*k_out, *stacked], [],
                     [], "")
    R = _shape(xs[0])[0]

    def stack(a):
        return Aval((R, *a.shape), a.dtype)
    got = tape.emit_multi(
        "scan", [*(outer[v] for v in k_consts), *init, *xs],
        [*(v.aval for v in e.outvars), *(stack(v.aval) for v in stacked)],
        functools.partial(_run_loop, fwd_body, len(k_consts), n_k))
    primal = got[:len(e.outvars)]
    outer.update(zip(stacked, got[len(e.outvars):]))
    outer.update(zip(kin[n_c + n_k:], xs))

    # the transpose: one reverse scan of the transposed body
    t_body = Graph(trans.eqns, [*ires, *acc, *ct_k, *ct_y, *eres],
                   [*acc_out, *carry_out, *xs_out], [], [], "")
    keys = [tape.fresh(o) for o, l in zip(primal, k_lin + ys_lin) if l]
    c_with = [v for v, l in zip(consts, c_lin) if l]
    k_with = [v for v, l in zip(init, k_lin) if l]
    x_with = [v for v, l in zip(xs, x_lin) if l]

    def transpose(cts):
        cts = [tape.zeros(v.aval) if c is None else c
               for c, v in zip(cts, [o for o, l in zip(primal, k_lin + ys_lin)
                                     if l])]
        zs = [tape.zeros(v.aval) for v in c_with]
        outs = tape.emit_multi(
            "scan", [*(outer[v] for v in ires), *zs, *cts,
                     *(outer[v] for v in eres)],
            [*(v.aval for v in c_with), *(v.aval for v in k_with),
             *(v.aval for v in x_with)],
            functools.partial(_run_loop, t_body, len(ires),
                              len(acc) + len(ct_k), reverse=True))
        return [(tape.tan.get(v), g) for v, g in
                zip([*c_with, *k_with, *x_with], outs)]
    tape.linear.append(_Linear(keys, transpose))
    return primal


# -- a body under ``jax.checkpoint``: JAX's remat with ``policy=None`` -------

def _known_loop_call(e: Eqn, src: str) -> tuple[Eqn, list[Var]]:
    """A scan of a lowered body, in the forward of a body under
    ``jax.checkpoint``: one ``closed_call`` (JAX's
    ``_scan_partial_eval_custom``, nothing saved) of the body's part that
    reads only its consts, hoisted, then a ``scan`` of the rest, whose
    consts are the hoisted values and the consts it reads, in the order
    it reads them.  Returns the equation (its operands ``e``'s) and its
    outputs (``e``'s, fresh)."""
    body, n_c, n_k = e.impl.args
    reverse = e.impl.keywords.get("reverse", False)
    b_c = body.invars[:n_c]
    hoisted, loop = _partial_eval(body.eqns, set(b_c))
    made = set(b_c) | {o for q in hoisted for o in q.outvars}
    lp: dict[Var, None] = {}
    for q in loop:
        lp.update((v, None) for v in q.invars
                  if isinstance(v, Var) and v in made)
    lp.update((v, None) for v in body.outvars
              if isinstance(v, Var) and v in made)
    lp = list(lp)
    cin = [Var(v.aval, f"{src}.c{i}") for i, v in enumerate(e.invars)]
    ren = dict(zip(b_c, cin))
    outs = [Var(v.aval, f"{src}.o{i}") for i, v in enumerate(e.outvars)]
    scan = Eqn("scan", [ren.get(v, v) for v in lp] + cin[n_c:], outs, {},
               functools.partial(_run_loop, Graph(
                   loop, [*lp, *body.invars[n_c:]], body.outvars, [], [],
                   ""), len(lp), n_k, reverse=reverse), e.source)
    call = Graph([_renamed(q, ren) for q in hoisted] + [scan], cin, outs,
                 [], [], "")
    return Eqn("closed_call", e.invars, e.outvars, {"call_jaxpr": call},
               _run_graph, e.source), outs


def _renamed(e: Eqn, ren: dict) -> Eqn:
    return dataclasses.replace(e, invars=[
        ren.get(v, v) if isinstance(v, Var) else v for v in e.invars])


def _remat_forward(tape: _Tape, body: Graph, ins: list) -> list:
    """The forward of a body under ``jax.checkpoint``: its equations of
    the primal alone, none of the residuals the JVP rules keep (JAX's
    known side of a remat with nothing saveable), a scan in it one
    ``closed_call`` (:func:`_known_loop_call`)."""
    env = dict(zip(body.invars, ins))

    def read(v):
        return v if isinstance(v, Literal) else env[v]
    for q in body.eqns:
        if q.prim == "scan" and getattr(q.impl, "func", None) is _run_loop:
            q, _ = _known_loop_call(q, tape.src)
        outs = tape.emit_multi(q.prim, [read(v) for v in q.invars],
                               [o.aval for o in q.outvars], q.impl, q.name,
                               **q.params)
        env.update(zip(q.outvars, outs))
    return [read(v) for v in body.outvars]


def _remat_transposed(src: str, body: Graph, lin: list[bool],
                      ct_nz: list[bool]) -> tuple:
    """The body of the transposed ``remat2`` equation: JAX's
    ``remat_transpose`` — the body's JVP partially evaluated with the
    primal known (the recomputed primal and the residuals its rules keep,
    less what no tangent needs, a scan in it linearized as at any level),
    then each linear equation's transpose in reverse.  ``lin`` marks the
    inputs with a tangent, ``ct_nz`` the outputs (of those with one)
    whose cotangent is not zero.  Returns the graph (inputs: the primal
    inputs it reads, then the cotangents; outputs: the cotangents of the
    inputs that get one), which inputs it reads and which get one."""
    known = _Lowering(None)
    st = _Tape(known, src)
    st.eager_pre = st.remat = True
    kin = [Var(v.aval, f"{src}.r{i}") for i, v in enumerate(body.invars)]
    for v, k, l in zip(body.invars, kin, lin):
        st.env[v] = k
        if l:
            st.tan[k] = _Key()
    st.forward(body.eqns)
    outs = [v if isinstance(v, Literal) else st.env[v] for v in body.outvars]
    trans = _Lowering(None)
    st.lo = trans
    with_tan = [o for o in outs if st.has_tangent(o) and _is_float(o.aval)]
    cts = [Var(o.aval, f"{src}.ct{i}") for i, (o, nz) in enumerate(zip(
        with_tan, ct_nz)) if nz]
    for o, c in zip([o for o, nz in zip(with_tan, ct_nz) if nz], cts):
        st.accum(st.tan[o], c)
    reads: list = []
    for rec in reversed(st.linear):
        got_ct = [st.ct.pop(k, None) for k in rec.outs]
        if all(c is None for c in got_ct):
            continue
        reads += rec.reads
        for key, ct in rec.transpose(got_ct):
            st.accum(key, ct)
    got = [st.ct.pop(st.tan[k], None) if l else None
           for k, l in zip(kin, lin)]
    needed = reads + st.eager_made + [v for q in trans.eqns for v in q.invars]
    eqns = [*_dce(known.eqns, needed), *trans.eqns]
    used = {v for q in eqns for v in q.invars if isinstance(v, Var)}
    used.update(v for v in got if isinstance(v, Var))
    reads_in = [k in used for k in kin]
    return (Graph(eqns, [k for k, r in zip(kin, reads_in) if r] + cts,
                  [g for g in got if g is not None], [], [], ""),
            reads_in, [g is not None for g in got])


def _jvp_remat(tape: _Tape, e: Eqn, ins: list, lin: list) -> list:
    """A ``remat2`` equation (``cdfg.checkpoint``: a scan body under
    ``jax.checkpoint``), linearized as JAX's remat with ``policy=None``:
    the forward is the body's primal alone (:func:`_remat_forward`), its
    residuals the inputs themselves; the transpose one ``remat2``
    equation of the inputs it reads and the cotangents, whose body
    recomputes the primal and transposes (:func:`_remat_transposed`)."""
    body = e.params["jaxpr"]
    lin = [l and _is_float(x.aval) for x, l in zip(ins, lin)]
    outs = _remat_forward(tape, body, ins)
    out_lin = [l and _is_float(o.aval) for o, l in zip(
        outs, _tangents_out(body, lin))]
    keys = [tape.fresh(o) for o, l in zip(outs, out_lin) if l]

    def transpose(cts):
        graph, reads_in, got = _remat_transposed(
            tape.src, body, lin, [c is not None for c in cts])
        x_in = [x for x, r in zip(ins, reads_in) if r]
        res = tape.emit_multi(
            "remat2", [*x_in, *(c for c in cts if c is not None)],
            [v.aval for v in graph.outvars], _run_graph, jaxpr=graph,
            prevent_cse=True, differentiated=True, policy=None)
        return list(zip([tape.tan[x] for x, g in zip(ins, got) if g], res))
    tape.linear.append(_Linear(keys, transpose))
    return outs


def _split_call(e: Eqn, mask: list[bool]) -> tuple[Eqn, Eqn]:
    """A ``closed_call`` some of whose operands are known, split as JAX's
    partial evaluation of a call: a ``closed_call`` of the known operands
    (all of them) giving the known outputs and the residuals it makes;
    one of the residuals (those it makes, and the known operands the rest
    reads, in the order the rest reads them) and the unknown operands
    giving the rest."""
    g = e.params["call_jaxpr"]
    known = {v for v, m in zip(g.invars, mask) if m}
    kn, un = _partial_eval(g.eqns, known)
    o_kn = [isinstance(v, Literal) or v in known for v in g.outvars]
    res: dict[Var, None] = {}
    for q in un:
        res.update((v, None) for v in q.invars
                   if isinstance(v, Var) and v in known)
    k_in = [v for v, m in zip(g.invars, mask) if m]
    made = [v for v in res if v not in k_in]
    made_out = [Var(v.aval, f"{e.source}.res{i}") for i, v in enumerate(made)]
    outer = dict(zip(g.invars, e.invars)) | dict(zip(made, made_out))
    k_call = Eqn("closed_call", [v for v, m in zip(e.invars, mask) if m],
                 [o for o, k in zip(e.outvars, o_kn) if k] + made_out,
                 {"call_jaxpr": Graph(kn, k_in, [v for v, k in zip(
                     g.outvars, o_kn) if k] + made, [], [], "")},
                 _run_graph, e.source)
    u_in = [v for v, m in zip(g.invars, mask) if not m]
    u_call = Eqn("closed_call", [outer[v] for v in res] + [
        o for o, m in zip(e.invars, mask) if not m],
        [o for o, k in zip(e.outvars, o_kn) if not k],
        {"call_jaxpr": Graph(un, [*res, *u_in], [v for v, k in zip(
            g.outvars, o_kn) if not k], [], [], "")}, _run_graph, e.source)
    return k_call, u_call


#: primitive (or ``jit <name>``) -> JVP rule
JVP_RULES: dict[str, Callable] = {
    "neg": _linear1(_t_neg),
    "convert_element_type": _linear1(_t_convert),
    "reduce_sum": _linear1(_t_reduce_sum),
    "broadcast_in_dim": _linear1(_t_broadcast_in_dim),
    "squeeze": _linear1(_t_squeeze),
    "slice": _linear1(_t_slice),
    "add": _jvp_add_sub,
    "sub": _jvp_add_sub,
    "mul": _jvp_mul,
    "div": _jvp_div,
    "rsqrt": _jvp_rsqrt,
    "dot_general": _jvp_dot_general,
    "gather": _jvp_gather,
    "scan": _jvp_scan,
    "concatenate": _jvp_concatenate,
    "jit log_softmax": _jvp_log_softmax,
    "jit take_along_axis": _jvp_take_along_axis,
    "jit _var": _jvp_var,
    "reshape": _linear1(_t_reshape),
    "transpose": _linear1(_t_transpose),
    "split": _jvp_split,
    "jit _pad": _jvp_pad,
    "integer_pow": _jvp_scaled(_integer_pow_jac),
    "pow": _jvp_pow,
    "logistic": _jvp_scaled(_logistic_jac),
    "exp": _jvp_exp,
    "tanh": _jvp_tanh,
    "stop_gradient": _jvp_stop_gradient,
    "max": _jvp_max,
    "reduce_max": _jvp_reduce_max,
    "top_k": _jvp_top_k,
    "scatter-add": _jvp_scatter_add,
    "jit silu": _jvp_silu,
    "jit _where": _jvp_where,
    "jit softmax": _jvp_softmax,
    "square": _jvp_scaled(_square_jac),
    "jit relu": _jvp_relu,
    "jit softplus": _jvp_softplus,
    "jit cumsum": _linear1(_t_cumsum),
    "dynamic_slice": _jvp_dynamic_slice,
    "remat2": _jvp_remat,
}


def lower_value_and_grad(lo: _Lowering, node: Any) -> tuple:
    """A traced ``grad`` leaf → the equations of its value function, the
    residuals, and the transposes (the module docstring); returns the
    value's outputs, then one gradient per parameter leaf."""
    gm, where = node.meta["grad"]
    sub = _Lowering(gm, lo.device).run()
    p_nodes, a_nodes = node.args
    params = [lo.read(n) for n in p_nodes]
    tape = _Tape(lo, node.name)
    for p in params:
        tape.tan[p] = _Key()
    n_p = len(where)
    for v, i in zip(sub.invars[:n_p], where):
        tape.env[v] = params[i]
    for v, n in zip(sub.invars[n_p:], a_nodes):
        tape.env[v] = lo.read(n)
    for v, c in zip(sub.constvars, sub.consts):
        lo.constvars.append(v)
        lo.consts.append(c)
        tape.env[v] = v
    tape.forward(sub.eqns)

    def read(v):
        return v if isinstance(v, Literal) else tape.env[v]
    tape.backward(read(sub.outvars[0]))
    return (*map(read, sub.outvars), *map(tape.grad, params))
