"""What one rank of a sharded step computes, moves and holds.

:class:`RankCensus` is a dispatch mode that watches the *local* ops a
DTensor program runs on this rank: DTensor desugars each op on sharded
tensors into collectives and ops on the rank's shards, and the mode lets
DTensor run first (it returns ``NotImplemented`` for a DTensor op) and
then sees the local ops.  Only ops whose outputs lie on the shards'
device count: the dry run's shards are ``meta`` tensors (shapes, no
storage), so the small index tensors DTensor builds on the CPU to plan a
redistribution, and the fake tensors it runs ops on to infer output
shapes, are not the rank's.  The mode records

* each collective's kind, count and result bytes, in the reference's
  five kinds (``repro.launch.dryrun._COLLECTIVES``), summed as the
  reference's ``collective_bytes`` sums result shapes;
* the rank's FLOPs, by ``torch.utils.flop_counter``'s formulas on the
  local shapes (a ``FlopCounterMode`` around DTensor ops counts the
  global op), and the bytes its non-view ops read and write (each
  tensor operand and output once an op, as XLA's "bytes accessed");
* the peak of live local bytes: the storages of the tensors registered
  with :meth:`hold` (the step's arguments) and of every local op's
  outputs, each freed when its storage dies.

It runs on ``meta`` shards (the dry run) and on real ones (the tests'
gloo ranks) alike.
"""

from __future__ import annotations

import functools
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

#: the collectives DTensor launches (``_c10d_functional``) → kind; any
#: other collective raises rather than go uncounted
_KIND_OF = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_NOT_COUNTED = {"wait_tensor", "barrier", "_wrap_tensor_autograd"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(xs) -> list:
    """The tensors among ``xs`` and inside its lists and tuples (an op's
    arguments: a foreach op takes lists)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(t for t in x if isinstance(t, torch.Tensor))
    return out


class RankCensus(TorchDispatchMode):
    """Enter around a step whose shards lie on ``device_type``; read
    :meth:`record` after."""

    def __init__(self, device_type: str):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        super().__init__()
        self.device_type = device_type
        self.coll = {k: 0 for k in KINDS}
        self.count = {k: 0 for k in KINDS}
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self._held: dict[int, tuple] = {}
        self._ops: dict = {}
        self._dtensor, self._fake = DTensor, FakeTensor

    # -- memory --------------------------------------------------------------
    def _free(self, key: int, _ref=None) -> None:
        n, _ = self._held.pop(key, (0, None))
        self.live -= n

    def hold(self, *tensors: torch.Tensor) -> None:
        """Count these tensors' storages as live until they die."""
        for t in tensors:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._held:
                continue
            n = st.nbytes()
            self._held[key] = (n, weakref.ref(
                st, functools.partial(self._free, key)))
            self.live += n
        if self.live > self.peak:
            self.peak = self.live

    # -- dispatch ------------------------------------------------------------
    def _op(self, func) -> tuple:
        """(collective kind or None, counted, flop formula or None,
        moves bytes) of an op, worked out once."""
        got = self._ops.get(func)
        if got is None:
            ns, name = func.namespace, func._schema.name.split("::")[-1]
            if ns in ("_c10d_functional", "c10d"):
                kind = _KIND_OF.get(name)
                if kind is None and name not in _NOT_COUNTED:
                    raise NotImplementedError(f"collective {ns}.{name} has "
                                              f"no kind in the census")
                got = (kind, kind is not None, None, False)
            else:
                got = (None, True, flop_registry.get(func._overloadpacket),
                       not func.is_view)
            self._ops[func] = got
        return got

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = ([out] if isinstance(out, torch.Tensor)
                else [t for t in tree_leaves(out)
                      if isinstance(t, torch.Tensor)])
        # the rank's own tensors, not DTensor's shape inference (fake
        # tensors) or planning (small tensors on the CPU)
        if not outs or any(t.device.type != self.device_type
                           or isinstance(t, self._fake) for t in outs):
            return out
        kind, counted, flops, moves = self._op(func)
        if not counted:
            return out
        if kind is not None:
            self.coll[kind] += sum(_nbytes(t) for t in outs)
            self.count[kind] += 1
        else:
            if flops is not None:
                self.flops += flops(*args, **kwargs, out_val=out)
            if moves:
                self.bytes += sum(map(_nbytes, outs)) + sum(
                    map(_nbytes, _tensors((*args, *kwargs.values()))))
        self.hold(*outs)
        return out

    def record(self) -> dict:
        coll: dict[str, Any] = dict(self.coll)
        coll["count"] = dict(self.count)
        coll["total"] = sum(self.coll.values())
        return {"coll": coll, "rank_flops": int(self.flops),
                "rank_bytes": int(self.bytes), "peak_bytes": int(self.peak)}
