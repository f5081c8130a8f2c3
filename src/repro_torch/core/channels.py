"""FIFO channels — the template's communication primitive (§II, §III-A).

Three realizations of the paper's FIFO:

* :class:`ChannelSpec` — packs a fixed tuple of tensors, or a tree of
  them, into one flat ``int32`` transport word, so heterogeneous stage
  boundaries can share one physical channel (the pipeline executor ships
  one fixed-width word per tick).  Packing is a byte-level
  reinterpretation (``Tensor.view``), exact for every dtype; the bytes
  are those of the reference's ``uint32`` words.
* :class:`DeviceFIFO` — a bounded ring buffer held in a device tensor
  (functional push/pop): the analogue of the BRAM FIFO between two
  accelerator stages.
* :class:`HostFIFO` — a bounded, thread-backed queue for the input
  pipeline (host → device prefetch), giving the data-loading stage the
  same decoupled producer/consumer behaviour the paper gives memory
  stages.
"""

from __future__ import annotations

import dataclasses
import math
import queue
import threading
from typing import Any, Callable, Iterator, Sequence

import numpy as np
import torch

from .._device import get_device

WORD = torch.int32  # the transport word (4 bytes)


# ---------------------------------------------------------------------------
# Payload packing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class LeafSpec:
    shape: tuple[int, ...]
    dtype: torch.dtype
    words: int

    @property
    def nbytes(self) -> int:
        return math.prod(self.shape) * self.dtype.itemsize


#: a tree's structure in ``jax.tree_util``'s order: ``None`` holds no
#: leaf, a dict its values by sorted key, a list or tuple its items, and
#: anything else is one leaf
_LEAF = "*"


def _flatten(tree_: Any) -> tuple[list[Any], Any]:
    """The leaves of ``tree_`` and its structure, as
    ``jax.tree_util.tree_flatten`` orders them (the port's ``tree`` keeps
    dict insertion order and makes ``None`` a leaf)."""
    if tree_ is None:
        return [], None
    if isinstance(tree_, dict):
        keys = sorted(tree_)
        kids = [_flatten(tree_[k]) for k in keys]
        return ([x for leaves, _ in kids for x in leaves],
                (dict, tuple(keys), tuple(d for _, d in kids)))
    if isinstance(tree_, (list, tuple)):
        kids = [_flatten(x) for x in tree_]
        return ([x for leaves, _ in kids for x in leaves],
                (type(tree_), len(tree_), tuple(d for _, d in kids)))
    return [tree_], _LEAF


def _unflatten(treedef: Any, it: Iterator[Any]) -> Any:
    if treedef is None:
        return None
    if treedef == _LEAF:
        return next(it)
    kind, keys, kids = treedef
    values = [_unflatten(d, it) for d in kids]
    return dict(zip(keys, values)) if kind is dict else kind(values)


def _as_tensor(x: Any) -> torch.Tensor:
    """A tensor keeps its dtype; anything else becomes one as
    ``jnp.asarray`` makes it with 64-bit types off (a Python ``int`` or
    an int64 array → int32, a ``float`` or float64 → float32)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    narrow = {np.dtype(np.int64): np.int32, np.dtype(np.uint64): np.uint32,
              np.dtype(np.float64): np.float32}
    return torch.as_tensor(a.astype(narrow.get(a.dtype, a.dtype)))


@dataclasses.dataclass
class ChannelSpec:
    """Pack/unpack a fixed tuple of tensors (or, from
    :meth:`from_example`, a tree of them) to/from a flat int32 word."""

    leaves: list[LeafSpec]
    width: int  # total int32 words
    #: the payload's structure (:meth:`from_example`); ``None``: a flat
    #: tuple of ``leaves``
    treedef: Any = None

    @classmethod
    def from_avals(cls, avals: Sequence[Any]) -> "ChannelSpec":
        """From abstract values (anything with ``shape`` and ``dtype``)."""
        leaves = []
        for a in avals:
            shape = tuple(a.shape)
            nbytes = math.prod(shape) * a.dtype.itemsize
            leaves.append(LeafSpec(shape, a.dtype, (nbytes + 3) // 4))
        return cls(leaves, sum(l.words for l in leaves))

    @classmethod
    def from_example(cls, example: Any) -> "ChannelSpec":
        """From an example payload: a tree of dicts, lists, tuples and
        ``None`` over tensors, arrays or Python scalars.  Its leaves are
        laid out in the reference's order (dict keys sorted, ``None``
        holding no words), so ``width`` and the packed bytes equal the
        reference's; :meth:`unpack` returns a tree of the example's
        structure."""
        flat, treedef = _flatten(example)
        spec = cls.from_avals([_as_tensor(x) for x in flat])
        return cls(spec.leaves, spec.width, treedef)

    def pack(self, payload: Any, pad_to: int | None = None,
             device: torch.device | None = None) -> torch.Tensor:
        if self.treedef is not None:
            payload, _ = _flatten(payload)
        parts = []
        for spec, x in zip(self.leaves, payload):
            b = torch.as_tensor(x, dtype=spec.dtype).contiguous() \
                .reshape(-1).view(torch.uint8)
            pad = (-b.numel()) % 4
            if pad:
                b = torch.cat([b, b.new_zeros(pad)])
            parts.append(b.view(WORD))
        width = max(self.width, pad_to or 0)
        if parts:
            device = parts[0].device
        out = torch.zeros(width, dtype=WORD, device=device)
        if parts:
            body = torch.cat(parts)
            out[:body.numel()] = body
        return out

    def unpack(self, word: torch.Tensor) -> Any:
        """The flat tuple of tensors, or the tree of :meth:`from_example`'s
        structure."""
        flat = []
        off = 0
        for spec in self.leaves:
            w = word[off:off + spec.words].contiguous()
            off += spec.words
            if w.storage_offset() * 4 % spec.dtype.itemsize:
                w = w.clone()      # an 8-byte view needs an 8-byte offset
            b = w.view(torch.uint8)[:spec.nbytes]
            flat.append(b.view(spec.dtype).reshape(spec.shape))
        if self.treedef is None:
            return tuple(flat)
        return _unflatten(self.treedef, iter(flat))


# ---------------------------------------------------------------------------
# Device-side bounded FIFO (functional ring buffer)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FIFOState:
    buf: torch.Tensor    # (depth, width) int32
    head: torch.Tensor   # 0-d int64: next pop position
    count: torch.Tensor  # 0-d int64: occupancy


class DeviceFIFO:
    """Bounded FIFO over fixed-width int32 words, held on a device.

    Functional: every op returns a new :class:`FIFOState`, and the guards
    are tensors, so a push or pop never syncs with the host.  Push on a
    full FIFO and pop on an empty one are no-ops, gated by the caller via
    :meth:`can_push` / :meth:`can_pop` masks (backpressure — §II's
    bounded channels are what localize stalls).  ``device`` follows the
    port's policy (:func:`repro_torch.get_device`): the card unless the
    CPU is asked for.
    """

    def __init__(self, depth: int, width: int,
                 device: torch.device | str | None = None):
        self.depth = depth
        self.width = width
        self.device = get_device(device)

    def init(self) -> FIFOState:
        z = torch.zeros((), dtype=torch.int64, device=self.device)
        return FIFOState(
            buf=torch.zeros((self.depth, self.width), dtype=WORD,
                            device=self.device),
            head=z, count=z.clone())

    def can_push(self, s: FIFOState) -> torch.Tensor:
        return s.count < self.depth

    def can_pop(self, s: FIFOState) -> torch.Tensor:
        return s.count > 0

    def push(self, s: FIFOState, word: torch.Tensor,
             enable: torch.Tensor | bool = True) -> FIFOState:
        enable = torch.as_tensor(enable, device=self.device) \
            & self.can_push(s)
        tail = (s.head + s.count) % self.depth
        row = torch.where(enable, word.to(WORD), s.buf[tail])
        buf = s.buf.index_put((tail.reshape(1),), row.reshape(1, -1))
        return FIFOState(buf, s.head, s.count + enable.long())

    def pop(self, s: FIFOState, enable: torch.Tensor | bool = True
            ) -> tuple[torch.Tensor, FIFOState]:
        enable = torch.as_tensor(enable, device=self.device) & self.can_pop(s)
        word = s.buf[s.head]
        new_head = torch.where(enable, (s.head + 1) % self.depth, s.head)
        return word, FIFOState(s.buf, new_head, s.count - enable.long())


# ---------------------------------------------------------------------------
# Host-side bounded prefetch FIFO (input pipeline decoupling)
# ---------------------------------------------------------------------------

class HostFIFO:
    """Producer thread fills a bounded queue; consumer iterates.

    Applies the template to the host→device boundary: data production
    (tokenization, sharding, H2D transfer) is its own pipeline stage whose
    latency is hidden as long as the queue is non-empty, exactly like a
    memory-access stage feeding a compute stage in §II.
    """

    _SENTINEL = object()

    def __init__(self, source: Iterator[Any], depth: int = 4,
                 transform: Callable[[Any], Any] | None = None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._source = source
        self._transform = transform
        self._err: BaseException | None = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            for item in self._source:
                if self._transform is not None:
                    item = self._transform(item)
                self._q.put(item)
        except BaseException as e:  # surfaced on next __next__
            self._err = e
        finally:
            self._q.put(self._SENTINEL)

    def __iter__(self) -> "HostFIFO":
        return self

    def __next__(self) -> Any:
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    @property
    def occupancy(self) -> int:
        return self._q.qsize()
