"""Collectives over ``torch.distributed`` ranks — the port's counterparts
of the JAX primitives the reference calls inside ``shard_map``.

JAX runs a mesh inside one process; torch's ranks are processes, so the
port's multi-device executors are SPMD: every rank calls the same
function with the same arguments.  :class:`Collectives` holds one
group's primitives for one rank's device:

* :attr:`Collectives.rank` / :attr:`~Collectives.size` — the
  reference's ``lax.axis_index`` and the axis size;
* :meth:`~Collectives.ppermute` — the reference's ring
  ``[(i, (i + 1) % S)]`` (and its reverse, ``hop=-1``) on
  ``batch_isend_irecv``;
* :meth:`~Collectives.psum` / :meth:`~Collectives.pmax` on
  ``all_reduce``; :meth:`~Collectives.broadcast` (the reference
  replicates with a ``psum`` of buffers masked to one device, which is a
  broadcast from that device).

The route is chosen once, from the group's backend and the device,
before anything moves — as the kernel routes are — and nothing falls
back to another:

* ``"nccl"``: CUDA tensors travel as they are (one card per rank);
* ``"gloo"``: CPU tensors travel as they are;
* ``"gloo host-staged"``: gloo carries only host memory, so a CUDA
  tensor is copied into a pinned host buffer, moved by gloo, and copied
  back onto the card.  The compute stays on the card.  This is the route
  of several ranks sharing one card, where NCCL refuses two ranks on one
  device.  The pinned buffers are the process's, one per (role, shape,
  dtype), kept across calls and groups: a training loop that reduces
  the same gradients every step pins its buffers once.

A group of one rank moves nothing: a shift to itself is the tensor.

:func:`full_tensor` gathers a DTensor whole on the same routes: on the
host-staged one, its shards travel as host copies over a CPU mesh of the
same ranks.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

NCCL, GLOO, GLOO_STAGED = "nccl", "gloo", "gloo host-staged"

# the host-staged route's pinned buffers, by (role, shape, dtype)
_PINNED: dict[tuple, torch.Tensor] = {}
# the host-staged route's CPU twin of each CUDA DeviceMesh
_HOST_MESHES: dict = {}


def route(group: dist.ProcessGroup | None, device: torch.device) -> str:
    """How tensors on ``device`` travel over ``group``: ``"nccl"``,
    ``"gloo"`` or ``"gloo host-staged"``; raises for a pairing no route
    carries (NCCL with host tensors, or another backend)."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"the nccl backend carries CUDA tensors only, "
                             f"not {device.type} ones; use gloo")
        return NCCL
    if backend == "gloo":
        return GLOO_STAGED if device.type == "cuda" else GLOO
    raise ValueError(f"unsupported torch.distributed backend {backend!r}; "
                     f"use 'nccl' or 'gloo'")


class Collectives:
    """One group's collectives for tensors on one rank's ``device``.

    Cheap to build: the host-staged route's pinned buffers belong to the
    process, not the instance.  Every copy through a staging buffer
    completes before the call returns (the card's stream is synchronised
    before gloo reads a buffer, and gloo has finished before the copy
    back), so the next call may reuse it."""

    def __init__(self, group: dist.ProcessGroup | None,
                 device: torch.device | str):
        self.group = group if group is not None else dist.group.WORLD
        self.device = torch.device(device)
        self.rank = dist.get_rank(self.group)
        if self.rank < 0:
            raise ValueError("this rank is not a member of the group")
        self.size = dist.get_world_size(self.group)
        self.route = route(self.group, self.device)

    def _global(self, group_rank: int) -> int:
        return dist.get_global_rank(self.group, group_rank)

    # -- host staging ---------------------------------------------------------

    @staticmethod
    def _buffer(role: str, like: torch.Tensor) -> torch.Tensor:
        key = (role, tuple(like.shape), like.dtype)
        buf = _PINNED.get(key)
        if buf is None:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            _PINNED[key] = buf
        return buf

    def _out(self, x: torch.Tensor, role: str) -> torch.Tensor:
        """``x`` as the wire takes it: itself, or its copy in a pinned host
        buffer (a blocking copy: the stream's work on ``x`` is done)."""
        if self.route != GLOO_STAGED:
            return x
        return self._buffer(role, x).copy_(x)

    def _empty(self, like: torch.Tensor, role: str) -> torch.Tensor:
        if self.route != GLOO_STAGED:
            return torch.empty_like(like)
        return self._buffer(role, like)

    def _back(self, wire: torch.Tensor) -> torch.Tensor:
        """A received wire tensor on the device, as a tensor of its own."""
        if self.route != GLOO_STAGED:
            return wire
        return wire.to(self.device)

    # -- the primitives -------------------------------------------------------

    def ppermute(self, x: torch.Tensor, hop: int = 1) -> torch.Tensor:
        """Send ``x`` to rank ``(r + hop) % S`` and return what rank
        ``(r - hop) % S`` sent: the reference's
        ``ppermute(x, [(i, (i + hop) % S)])``.  Every rank of the group
        must call it with a tensor of one shape and dtype."""
        S = self.size
        if S == 1:
            return x
        x = x.contiguous()
        send = self._out(x, "send")
        recv = self._empty(x, "recv")
        ops = [dist.P2POp(dist.isend, send,
                          self._global((self.rank + hop) % S), self.group),
               dist.P2POp(dist.irecv, recv,
                          self._global((self.rank - hop) % S), self.group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return self._back(recv)

    def _all_reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        if self.size == 1:
            return x
        wire = self._out(x.contiguous(), "reduce")
        if wire is x:
            wire = x.clone()
        dist.all_reduce(wire, op=op, group=self.group)
        return self._back(wire)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the group (``lax.psum``)."""
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``x`` over the group (``lax.pmax``)."""
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Group rank ``src``'s ``x`` on every rank; the others pass a
        tensor of the same shape and dtype, whose values are ignored."""
        if self.size == 1:
            return x
        wire = self._out(x.contiguous(), "broadcast")
        if wire is x:
            wire = x.clone()
        dist.broadcast(wire, self._global(src), group=self.group)
        return self._back(wire)


def full_tensor(x) -> torch.Tensor:
    """The whole of the DTensor ``x`` on this rank (a collective: every
    rank of its mesh calls it): ``x.full_tensor()`` where the mesh's
    backend carries ``x``'s device; on the ``"gloo host-staged"`` route
    the shards go to the host and are gathered on a CPU mesh of the same
    ranks and dims (made once per mesh, which is itself a collective of
    the default group), and the whole comes back on the CPU."""
    if route(None, x.device) != GLOO_STAGED:
        return x.full_tensor()
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor
    mesh = x.device_mesh
    host = _HOST_MESHES.get(mesh)
    if host is None:
        host = _HOST_MESHES[mesh] = DeviceMesh(
            "cpu", mesh.mesh, mesh_dim_names=mesh.mesh_dim_names)
    local = x.to_local().to("cpu")
    return DTensor.from_local(local, host, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride()).full_tensor()
