"""Ranks for the multi-device executors: the port's counterpart of the
reference's debug mesh (``repro.launch.mesh.make_debug_mesh``, 8 forced
host devices in one process).

Torch's ranks are processes.  :func:`spawn` starts ``world`` of them
with the ``spawn`` start method (CUDA does not survive a fork), joins
them into one ``torch.distributed`` group and runs ``fn(*args)`` on
each, SPMD.  The caller names the backend; nothing picks one for it:

* ``"nccl"`` gives each rank a card of its own, rank r on ``cuda:r``;
  it needs at least ``world`` cards;
* ``"gloo"`` runs on the CPU (``device="cpu"``) or with every rank on
  ``cuda:(r % device_count)`` — on a one-card host all ranks share
  ``cuda:0`` and their tensors travel host-staged
  (:mod:`repro_torch.core.collectives`).

The ranks meet through a ``FileStore`` in a fresh temporary directory,
not a TCP port, so concurrent callers (pytest-xdist workers) cannot
collide.  On a host with S cards, ``torchrun --nproc-per-node S`` starts
the same ranks without this module; the executors take whatever group
is initialised.

The reference's production mesh (``make_production_mesh``: 16×16, or
2×16×16, TPU chips, lowered on 512 placeholder CPU devices) is a
``DeviceMesh`` here over a *fake* process group of 256 or 512 ranks in
the calling process (:func:`fake_world`, torch's ``"fake"`` backend):
collectives hallucinate, nothing is communicated, and the process plays
rank 0.  Nothing starts it at import; the dry run opens it for its call
and destroys it after.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import multiprocessing as mp
import os
import pickle
import tempfile
import time
from typing import Any, Callable, Iterator, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp

from .. import _device, tree


class RankError(RuntimeError):
    """A rank raised, or died before returning; the message holds its
    traceback or exit code."""


def _rank_device(rank: int, device_type: str) -> torch.device:
    """The device rank ``rank`` runs on: ``cuda:(rank % device_count)`` or
    the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def _rank_main(rank: int, fn: Callable, world: int, store_path: str,
               backend: str, device_type: str, timeout_s: float,
               args: tuple, results) -> None:
    dev = _rank_device(rank, device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        # ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    _device.set_device(dev)
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    result = tree.tree_map(
        lambda t: t.detach().cpu() if isinstance(t, torch.Tensor) else t,
        fn(*args))
    # the ranks leave together: a rank with nothing to do (one outside a
    # subgroup) would otherwise exit, closing its connections, while a
    # slower rank is still connecting to it in ``init_process_group``
    dist.barrier()
    # pickled here, so the parent gets bytes, not tensors in shared memory
    results.put((rank, pickle.dumps(result)))
    dist.destroy_process_group()


def spawn(fn: Callable, world: int, *args: Any, backend: str,
          device: str | torch.device | None = None,
          timeout_s: float = 600.0) -> list[Any]:
    """Run ``fn(*args)`` on ``world`` ranks of a fresh process group and
    return each rank's result, in rank order, with tensors on the CPU.

    ``fn`` must be importable by name (a module-level function), since
    each rank starts from a fresh interpreter.  ``device`` is ``"cpu"``
    or, by default, the card (raises where there is none).  If a rank
    raises or dies, the others are killed and :class:`RankError` carries
    its traceback; if the ranks have not all returned within
    ``timeout_s`` seconds, they are killed and ``TimeoutError`` is
    raised.  Nothing outlives the call."""
    device_type = _device.get_device(device).type
    if backend == "nccl" and (device_type != "cuda"
                              or torch.cuda.device_count() < world):
        raise ValueError(
            f"nccl needs one card per rank: {world} ranks, "
            f"{torch.cuda.device_count() if device_type == 'cuda' else 0} "
            f"cards; use backend='gloo' to share cards")
    results = mp.get_context("spawn").SimpleQueue()
    got: dict[int, Any] = {}

    def drain() -> None:
        # a rank's put blocks until its bytes are read
        while not results.empty():
            r, body = results.get()
            got[r] = pickle.loads(body)

    with tempfile.TemporaryDirectory(prefix="repro-torch-ranks-") as tmpdir:
        ctx = torch_mp.start_processes(
            _rank_main, (fn, world, os.path.join(tmpdir, "store"), backend,
                         device_type, timeout_s, args, results),
            nprocs=world, join=False, daemon=True, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=0.1, grace_period=1.0):
                drain()
                if time.monotonic() > deadline:
                    waiting = [r for r in range(world) if r not in got]
                    raise TimeoutError(f"ranks {waiting} of {world} did not "
                                       f"return within {timeout_s} s")
        except torch_mp.ProcessRaisedException as e:
            raise RankError(f"rank {e.error_index} of {world} raised:"
                            f"{e}") from None
        except torch_mp.ProcessExitedException as e:
            raise RankError(f"rank {e.error_index} of {world} exited with "
                            f"code {e.exit_code} before returning") from None
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        drain()
    missing = [r for r in range(world) if r not in got]
    if missing:
        raise RankError(f"ranks {missing} of {world} exited before returning")
    return [got[r] for r in range(world)]


# ---------------------------------------------------------------------------
# Logical meshes: the production mesh on a fake world
# ---------------------------------------------------------------------------

PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0) -> Iterator[None]:
    """A fake default process group of ``world`` ranks in this process,
    which plays ``rank``, destroyed on exit.  Raises if a process group
    is already initialised (a real one must not be shadowed)."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised; the "
                           "fake world needs the process to itself")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device: str | torch.device | None = None):
    """A ``DeviceMesh`` of ``shape`` with dim names ``names`` over the
    initialised default group, which must have ``prod(shape)`` ranks;
    ``device`` is the card (default) or ``"cpu"``."""
    from torch.distributed.device_mesh import init_device_mesh
    dev = _device.get_device(device)
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(f"a {tuple(shape)} mesh needs a process group "
                           f"of {n} ranks, found {have}")
    return init_device_mesh(dev.type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(multi_pod: bool = False,
                         device: str | torch.device | None = None):
    """The reference's production topology: (16, 16) ``("data",
    "model")``, or (2, 16, 16) ``("pod", "data", "model")``, over the
    initialised group (:func:`fake_world` of 256 or 512 ranks)."""
    shape, names = PRODUCTION_MESHES[multi_pod]
    return make_mesh(shape, names, device)
