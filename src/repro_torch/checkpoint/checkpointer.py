"""Checkpointing: atomic, async, keep-N.

The port of the reference's ``checkpoint/checkpointer.py``, with its
fault-tolerance contract:

* **atomic** — writes go to ``step_XXXXXXXX.tmp`` then ``os.replace`` to
  the final name; a crash mid-write never corrupts the latest checkpoint;
* **async** — ``save()`` snapshots to host memory synchronously and
  writes to disk on a background thread; ``wait()`` joins;
* **keep-N** — older checkpoints are garbage-collected after a
  successful write (never before).

Format: one ``step_XXXXXXXX.npz`` per checkpoint plus a JSON manifest
(step, leaf names, dtypes).  A leaf's name is its path in the tree
(``params/segment_0/1/0/mixer/w_q``): the file holds the port's tree,
one entry per repeat of a segment, not the reference's stacked one.
bfloat16 leaves, which numpy cannot hold, are stored as their 16-bit
patterns with the dtype in the manifest, and restored bit for bit.

Sharded states (elastic checkpoints): a state whose leaves are DTensors
is saved whole, as the reference writes whole arrays — every rank calls
``save`` at the same step, each gathers every DTensor leaf on the
calling thread (``core/collectives.full_tensor``, host-staged where
gloo carries the ranks' CUDA shards, is a collective, which must not run
on the writer thread), only global rank 0 writes, and ``wait`` ends with a
barrier of the default group, after which every rank sees the step.
``restore(shardings=)`` places each leaf by a tree of
``runtime.sharding.NamedSharding`` on the *current* mesh, each rank
taking its own chunk without communicating, so a state saved on one
mesh restores onto another.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from .. import _device, tree
from ..core import collectives
from ..runtime.sharding import is_dtensor


def _flatten_with_names(state: Any) -> list[tuple[str, Any]]:
    return [("/".join(str(k) for k in path), leaf)
            for path, leaf in tree.flatten_with_paths(state)]


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A copy of ``t`` on the host; bfloat16 as its int16 bit patterns."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


@dataclasses.dataclass
class Checkpointer:
    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        #: the write in flight is of a sharded state: ``wait`` meets the
        #: other ranks at a barrier
        self._sharded = False

    # -- save -----------------------------------------------------------------

    def save(self, step: int, state: Any, *, blocking: bool = False) -> None:
        """Snapshot now, write in the background.  A state with DTensor
        leaves is gathered whole here (every rank must call ``save``) and
        written by global rank 0 alone."""
        self.wait()  # one in-flight write at a time
        named = _flatten_with_names(state)
        sharded = any(is_dtensor(leaf) for _, leaf in named)
        writer = not sharded or dist.get_rank() == 0
        host = {}
        for name, leaf in named:
            if is_dtensor(leaf):        # a collective: on this thread
                leaf = collectives.full_tensor(leaf)
            if writer:
                host[name] = _to_host(leaf)
        self._sharded = sharded
        if not writer:
            if blocking:
                self.wait()
            return
        manifest = {
            "step": int(step),
            "names": [n for n, _ in named],
            "dtypes": {n: str(leaf.dtype).removeprefix("torch.")
                       for n, leaf in named},
        }

        def write():
            try:
                tmp = os.path.join(self.directory, f"step_{step:08d}.tmp")
                final = os.path.join(self.directory, f"step_{step:08d}.npz")
                with open(tmp, "wb") as f:
                    np.savez(f, **host)
                os.replace(tmp, final)
                mtmp = os.path.join(self.directory,
                                    f"step_{step:08d}.json.tmp")
                mfinal = os.path.join(self.directory,
                                      f"step_{step:08d}.json")
                with open(mtmp, "w") as f:
                    json.dump(manifest, f)
                os.replace(mtmp, mfinal)
                self._gc()
            except BaseException as e:  # surfaced on next save/wait
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        """Join the write in flight; after a sharded save, meet every rank
        of the default group at a barrier first (so the step is on disk
        for all), then raise the write's error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._sharded:
            self._sharded = False
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            for ext in (".npz", ".json"):
                p = os.path.join(self.directory, f"step_{s:08d}{ext}")
                if os.path.exists(p):
                    os.remove(p)

    # -- restore ----------------------------------------------------------------

    def all_steps(self) -> list[int]:
        steps = []
        for fn in os.listdir(self.directory):
            m = re.match(r"step_(\d+)\.npz$", fn)
            if m and os.path.exists(os.path.join(
                    self.directory, f"step_{int(m.group(1)):08d}.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, example_state: Any, step: int | None = None, *,
                shardings: Any | None = None) -> tuple[Any, int]:
        """Restore into the structure of ``example_state`` (its leaves may
        be ``meta`` tensors: only their shapes and dtypes are read).

        Without ``shardings`` each leaf goes to its example's device (the
        port's device for a ``meta`` example) in the example's dtype.
        ``shardings`` is a tree of the state's structure whose leaves are
        ``runtime.sharding.NamedSharding`` (``launch/steps.
        train_state_shardings``) or ``None``: a placed leaf becomes a
        DTensor on that sharding's mesh, this rank keeping its chunk with
        no communication (elastic restore onto the current mesh), in the
        dtype the checkpoint stores.  Raises ``ValueError`` when a stored
        shape differs from the example's, or the shardings name other
        leaves than the state."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        base = os.path.join(self.directory, f"step_{step:08d}")
        with open(base + ".json") as f:
            dtypes = json.load(f)["dtypes"]
        named = _flatten_with_names(example_state)
        placed = dict(_flatten_with_names(shardings)) \
            if shardings is not None else {}
        if shardings is not None and set(placed) != {n for n, _ in named}:
            raise ValueError(
                f"shardings and state differ in leaves: "
                f"{sorted(set(placed) ^ {n for n, _ in named})[:4]}")
        leaves = []
        with np.load(base + ".npz") as data:
            for name, example in named:
                arr = data[name]
                want = tuple(example.shape)
                if tuple(arr.shape) != want:
                    raise ValueError(
                        f"{name}: checkpoint shape {arr.shape} != {want}")
                t = torch.from_numpy(arr)
                if dtypes[name] == "bfloat16":
                    t = t.view(torch.bfloat16)
                if placed.get(name) is not None:
                    leaves.append(placed[name].distribute(t))
                    continue
                dev = _device.get_device() if example.is_meta \
                    else example.device
                leaves.append(t.to(dev, example.dtype))
        return tree.unflatten(example_state, leaves), step
