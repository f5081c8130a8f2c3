#!/usr/bin/env python3
"""Times of the port's ``running_max`` and ``decoupled_gather`` on one
NVIDIA GPU, for one tree of the port, so that two trees can be compared on
one card.

    python3 scripts/kernel_times.py [--src DIR]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed (this
checkout's by default; an unpacked older commit's to compare).  Run the
trees in turns in one session (A, B, B, A): cards and power limits differ
between machines.  Uses only calls both designs have (``running_max(x)``,
``engine.running_max(a)``, ``decoupled_gather(idx, table)``).  Prints one
JSON line:

* ``running_max_ms``: the kernel on 2^20 int32 (``chip_smoke.py`` phase
  2's trending array), median of 20 replays of a CUDA graph of 10 calls;
* ``round_trip_ms``: the torch engine's ``running_max`` on the same numpy
  array, host clock, median of 10 calls (in place and idempotent, so
  every call repeats the same work), and ``round_trip_device``: one call
  under ``torch.profiler`` (``chip_smoke.profiled``), its summed
  host-to-device copies, kernels and device-to-host copies and their
  union, in ms of device time;
* ``gather_ms`` / ``index_select_ms``: ``decoupled_gather`` (tanh(2*row))
  and ``torch.index_select`` of 4,096 random rows of a random
  49,152 x 576 bf16 table (phase 7's shape), graph replays as above;
* ``card``: ``nvidia-smi``'s name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import cuda_ms, host_ms, profiled  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="the src directory whose repro_torch is timed")
    src = os.path.abspath(ap.parse_args().src)
    sys.path.insert(0, src)
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device")
    import repro_torch
    from repro_torch.core import engine
    from repro_torch.kernels import decoupled_gather, running_max

    dev = torch.device("cuda")
    repro_torch.set_device(dev)
    rng = np.random.default_rng(0)
    n = 1 << 20
    a = (rng.integers(0, 1000, n)
         - np.cumsum(rng.integers(1, 9, n))).astype(np.int32)
    t = torch.from_numpy(a).to(dev)
    rmax_ms = cuda_ms(lambda: running_max(t))
    buf = a.copy()
    with engine.use("torch"):
        engine.running_max(buf)
        if not np.array_equal(buf, np.maximum.accumulate(a)):
            sys.exit("engine round trip != np.maximum.accumulate")
        trip_ms = host_ms(lambda: engine.running_max(buf))
        p = profiled(lambda: engine.running_max(buf),
                     "kernel_times_round_trip")

    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn((49152, 576), generator=gen, device=dev).bfloat16()
    idx = torch.randint(0, 49152, (4096,), generator=gen, device=dev,
                        dtype=torch.int32)
    gather_ms = cuda_ms(lambda: decoupled_gather(idx, table))
    select_ms = cuda_ms(lambda: torch.index_select(table, 0, idx))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"src": os.path.relpath(src, ROOT),
                      "running_max_ms": rmax_ms, "round_trip_ms": trip_ms,
                      "round_trip_device": {k: p[k] for k in (
                          "h2d", "kernels", "d2h", "busy")},
                      "gather_ms": gather_ms,
                      "index_select_ms": select_ms, "card": card}),
          flush=True)


if __name__ == "__main__":
    main()
