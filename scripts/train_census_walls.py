#!/usr/bin/env python3
"""The train census's walls and the lowered train step's size, for one
tree of the port, so that two trees can be compared on one machine.

    python3 scripts/train_census_walls.py [--src DIR] [--device cpu]

``--src`` names the ``src`` directory whose ``repro_torch`` is measured
(this checkout's by default; an unpacked older commit's to compare).
For every architecture, ``launch.dryrun.dataflow_census`` of its
``train_4k`` cell at published widths on ``meta`` runs twice (the first
run pays for the imports and caches); then SmolLM-135M's train step as
``dryrun.train_compiled`` lowers it at 2 sequences of 512 tokens (phase
16b's shape), on ``meta``, in fp32 and bf16.  Prints one JSON line:

* ``census``: for each architecture, the two walls (s, host clock) and
  its ops, stages and channels;
* ``lowered``: for each dtype, the top-level equations, those of the
  forward and reverse ``scan`` bodies of lowered graphs, and the
  equations the reverse scans replay in one step (a nested scan's as
  often as it steps);
* ``device``: ``nvidia-smi``'s name and power limit, or the CPU.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time


def main() -> None:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--src", default=os.path.join(root, "src"))
    p.add_argument("--device", default=None,
                   help="'cpu' to run where there is no card")
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    import repro_torch
    from repro_torch.configs import ARCH_IDS, load_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core import cdfg
    from repro_torch.launch import dryrun
    repro_torch.set_device(args.device)
    sys.path.insert(1, root)
    from chip_smoke import replayed    # after --src's repro_torch

    census = {}
    for arch in ARCH_IDS:
        walls = []
        for _ in range(2):
            t0 = time.perf_counter()
            got = dryrun.dataflow_census(load_config(arch), "train_4k")
            walls.append(round(time.perf_counter() - t0, 3))
        census[arch] = dict(walls_s=walls, ops=got["ops"],
                            stages=got["stages"], channels=got["channels"])

    lowered = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(load_config("smollm-135m"), dtype=dtype)
        g = dryrun.train_compiled(cfg, InputShape("train", 512, 2,
                                                  "train")).graph
        loops = [e for e in g.eqns if e.prim == "scan"
                 and getattr(e.impl, "func", None) is cdfg._run_loop]
        rev = [e for e in loops if e.impl.keywords.get("reverse")]
        fwd = [e for e in loops if not e.impl.keywords.get("reverse")]
        lowered[dtype] = dict(
            equations=len(g.eqns),
            forward_body=[len(e.impl.args[0].eqns) for e in fwd],
            reverse_body=[len(e.impl.args[0].eqns) for e in rev],
            replayed=sum(map(replayed, rev)))
    try:
        device = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        device = "cpu"
    print(json.dumps(dict(census=census, lowered=lowered, device=device)))


if __name__ == "__main__":
    main()
