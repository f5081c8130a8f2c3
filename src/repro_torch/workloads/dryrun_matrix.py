"""Resumable dry-run matrix: every (arch × shape × mesh) cell, skipping
cells whose record already exists in the output directory.

The port of the reference's ``benchmarks/dryrun_matrix.py``.

Run:  python -m repro_torch.workloads.dryrun_matrix [--out build/dryrun]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import os

from ..configs.base import ARCH_IDS, SHAPES
from ..launch.dryrun import MESH_NAMES, run_cell


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.workloads.dryrun_matrix",
        description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default="build/dryrun")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu': the meshes' device")
    args = p.parse_args(argv)
    n_done = n_run = 0
    for arch in ARCH_IDS:
        for shape in SHAPES:
            for multi_pod in (False, True):
                cell = f"{arch}__{shape}__{MESH_NAMES[multi_pod]}"
                if os.path.exists(os.path.join(args.out, f"{cell}.json")):
                    n_done += 1
                    continue
                run_cell(arch, shape, multi_pod=multi_pod, out_dir=args.out,
                         device=args.device)
                n_run += 1
    print(f"matrix complete: {n_run} ran, {n_done} already present")


if __name__ == "__main__":
    main()
