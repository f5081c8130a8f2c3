"""Table II on the port: what the template costs in channels and ops.

The port of the reference's ``benchmarks/paper_table2.py``.  FPGA
LUT/FF/BRAM numbers have no GPU meaning; the rows are what the reference
computes from its partitioner, for the four Table-I loop bodies:

  * op counts and the channel (FIFO) count and width per token — the
    paper's "communication channels always add cost";
  * duplicated ops (§III-B1: compute traded for channels);
  * ops per stage of the decoupled program, and op instances with and
    without the duplicates (the area analogue).

The reference's docstring also names an "XLA program size" column, but
its ``analyze_kernel`` computes none, so neither does the port.  Each
body goes through the port's own front end (``torch.fx``) and
partitioner on the port's device; every field equals the reference's.

Run::

    python -m repro_torch.workloads.table2              # on the card
    python -m repro_torch.workloads.table2 --device cpu

The rows go to ``build/paper_table2_torch.json``; the reference's
``experiments/paper_table2.json`` is never written.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Callable

from .. import _device
from ..core import CDFG, decouple, partition_cdfg
from . import ALL_KERNELS

DEFAULT_OUT = os.path.join("build", "paper_table2_torch.json")


def analyze_kernel(name: str, mk: Callable[..., Any],
                   device: Any = None) -> dict:
    """One row: the body ``mk(device=...)`` builds, traced in loop mode
    and partitioned by the paper's policy and by the fused one."""
    k = mk(device=device)
    cdfg = CDFG.from_loop_body(
        k.loop_body, k.carry_example, *k.body_args,
        nonaliasing_carries=k.nonaliasing_carries)
    paper = partition_cdfg(cdfg, policy="paper")
    fused = partition_cdfg(cdfg, policy="fused")
    prog = decouple(paper)
    return {
        "kernel": name,
        "nodes": len(cdfg.nodes),
        "stages_dataflow": paper.num_stages,
        "stages_conventional": fused.num_stages,
        "channels": len(paper.channels),
        "channel_bytes_per_token": sum(c.nbytes for c in paper.channels),
        "duplicated_ops": len(paper.duplicated),
        "ops_per_stage": [sp.eqn_count for sp in prog.stages],
        # area analogue: total op instances = original + duplicated copies
        "op_instances_conventional": len(cdfg.nodes),
        "op_instances_dataflow": len(cdfg.nodes) + sum(
            len(v) for v in paper.duplicated.values()),
    }


def table(rows: list[dict]) -> str:
    """The reference's printed table of ``rows``."""
    lines = [f"{'kernel':<16}{'stages':>7}{'chans':>7}{'chanB':>7}"
             f"{'dup':>5}{'ops(conv)':>10}{'ops(df)':>9}"]
    for r in rows:
        lines.append(f"{r['kernel']:<16}{r['stages_dataflow']:>7}"
                     f"{r['channels']:>7}{r['channel_bytes_per_token']:>7}"
                     f"{r['duplicated_ops']:>5}"
                     f"{r['op_instances_conventional']:>10}"
                     f"{r['op_instances_dataflow']:>9}")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.workloads.table2",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help="JSON output path (default %(default)s; '' to "
                         "write nothing)")
    args = ap.parse_args(argv)
    device = _device.get_device(args.device)
    _device.set_device(device)
    rows = [analyze_kernel(n, mk, device) for n, mk in ALL_KERNELS.items()]
    print(table(rows))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return {"rows": rows}


if __name__ == "__main__":
    main()
