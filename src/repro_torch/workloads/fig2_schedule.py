"""Fig. 2 on the port: the execution schedule, rendered.

The port of the reference's ``benchmarks/fig2_schedule.py``.  The
paper's Fig. 2 contrasts the conventional engine (every miss stalls
everything) with the dataflow engine (stalls localized to the fetch
stage, shadowed by the long-latency compute stage).  This renders the
same comparison as an ASCII Gantt chart from the port's simulator —
per-stage start/finish times for the first iterations of an SpMV-like
pipeline.  The text is the reference's, character for character.

Run::

    python -m repro_torch.workloads.fig2_schedule               # on the card
    python -m repro_torch.workloads.fig2_schedule --device cpu

``--device`` sets the port's device policy, which the resolution engine
follows (``$REPRO_TORCH_ENGINE``, auto = ``torch`` on the card); twelve
iterations stay below the engine's torch threshold, so no kernel is
launched.  Nothing is written.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import _device
from ..core.simulator import (MemAccess, SimStage, acp,
                              simulate_conventional, simulate_dataflow)


def _gantt(starts: np.ndarray, finishes: np.ndarray, names: list[str],
           n_iters: int, width: int = 100) -> str:
    t_max = finishes.max()
    scale = width / max(1, t_max)
    lines = []
    for s, name in enumerate(names):
        row = [" "] * (width + 1)
        for i in range(n_iters):
            a = int(starts[s, i] * scale)
            b = max(a + 1, int(finishes[s, i] * scale))
            ch = chr(ord("0") + i % 10)
            for x in range(a, min(b, width)):
                row[x] = ch
        lines.append(f"{name:>8} |{''.join(row)}")
    lines.append(f"{'':>8} +{'-' * width}> cycles (0..{int(t_max)})")
    return "\n".join(lines)


def render() -> str:
    """The Fig. 2 text: the dataflow engine's Gantt chart of 12
    iterations on the ACP memory, then the conventional engine's cycles
    for the same iterations."""
    rng = np.random.default_rng(0)
    n = 12
    # an SpMV-like pipeline: sequential index fetch → random x fetch →
    # long-latency FMA → sequential store
    stages = [
        SimStage("idx", ii=1, latency=2,
                 accesses=[MemAccess("cols", np.arange(n) * 4)]),
        SimStage("fetch", ii=1, latency=2,
                 accesses=[MemAccess("x",
                                     rng.integers(0, 4 << 20, n) * 4)]),
        SimStage("fma", ii=6, latency=8),
        SimStage("store", ii=1, latency=2,
                 accesses=[MemAccess("y", np.arange(n) * 4,
                                     is_store=True)]),
    ]
    df, start, finish = simulate_dataflow(stages, acp(), n,
                                          return_schedule=True)
    cv = simulate_conventional(
        [SimStage("fused", ii=max(s.ii for s in stages),
                  latency=sum(s.latency for s in stages),
                  accesses=[a for s in stages for a in s.accesses])],
        acp(), n)
    return "\n".join([
        "Dataflow engine (Fig. 2 bottom): stalls stay inside 'fetch';",
        "'fma' streams at its II once the FIFO fills.\n",
        _gantt(start, finish, [st.name for st in stages], n),
        f"\nConventional engine (Fig. 2 top): {cv.cycles} cycles for the "
        f"same {n} iterations — {cv.cycles / max(1, df.cycles):.1f}x "
        f"slower (every access serializes into the single schedule)."])


def main(argv: list[str] | None = None) -> str:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "repro_torch.workloads.fig2_schedule",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    _device.set_device(_device.get_device(args.device))
    text = render()
    print(text)
    return text


if __name__ == "__main__":
    main()
