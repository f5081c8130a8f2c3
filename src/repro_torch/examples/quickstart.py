"""Quickstart: the dataflow architectural template in five minutes.

Run:  ``python -m repro_torch.examples.quickstart [--device cpu]``

1. Decorate an ordinary torch function with ``dataflow_jit`` — the
   compiler driver traces it into a CDFG, runs Algorithm 1 partitioning,
   decouples access from execute, and schedules the stage pipeline.
2. Inspect the pass pipeline's product with ``.report()``.
3. Execute through every backend — ``sequential`` (stage replay),
   ``emulated`` (tick-exact systolic schedule), ``eager`` (the fused
   baseline: the function unchanged) — each equal to the direct call.
   ``systolic`` (stage *s* on rank *s*) needs one process per stage, so in
   one process it is reported unavailable.
4. Stream microbatches through the pipeline (the paper's Fig. 2 schedule).
5. Simulate the Zynq-like memory system to see WHY decoupling wins (Fig. 5).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

import torch.distributed as dist

from .. import _device
from ..dataflow import dataflow_jit

#: the reference quickstart's backends, in its order (``xla`` is the
#: port's ``eager``: both run the function unchanged)
BACKENDS = ("emulated", "sequential", "systolic", "eager")


# -- 1. a kernel with the paper's pathology: a data-dependent gather
#       feeding long-latency floating-point compute
@dataflow_jit(stream_argnums=(1,))
def kernel(table, idx, w):
    g = table[idx]               # irregular load (cache-miss prone)
    h = g * w                    # long-latency fp multiply
    return torch.tanh(h) + 1.0   # more long-latency compute


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(prog="python -m "
                                 "repro_torch.examples.quickstart")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    dev = _device.get_device(ap.parse_args(argv).device)
    _device.set_device(dev)
    table = torch.arange(1024, dtype=torch.float32, device=dev)
    idx = torch.tensor([3, 997, 41, 512, 7, 800, 64, 2], device=dev)
    w = torch.tensor(1.5, device=dev)

    # -- 2. the compiled artifact: CDFG -> Algorithm 1 -> stages -> schedule
    compiled = kernel.lower(table, idx, w)
    print(compiled.cdfg.summary(), "\n")
    print(compiled.report(), "\n")

    # -- 3. every execution backend == the direct (untransformed) call
    ref = kernel.__wrapped__(table, idx, w).cpu().numpy()
    for name in BACKENDS:
        if name not in compiled.backends():
            n = dist.get_world_size() if dist.is_initialized() else 1
            print(f"backend {name:<10}: unavailable ({n} process"
                  f"{'es' * (n > 1)}; one stage per rank, "
                  f"{compiled.num_stages} ranks needed)")
            continue
        got = kernel(table, idx, w, backend=name).cpu().numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6)
        print(f"backend {name:<10}: OK (== direct call)")
    print()

    # -- 4. stream microbatches through the systolic pipeline
    T = 6
    idx_stream = torch.stack([(idx + t) % 1024 for t in range(T)])
    outs = compiled.stream(table, idx_stream, w)
    ref_stream = np.stack(
        [kernel.__wrapped__(table, idx_stream[t], w).cpu().numpy()
         for t in range(T)])
    np.testing.assert_allclose(outs.cpu().numpy(), ref_stream, rtol=1e-6)
    print(f"systolic stream ({compiled.num_stages} stages, "
          f"{T} microbatches): OK\n")

    # -- 5. why it wins: the Fig. 2/5 schedule report
    report = compiled.simulate(n_iters=3000, microbatches=6)
    print(report.summary())


if __name__ == "__main__":
    main()
