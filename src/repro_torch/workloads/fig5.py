"""Fig. 5 on the port: conventional vs dataflow accelerators vs ARM core.

The port of the reference harness (``benchmarks/paper_fig5.py``), on the
port's compiler driver, simulator and resolution engine.  Per kernel:

  1. trace the loop body → cyclic CDFG (carry back-edges),
  2. Algorithm 1 partition,
  3. derive SimStages (II/latency from the partition, memory-SCC stages
     detected automatically, traces attached to memory stages in
     pipeline order),
  4. simulate the three machines over four memory configs (ACP,
     ACP+64KB, HP, HP+64KB) at the full Table-I iteration counts
     (``--quick``: the small window, extrapolated).

Cycles equal the reference's numpy engine on every engine: the engine
(``$REPRO_TORCH_ENGINE``, see :mod:`repro_torch.core.engine`) changes
only the wall clock — ``torch`` runs the wavefront solver's running max
and the N-way cache replay on the card.  Per kernel, one task simulates
the dataflow machine on all four memory configs at once, one the
conventional engine, and one the processor baseline; tasks run
longest-first in a spawn pool of ``--jobs`` processes, each set up with
the parent's device and engine.  ``--workers N`` shards each dataflow
task's resolution over the chunk-graph executor, ``--server auto`` sends
it to the resolution daemon.

Run::

    python -m repro_torch.workloads.fig5                    # on the card
    python -m repro_torch.workloads.fig5 --workers 4        # sharded
    python -m repro_torch.workloads.fig5 --server auto      # via the daemon
    python -m repro_torch.workloads.fig5 --quick --kernels knapsack dfs \\
        --device cpu

The result goes to ``build/paper_fig5_torch.json``; the reference's
``experiments/paper_fig5.json`` and ``BENCH_sim.json`` are never written.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import time
from typing import Any

import numpy as np

from .. import _device
from ..core import engine as _engine
from ..core.simulator import (simulate_conventional_many,
                              simulate_dataflow_many, simulate_processor,
                              standard_memory_models)
from ..dataflow import compile as dataflow_compile
from ..dataflow import fused_stage
from . import ALL_KERNELS

MEM_NAMES = ("ACP", "ACP+64KB", "HP", "HP+64KB")
SPMV_SCALE = 0.125  # correctness-data scale; traces are full-size anyway
#: The template's FIFO sizing rule: depth must cover the latency a channel
#: has to hide — worst access latency plus stage latency, with margin
#: (§III-B2).
FIFO_DEPTH = 256
MAX_OUTSTANDING = 16  # the paper's "multiple outstanding requests"
DEFAULT_OUT = os.path.join("build", "paper_fig5_torch.json")


def _dataflow_mems() -> dict:
    mems = {}
    for mn, mk in standard_memory_models().items():
        m = mk()
        m.max_outstanding = MAX_OUTSTANDING
        mems[mn] = m
    return mems


def build_stages(k: Any):
    """(dataflow stages, conventional stage) from the compiler driver, on
    the device the workload's tensors live on.  The full-scale windowed
    traces are attached, so a shorter run is an exact prefix of the
    full one."""
    compiled = dataflow_compile(
        k.loop_body, k.carry_example, *k.body_args, loop=True,
        nonaliasing_carries=k.nonaliasing_carries, device=k.device)
    df_stages = compiled.sim_stages(traces=list(k.full_traces.values()))
    return df_stages, [fused_stage(df_stages)]


def make_kernel(kname: str, device: Any = None) -> Any:
    mk = ALL_KERNELS[kname]
    return mk(SPMV_SCALE, device=device) if kname == "spmv" \
        else mk(device=device)


def _n_iters(k: Any, full: bool, max_iters: int | None) -> int:
    n = k.n_iters_full if full else k.n_iters_sim
    return min(n, max_iters) if max_iters else n


def _runtime(r: Any, k: Any, n: int) -> float:
    """Seconds for the whole Table-I count: simulated, or extrapolated
    from a prefix of ``n`` iterations."""
    return r.runtime_s if n == k.n_iters_full \
        else r.scaled_runtime(k.n_iters_full)


def run_kernel(k: Any, *, full: bool = False) -> dict:
    """Single-kernel, in-process version of the grid (tests / notebooks).

    ``full=False`` simulates the small window and extrapolates;
    ``full=True`` simulates all Table-I iterations."""
    n = _n_iters(k, full, None)
    traces = list(k.full_traces.values())
    df_stages, conv_stages = build_stages(k)
    base = simulate_processor(k.instrs_per_iter, traces, n)
    t_base = _runtime(base, k, n)
    out: dict = {"kernel": k.name,
                 "stages": len(df_stages),
                 "n_iters_simulated": n,
                 "n_iters_full": k.n_iters_full,
                 "fully_simulated": bool(full),
                 "baseline_s": t_base}
    dfs = simulate_dataflow_many(df_stages, _dataflow_mems(), n,
                                 fifo_depths=(FIFO_DEPTH,),
                                 collect_stalls=False)
    cvs = simulate_conventional_many(
        conv_stages, {mn: mk() for mn, mk in
                      standard_memory_models().items()}, n)
    for name in MEM_NAMES:
        t_df = _runtime(dfs[(name, FIFO_DEPTH)], k, n)
        t_cv = _runtime(cvs[name], k, n)
        out[name] = {
            "dataflow_s": t_df,
            "conventional_s": t_cv,
            "dataflow_vs_baseline": t_base / t_df,
            "conventional_vs_baseline": t_base / t_cv,
            "dataflow_vs_conventional": t_cv / t_df,
        }
    return out


def _worker_init(device: Any, engine: str) -> None:
    """A spawned worker starts with the port's defaults, not its parent's
    choices: give it the parent's device and engine."""
    _device.set_device(device)
    _engine.select(engine)


def _sim_task(task: tuple) -> tuple:
    """One (kernel, machine) group, all four memory configs resolved in
    one shared pass — a top-level function, so a spawn pool can run it.
    Returns the results, the task's seconds and the part of them spent
    before simulating (building the workload and compiling its body; in
    a fresh process also the imports and the device's start-up)."""
    kname, what, full, max_iters, workers, server = task
    t0 = time.perf_counter()
    k = make_kernel(kname)
    n = _n_iters(k, full, max_iters)
    traces = list(k.full_traces.values())
    stages = build_stages(k) if what != "processor" else None
    setup = time.perf_counter() - t0
    if what == "processor":
        r = {"": simulate_processor(k.instrs_per_iter, traces, n)}
    elif what == "dataflow":
        grid = simulate_dataflow_many(stages[0], _dataflow_mems(), n,
                                      fifo_depths=(FIFO_DEPTH,),
                                      collect_stalls=False,
                                      workers=workers, server=server)
        r = {mn: grid[(mn, FIFO_DEPTH)] for mn in MEM_NAMES}
    else:
        r = simulate_conventional_many(
            stages[1], {mn: mk() for mn, mk in
                        standard_memory_models().items()}, n)
    return kname, what, r, time.perf_counter() - t0, setup


#: Rough relative cost of a machine group, for longest-first scheduling.
_MACHINE_WEIGHT = {"dataflow": 3.0, "conventional": 1.2, "processor": 1.0}


def run_all(*, full: bool = True, jobs: int | None = None,
            kernels: tuple[str, ...] | None = None,
            max_iters: int | None = None,
            workers: int | None = None,
            server: str | None = None,
            ) -> tuple[dict, dict, int]:
    """The grid; returns (per-kernel results, per-task seconds, jobs);
    each task's seconds are ``{"total": s, "setup": s}``.

    ``max_iters`` caps every kernel's simulated iterations (a prefix of
    its traces; times are extrapolated to the Table-I count, cycles are
    the prefix's).  Each kernel's result adds its cycle counts to the
    reference's fields (``dataflow_cycles``, ``conventional_cycles`` per
    memory, ``baseline_cycles``).  ``jobs=1`` runs in this process.

    ``workers`` shards each dataflow task's trace resolution over the
    chunk-graph executor (default: the reference's heuristic,
    :func:`~repro_torch.core.chunkgraph.default_workers` — the cores left
    over by the task pool, 1 below 4 cores or in quick mode); ``server``
    resolves them through the resolution daemon (``"auto"`` finds or
    spawns the store's daemon).  Cycles are the same either way."""
    from ..core.chunkgraph import default_workers
    kernels = tuple(kernels or ALL_KERNELS)
    if jobs is None:
        jobs = min(multiprocessing.cpu_count() + 1, 4) if full \
            else min(2, multiprocessing.cpu_count())
    workers = default_workers(jobs=jobs, explicit=workers, full=full)
    if server == "auto":
        from ..serve import ensure_daemon
        server = ensure_daemon()
    sizes = {kn: make_kernel(kn, "cpu").n_iters_full if full else 1
             for kn in kernels}
    tasks = [(kn, what, full, max_iters, workers, server) for kn in kernels
             for what in ("dataflow", "conventional", "processor")]
    tasks.sort(key=lambda t: -min(sizes[t[0]], max_iters or sizes[t[0]])
               * _MACHINE_WEIGHT[t[1]])
    sims: dict[tuple, Any] = {}
    task_s: dict[str, float] = {}
    pool = (multiprocessing.get_context("spawn").Pool(
        jobs, _worker_init, (_device.get_device(), _engine.current()))
        if jobs > 1 else None)
    try:
        results = (pool.imap_unordered(_sim_task, tasks) if pool
                   else map(_sim_task, tasks))
        for kn, what, group, dt, setup in results:
            for mn, r in group.items():
                sims[(kn, what, mn)] = r
            task_s[f"{kn}/{what}"] = {"total": dt, "setup": setup}
            print(f"  [{kn}] {what:<12} all-mems ({dt:.1f}s, set-up "
                  f"{setup:.1f}s)", flush=True)
    finally:
        if pool is not None:
            pool.close()
            pool.join()

    results_out: dict[str, dict] = {}
    for kn in kernels:
        k = make_kernel(kn, "cpu")
        n = _n_iters(k, full, max_iters)
        base = sims[(kn, "processor", "")]
        t_base = _runtime(base, k, n)
        out: dict = {"kernel": kn,
                     "n_iters_simulated": n,
                     "n_iters_full": k.n_iters_full,
                     "fully_simulated": n == k.n_iters_full,
                     "baseline_s": t_base,
                     "baseline_cycles": base.cycles}
        for mn in MEM_NAMES:
            df = sims[(kn, "dataflow", mn)]
            cv = sims[(kn, "conventional", mn)]
            t_df, t_cv = _runtime(df, k, n), _runtime(cv, k, n)
            out[mn] = {
                "dataflow_s": t_df,
                "conventional_s": t_cv,
                "dataflow_cycles": df.cycles,
                "conventional_cycles": cv.cycles,
                "dataflow_vs_baseline": t_base / t_df,
                "conventional_vs_baseline": t_base / t_cv,
                "dataflow_vs_conventional": t_cv / t_df,
            }
        results_out[kn] = out
    return results_out, task_s, jobs


def best_vs_best(r: dict) -> float:
    """Paper §V-A: best dataflow config vs best conventional config."""
    best_df = min(r[m]["dataflow_s"] for m in MEM_NAMES)
    best_cv = min(r[m]["conventional_s"] for m in MEM_NAMES)
    return best_cv / best_df


def summarize(results: dict) -> dict:
    """Aggregate the paper's headline numbers from the per-kernel table."""
    pipelineable = [r for n, r in results.items() if n != "dfs"]
    conv_cache_cut = np.mean(
        [1 - r["ACP+64KB"]["conventional_s"] / r["ACP"]["conventional_s"]
         for r in pipelineable])
    df_cache_cut = np.mean(
        [1 - r["ACP+64KB"]["dataflow_s"] / r["ACP"]["dataflow_s"]
         for r in pipelineable])
    summary = {
        "dataflow_vs_conventional_best": {
            n: best_vs_best(r) for n, r in results.items()},
        "avg_best_gain_pipelineable": float(np.mean(
            [best_vs_best(r) for r in pipelineable])),
        "avg_dataflow_vs_baseline_acp_pipelineable": float(np.mean(
            [r["ACP"]["dataflow_vs_baseline"] for r in pipelineable])),
        "conv_runtime_cut_by_cache": float(conv_cache_cut),
        "df_runtime_cut_by_cache": float(df_cache_cut),
        "conv_hp_vs_acp_slowdown": float(np.mean(
            [r["HP"]["conventional_s"] / r["ACP"]["conventional_s"]
             for r in pipelineable])),
    }
    if "dfs" in results:
        summary["dfs_best_gain"] = float(best_vs_best(results["dfs"]))
    return summary


def main(out_path: str | None = DEFAULT_OUT, *, quick: bool = False,
         jobs: int | None = None, kernels: tuple[str, ...] | None = None,
         rescache: bool = True, workers: int | None = None,
         server: str | None = None) -> dict:
    if not rescache:
        # spawn-pool workers inherit the environment, not configure()
        os.environ["REPRO_RESCACHE"] = "0"
        from ..core import rescache as _rc
        _rc.configure(enabled=False)
    full = not quick
    mode = ("fully simulated (Table-I iteration counts)" if full
            else "extrapolated from a small window (--quick)")
    print(f"Fig. 5 grid — {mode}; device {_device.get_device()}, engine "
          f"{_engine.current()}")
    t0 = time.perf_counter()
    results, task_s, _ = run_all(full=full, jobs=jobs, kernels=kernels,
                                 workers=workers,
                                 server=server)
    wall_s = time.perf_counter() - t0
    summary = summarize(results)
    print(f"\n{'kernel':<16}{'mem':<10}{'conv/base':>10}{'df/base':>10}"
          f"{'df/conv':>10}")
    for name, r in results.items():
        for m in MEM_NAMES:
            print(f"{name:<16}{m:<10}"
                  f"{r[m]['conventional_vs_baseline']:>10.2f}"
                  f"{r[m]['dataflow_vs_baseline']:>10.2f}"
                  f"{r[m]['dataflow_vs_conventional']:>10.2f}")
    print(f"\nwall-clock: {wall_s:.1f}s")
    print("summary:", json.dumps(summary, indent=1))
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump({"results": results, "summary": summary,
                       "wall_s": wall_s, "task_s": task_s}, f, indent=1,
                      default=float)
    return {"results": results, "summary": summary, "wall_s": wall_s}


def cli(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="small-window extrapolated mode (development)")
    ap.add_argument("--jobs", type=int, default=None)
    ap.add_argument("--kernels", nargs="*", default=None,
                    choices=tuple(ALL_KERNELS))
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--no-rescache", action="store_true",
                    help="bypass the resolved-trace cache (cold timings)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--workers", type=int, default=None,
                    help="shard each dataflow task's resolution over N "
                         "processes (default: the cores the task pool "
                         "leaves; 1 below 4 cores or with --quick)")
    ap.add_argument("--server", default=None,
                    help="resolve through the resolution daemon: 'auto' "
                         "(find or spawn the store's) or an address")
    a = ap.parse_args(argv)
    if a.device:
        _device.set_device(a.device)
    _device.get_device()          # a card asked for and absent raises here
    return main(a.out, quick=a.quick, jobs=a.jobs,
                kernels=tuple(a.kernels) if a.kernels else None,
                rescache=not a.no_rescache,
                workers=a.workers, server=a.server)


if __name__ == "__main__":
    cli()
