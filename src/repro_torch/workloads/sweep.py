"""Design-space sweep over the paper's kernels (Fig. 5, §V), on the port.

The port of the reference's ``benchmarks/sweep.py``, on the port's
compiler driver, simulator, resolution engine and daemon.  Grid: kernels
× memory models (ACP / HP, ±64 KB System Cache) × FIFO depths ×
``mem_in_scc`` modes, each point fully simulated at the Table-I
iteration counts, plus SpMV re-swept under the transformation catalog
(unroll 2 with coalescing).  Cycles equal the reference's numpy engine
on every engine; the engine (``$REPRO_TORCH_ENGINE``, auto = ``torch``
on the card) changes only the wall clock.

It also measures the simulator's own speed (vectorized vs the scalar
reference at 65,536 iterations, cycles asserted equal) and the chunk
graph's worker scaling, and ``--dse`` explores each kernel's partition
space (``Compiled.explore``) and records its cycles-vs-FIFO-bits Pareto
front; ``--dse-only`` skips the grid.

``--smoke`` runs the reduced grid (the first two kernels, ACP and
ACP+64KB, FIFO 8, 20,000 iterations, two port widths); the full sweep is
a batch job that ``--jobs`` / ``--kernels`` split.  Run::

    python -m repro_torch.workloads.sweep --smoke               # on the card
    python -m repro_torch.workloads.sweep --smoke --device cpu --jobs 1

Everything goes to ``build/sweep_torch.json`` (``--out``), one section
per part, and the resolved-trace store to ``build/rescache_torch`` unless
``$REPRO_RESCACHE_DIR`` names one; the reference's ``BENCH_sim.json`` is
never written.
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
from ..core.simulator import (MemAccess, SimStage, acp,
                              simulate_conventional, simulate_dataflow,
                              standard_memory_models)
from ..dataflow import compile as dataflow_compile
from . import ALL_KERNELS
from .fig5 import FIFO_DEPTH, MAX_OUTSTANDING, make_kernel

BENCH_PATH = os.path.join("build", "sweep_torch.json")
SMOKE_ITERS = 20_000
#: Full-scale sweep depths: both sized past the DRAM-spike threshold
#: (see fig5.FIFO_DEPTH) so billion-iteration runs stay on the solver's
#: fast path; the smoke grid exercises a shallow FIFO.
FIFO_DEPTHS = (128, 256)
SCC_MODES = ("auto",)


def update_bench(section: str, payload: dict,
                 path: str = BENCH_PATH) -> None:
    """Merge one section into the sweep's JSON file."""
    data = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            data = {}
    data[section] = payload
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(data, f, indent=1, default=float)


def _perf_pipeline(n: int) -> list[SimStage]:
    rng = np.random.default_rng(0)
    return [
        SimStage("addr", ii=1, latency=2,
                 accesses=[MemAccess("idx", np.arange(n) * 4)]),
        SimStage("fetch", ii=1, latency=2,
                 accesses=[MemAccess("x", rng.integers(0, 4 << 20, n) * 4),
                           MemAccess("w", rng.integers(0, 4 << 20, n) * 4)]),
        SimStage("fma", ii=6, latency=8),
        SimStage("store", ii=1, latency=2,
                 accesses=[MemAccess("y", np.arange(n) * 4,
                                     is_store=True)]),
    ]


def measure_perf(n: int = 65536) -> dict:
    """Vectorized-vs-reference timing at ``n`` iterations (identical
    cycle counts asserted)."""
    stages = _perf_pipeline(n)
    out: dict = {"n_iters": n}
    for label, mk in (("ACP", acp),):
        t0 = time.perf_counter()
        ref = simulate_dataflow(stages, mk(), n, fifo_depth=32,
                                reference=True)
        t1 = time.perf_counter()
        vec = simulate_dataflow(stages, mk(), n, fifo_depth=32)
        t2 = time.perf_counter()
        assert ref.cycles == vec.cycles, (ref.cycles, vec.cycles)
        cr0 = time.perf_counter()
        cref = simulate_conventional(stages, mk(), n, reference=True)
        cr1 = time.perf_counter()
        cvec = simulate_conventional(stages, mk(), n)
        cr2 = time.perf_counter()
        assert cref.cycles == cvec.cycles, (cref.cycles, cvec.cycles)
        out[label] = {
            "dataflow_cycles": vec.cycles,
            "conventional_cycles": cvec.cycles,
            "dataflow_reference_s": t1 - t0,
            "dataflow_vectorized_s": t2 - t1,
            "dataflow_speedup": (t1 - t0) / max(1e-9, t2 - t1),
            "conventional_reference_s": cr1 - cr0,
            "conventional_vectorized_s": cr2 - cr1,
            "conventional_speedup": (cr1 - cr0) / max(1e-9, cr2 - cr1),
            "vectorized_iters_per_s": n / max(1e-9, t2 - t1),
        }
    return out


def _worker_init(device: Any, engine: str) -> None:
    """A spawned worker takes its parent's device and engine."""
    _device.set_device(device)
    _engine.select(engine)


def _sweep_task(task: tuple) -> list[dict]:
    """Sweep one kernel over one memory model (top-level for spawn).

    Within the task ``Compiled.sweep`` shares all trace resolution across
    FIFO depths / SCC modes / port-knob variants.  Reduced (``--smoke``)
    runs use the full-scale traces at a truncated iteration count, and
    every row records ``n_iters_requested`` (the Table-I count) and
    ``n_iters_simulated``."""
    (kname, mem_name, fifo_depths, scc_modes, n_iters,
     wpcs, mos, workers, server, transform) = task
    k = make_kernel(kname)
    n = n_iters or k.n_iters_full
    compiled = dataflow_compile(
        k.loop_body, k.carry_example, *k.body_args, loop=True,
        nonaliasing_carries=k.nonaliasing_carries, transforms=transform,
        device=k.device)
    res = compiled.sweep(n_iters=n,
                         mems={mem_name: standard_memory_models()[mem_name]},
                         fifo_depths=fifo_depths, scc_modes=scc_modes,
                         traces=list(k.full_traces.values()),
                         max_outstanding=MAX_OUTSTANDING,
                         words_per_cycle=wpcs, max_outstandings=mos,
                         workers=workers, server=server)
    for row in res.rows:
        row["kernel"] = kname
        row["n_iters"] = n
        row["n_iters_requested"] = k.n_iters_full
        row["n_iters_simulated"] = n
        row["fully_simulated"] = n == k.n_iters_full
        row["trace_set"] = "full"
    return res.rows


def measure_worker_scaling(n: int | None = None) -> dict:
    """The chunk-graph worker-scaling probe: one cached-model pipeline
    resolved cold by the streaming engine (workers=1) and by the sharded
    executor at all cores, identical cycles asserted; each arm's engine
    phase walls."""
    from ..core import rescache as _rc
    from ..core.simulator import simulate_dataflow_many
    if n is None:
        n = 8 * _rc.CHUNK_ITERS
    stages = _perf_pipeline(n)
    cpus = multiprocessing.cpu_count()
    out = {"n_iters": n, "cpus": cpus, "engine": _engine.current()}
    mems = standard_memory_models()
    _engine.reset_walls()
    t0 = time.perf_counter()
    r1 = simulate_dataflow_many(
        stages, {"ACP+64KB": mems["ACP+64KB"]()}, n, fifo_depths=(64,),
        collect_stalls=False, use_rescache=False)
    out["workers1_s"] = time.perf_counter() - t0
    out["phases_workers1"] = _engine.walls()
    w = max(2, cpus)
    _engine.reset_walls()
    t0 = time.perf_counter()
    rw = simulate_dataflow_many(
        stages, {"ACP+64KB": mems["ACP+64KB"]()}, n, fifo_depths=(64,),
        collect_stalls=False, use_rescache=False, workers=w)
    out["workers_all_s"] = time.perf_counter() - t0
    out["phases_workers_all"] = _engine.walls()
    _engine.reset_walls()
    out["workers_all"] = w
    out["dataflow_cycles"] = r1[("ACP+64KB", 64)].cycles
    out["identical"] = all(rw[key].cycles == r1[key].cycles for key in r1)
    out["speedup"] = out["workers1_s"] / max(1e-9, out["workers_all_s"])
    return out


def _no_rescache() -> None:
    os.environ["REPRO_RESCACHE"] = "0"    # spawn workers inherit env
    from ..core import rescache as _rc
    _rc.configure(enabled=False)


def run_dse(*, smoke: bool = False,
            kernels: tuple[str, ...] | None = None,
            out_path: str = BENCH_PATH,
            max_candidates: int = 16,
            rescache: bool = True,
            server: str | None = None) -> dict:
    """Partition-space DSE over the paper kernels (``--dse``): per kernel,
    ``Compiled.explore`` over merge/split/duplicate re-partitionings,
    widened with the transformation catalog (unroll 2 ± coalescing, with
    a halved FIFO depth) on ``ACP`` and ``ACP+64KB``, every candidate
    fully simulated; the cycles-vs-FIFO-bits Pareto front, the baseline
    and one cold simulation's wall (the median of three seeds) go to the
    ``dse`` section.  ``--smoke`` explores the first two kernels at
    ``SMOKE_ITERS``; the full mode defaults to spmv at its Table-I
    count."""
    from ..core import rescache as _rc
    from ..dataflow import TransformConfig
    from ..dataflow.dse import sim_stages_for_partition, traces_by_node
    from ..dataflow.schedule import _cyclic_nodes
    if not rescache:
        _no_rescache()
    if smoke:
        kernels = tuple(kernels or ALL_KERNELS)[:2]
        n_iters, fifo_depth = SMOKE_ITERS, 8
    else:
        kernels = tuple(kernels or ("spmv",))
        n_iters, fifo_depth = None, FIFO_DEPTH
    payload: dict = {"smoke": smoke, "fifo_depth": fifo_depth,
                     "max_candidates": max_candidates,
                     "trace_set": "full", "kernels": {}}
    t0 = time.perf_counter()
    for kn in kernels:
        k = make_kernel(kn)
        n = n_iters or k.n_iters_full
        traces = list(k.full_traces.values())
        compiled = dataflow_compile(
            k.loop_body, k.carry_example, *k.body_args, loop=True,
            nonaliasing_carries=k.nonaliasing_carries, device=k.device)
        mem = acp()
        mem.max_outstanding = MAX_OUTSTANDING
        # one cold simulation of the Algorithm 1 partition, at seeds the
        # DSE does not use, each artifact evicted after its probe
        nt = traces_by_node(compiled.cdfg, compiled.partition, traces,
                            n_iters=n)
        cyc = {x for x in _cyclic_nodes(compiled.cdfg)
               if compiled.cdfg.node(x).is_memory}
        base_stages = sim_stages_for_partition(compiled.partition, nt, cyc)
        colds = []
        for probe_seed in (1, 2, 3):
            tc = time.perf_counter()
            simulate_dataflow(base_stages, mem, n, fifo_depth=fifo_depth,
                              seed=probe_seed)
            colds.append(time.perf_counter() - tc)
            _rc.evict(_rc.resolution_key("dataflow", base_stages, mem,
                                         probe_seed))
        cold_s = sorted(colds)[1]
        mem64 = standard_memory_models()["ACP+64KB"]()
        mem64.max_outstanding = MAX_OUTSTANDING
        te = time.perf_counter()
        res = compiled.explore(
            n_iters=n, traces=traces, mem=mem, mems=[mem, mem64],
            fifo_depth=fifo_depth,
            fifo_depths=[fifo_depth, max(1, fifo_depth // 2)],
            transforms=[TransformConfig(unroll=2),
                        TransformConfig(unroll=2, coalesce=True)],
            max_candidates=max_candidates, server=server)
        explore_s = time.perf_counter() - te
        entry = res.to_json()
        entry["single_cold_s"] = cold_s
        entry["explore_wall_s"] = explore_s
        entry["cost_ratio_vs_cold"] = explore_s / max(1e-9, cold_s)
        payload["kernels"][kn] = entry
        print(f"  [{kn}] {res.summary()}", flush=True)
        print(f"  [{kn}] single cold sim {cold_s:.2f}s, DSE wall "
              f"{explore_s:.2f}s over {len(res.evaluated())} simulated "
              f"candidates ({entry['cost_ratio_vs_cold']:.2f}x; "
              f"{res.eval_stats.get('cold_groups', 0)} cold resolution "
              f"group(s))", flush=True)
    payload["wall_s"] = time.perf_counter() - t0
    update_bench("dse", payload, out_path)
    print(f"\nwrote dse section to {out_path} "
          f"({payload['wall_s']:.1f}s)")
    return payload


def _tasks(smoke: bool, kernels: tuple[str, ...],
           words_per_cycle: tuple[float, ...] | None,
           max_outstandings: tuple[int, ...] | None,
           workers: int | None, server: str | None) -> list[tuple]:
    """One task per (kernel, memory): the ``--smoke`` grid is ACP and
    ACP+64KB at FIFO 8 and ``SMOKE_ITERS`` iterations, the full one every
    memory at ``FIFO_DEPTHS`` and the Table-I counts; SpMV again under
    unroll 2 with coalescing."""
    from ..dataflow import TransformConfig
    if smoke:
        mems = ("ACP", "ACP+64KB")
        fifo_depths, scc_modes, n_iters = (8,), ("auto",), SMOKE_ITERS
    else:
        mems = tuple(standard_memory_models())
        fifo_depths, scc_modes, n_iters = FIFO_DEPTHS, SCC_MODES, None
    tasks = [(kn, mn, fifo_depths, scc_modes, n_iters,
              words_per_cycle, max_outstandings, workers, server, None)
             for kn in kernels for mn in mems]
    # the transformation-catalog axis: spmv re-swept under unroll=2
    # (+coalescing); its rows carry their own ``transform`` signature
    if "spmv" in kernels:
        tf_mems = mems if smoke else ("ACP",)
        tasks += [("spmv", mn, fifo_depths, scc_modes, n_iters,
                   words_per_cycle, max_outstandings, workers, server,
                   TransformConfig(unroll=2, coalesce=True))
                  for mn in tf_mems]
    return tasks


def run_tasks(tasks: list[tuple], jobs: int = 1) -> list[dict]:
    """The grid's rows, sorted; ``jobs > 1`` runs the tasks in a spawn
    pool whose workers take this process's device and engine."""
    rows: list[dict] = []
    pool = (multiprocessing.get_context("spawn").Pool(
        jobs, _worker_init, (_device.get_device(), _engine.current()))
        if jobs > 1 else None)
    try:
        parts = (pool.imap_unordered(_sweep_task, tasks) if pool
                 else map(_sweep_task, tasks))
        for part in parts:
            rows.extend(part)
            r = part[0]
            print(f"  [{r['kernel']}] {r['mem']:<9} done "
                  f"({len(part)} points)", flush=True)
    finally:
        if pool is not None:
            pool.close()
            pool.join()
    rows.sort(key=lambda r: (r["kernel"], r["mem"],
                             r.get("transform") or "none",
                             r["fifo_depth"], r["mem_in_scc"],
                             r["words_per_cycle"], r["max_outstanding"]))
    return rows


def run_sweep(*, smoke: bool = False, jobs: int | None = None,
              kernels: tuple[str, ...] | None = None,
              out_path: str = BENCH_PATH,
              words_per_cycle: tuple[float, ...] | None = None,
              max_outstandings: tuple[int, ...] | None = None,
              rescache: bool = True,
              workers: int | None = None,
              server: str | None = None) -> dict:
    """The grid, its per-kernel Pareto fronts, ``measure_perf`` and
    ``measure_worker_scaling``, each written as a section of
    ``out_path``."""
    from ..dataflow.schedule import SweepResult
    if not rescache:
        _no_rescache()
    if server == "auto":
        # spawn (or find) the store's daemon once, then hand every task
        # its address: job processes must not race to spawn their own
        from ..serve import ensure_daemon
        server = ensure_daemon()
    kernels = tuple(kernels or ALL_KERNELS)
    if smoke:
        kernels = kernels[:2]
        if words_per_cycle is None:
            words_per_cycle = (0.5, 1.0)
    tasks = _tasks(smoke, kernels, words_per_cycle, max_outstandings,
                   workers, server)
    if jobs is None:
        jobs = 1 if smoke else min(2, multiprocessing.cpu_count())
    t0 = time.perf_counter()
    rows = run_tasks(tasks, jobs)
    fronts: dict[str, list] = {}
    for kn in kernels:
        krows = [r for r in rows if r["kernel"] == kn]
        front = SweepResult(krows, krows[0]["n_iters"]).pareto()
        fronts[kn] = [
            {"mem": r["mem"], "fifo_depth": r["fifo_depth"],
             "fifo_bits": r["fifo_bits"],
             "words_per_cycle": r["words_per_cycle"],
             "max_outstanding": r["max_outstanding"],
             "transform": r.get("transform") or "none",
             "dataflow_cycles": r["dataflow_cycles"]}
            for r in front]
    perf = measure_perf()
    payload = {"smoke": smoke, "wall_s": time.perf_counter() - t0,
               "device": str(_device.get_device()),
               "engine": _engine.current(),
               "workers": workers, "server": server, "rows": rows,
               "pareto": fronts}
    update_bench("sweep", payload, out_path)
    update_bench("perf", perf, out_path)
    sc = measure_worker_scaling()
    update_bench("worker_scaling", sc, out_path)
    print(f"worker scaling: workers=1 {sc['workers1_s']:.1f}s, "
          f"workers={sc['workers_all']} {sc['workers_all_s']:.1f}s "
          f"({sc['speedup']:.2f}x, identical={sc['identical']}) on "
          f"{sc['cpus']} cpus")
    if server:
        from ..serve import ServeUnavailable, get_stats
        try:
            update_bench("serving_stats", get_stats(server), out_path)
        except ServeUnavailable:
            pass
    print(f"\n{'kernel':<16}{'mem':<10}{'fifo':>5}{'wpc':>5}{'mo':>4}"
          f"{'df cyc/it':>11}{'conv cyc/it':>13}{'speedup':>9}")
    for r in rows:
        print(f"{r['kernel']:<16}{r['mem']:<10}{r['fifo_depth']:>5}"
              f"{r['words_per_cycle']:>5.2g}{r['max_outstanding']:>4}"
              f"{r['dataflow_cpi']:>11.2f}{r['conventional_cpi']:>13.2f}"
              f"{r['speedup']:>9.2f}")
    print(f"\nsimulator perf: dataflow {perf['ACP']['dataflow_speedup']:.0f}x"
          f" / conventional {perf['ACP']['conventional_speedup']:.0f}x"
          f" vectorized-vs-reference at {perf['n_iters']} iters; "
          f"wrote {out_path}")
    return payload


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.workloads.sweep",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="reduced grid at small iteration counts")
    ap.add_argument("--jobs", type=int, default=None)
    ap.add_argument("--kernels", nargs="*", default=None,
                    choices=tuple(ALL_KERNELS))
    ap.add_argument("--out", default=BENCH_PATH)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    ap.add_argument("--words-per-cycle", nargs="*", type=float,
                    default=None, help="port bandwidth axis values")
    ap.add_argument("--max-outstandings", nargs="*", type=int,
                    default=None, help="in-flight request cap axis values")
    ap.add_argument("--no-rescache", action="store_true",
                    help="bypass the resolved-trace cache (cold timings)")
    ap.add_argument("--workers", type=int, default=None,
                    help="shard trace resolution over N processes per "
                         "sweep task (bit-identical results)")
    ap.add_argument("--server", default=None, metavar="auto|ADDR",
                    help="delegate trace resolution to the resolution "
                         "daemon ('auto' finds or spawns the store's)")
    ap.add_argument("--dse", action="store_true",
                    help="also run the partition-space DSE")
    ap.add_argument("--dse-only", action="store_true",
                    help="run only the DSE section (skip the sweep grid)")
    ap.add_argument("--dse-candidates", type=int, default=16)
    a = ap.parse_args(argv)
    _device.set_device(_device.get_device(a.device))
    if not os.environ.get("REPRO_RESCACHE_DIR"):
        # the resolved-trace store goes under build/ too (spawned workers
        # and a daemon read the environment)
        from ..core import rescache as _rc
        os.environ["REPRO_RESCACHE_DIR"] = os.path.join("build",
                                                        "rescache_torch")
        _rc.configure(directory=os.environ["REPRO_RESCACHE_DIR"])
    kernels = tuple(a.kernels) if a.kernels else None
    out: dict = {}
    server = a.server
    if server == "auto":
        from ..serve import ensure_daemon
        server = ensure_daemon()
    if not a.dse_only:
        out = run_sweep(smoke=a.smoke, jobs=a.jobs, kernels=kernels,
                        out_path=a.out,
                        words_per_cycle=(tuple(a.words_per_cycle)
                                         if a.words_per_cycle else None),
                        max_outstandings=(tuple(a.max_outstandings)
                                          if a.max_outstandings else None),
                        rescache=not a.no_rescache, workers=a.workers,
                        server=server)
    if a.dse or a.dse_only:
        out["dse"] = run_dse(smoke=a.smoke, kernels=kernels, out_path=a.out,
                             max_candidates=a.dse_candidates,
                             rescache=not a.no_rescache, server=server)
    return out


if __name__ == "__main__":
    main()
