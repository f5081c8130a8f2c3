"""The port's Fig. 5 harness (``repro_torch.workloads.fig5``) and its
Table-I workloads against the reference (``benchmarks/paper_fig5.py``,
``benchmarks/paper_kernels.py``).

The workloads' seeded data and traces must be the reference's.  Then the
cycles: each body through the port's own front end and traces, simulated
on the port's ``numpy`` and ``torch`` engines (on the CPU the torch
engine's running max is the kernel's plain version), must give the
reference's numpy-engine cycles and stall buckets — knapsack and DFS at
their full Table-I counts on all four memories, Floyd–Warshall on a
40,000-iteration prefix — and the harness's ``run_kernel(full=False)``
and ``summarize`` must equal the reference's on all four kernels.  The
plans and cycles that ``chip_smoke.py`` holds the card to are recorded
there as constants; they must be what the reference computes here.
"""

import json

import numpy as np
import pytest

import chip_smoke
import repro_torch
from benchmarks import paper_fig5 as ref_fig5
from benchmarks.paper_kernels import ALL_KERNELS as REF_KERNELS
from repro.core import engine as ref_engine
from repro.core import rescache as ref_rescache
from repro.core import simulator as ref_sim
from repro.dataflow import compile as ref_compile
from repro_torch.core import engine as port_engine
from repro_torch.core import rescache as port_rescache
from repro_torch.core import simulator as port_sim
from repro_torch.workloads import ALL_KERNELS, fig5

ENGINES = ("numpy", "torch")
FW_PREFIX = 40_000


@pytest.fixture(scope="module", autouse=True)
def _stores_in_tmp(tmp_path_factory):
    """Both resolution caches write under a temporary directory."""
    base = tmp_path_factory.mktemp("rescache")
    saved = (ref_rescache._cfg.directory, port_rescache._cfg.directory)
    ref_rescache._cfg.directory = str(base / "ref")
    port_rescache._cfg.directory = str(base / "port")
    yield
    ref_rescache._cfg.directory, port_rescache._cfg.directory = saved


@pytest.fixture(autouse=True)
def _port_on_cpu():
    repro_torch.set_device("cpu")
    yield
    repro_torch.set_device(None)


def _ref_kernel(name):
    return ref_fig5._make_kernel(name)


@pytest.mark.parametrize("name", ["knapsack", "floyd_warshall", "dfs"])
def test_workloads_equal_the_reference(name):
    k = _ref_kernel(name)
    w = fig5.make_kernel(name, "cpu")
    assert (w.name, w.n_iters_full, w.n_iters_sim, w.instrs_per_iter,
            w.nonaliasing_carries, w.mem_in_scc_regions) == \
        (k.name, k.n_iters_full, k.n_iters_sim, k.instrs_per_iter,
         k.nonaliasing_carries, k.mem_in_scc_regions)
    if k.expected is None:
        assert w.expected is None
    else:
        np.testing.assert_array_equal(w.expected, k.expected)
    assert list(w.traces) == list(k.traces)
    assert list(w.full_traces) == list(k.full_traces)
    for region in k.traces:
        np.testing.assert_array_equal(w.traces[region].addrs,
                                      k.traces[region].addrs)
        assert w.traces[region].is_store == k.traces[region].is_store
        for lo, hi in ((0, 5000), (k.n_iters_full - 5000, k.n_iters_full)):
            np.testing.assert_array_equal(
                w.full_traces[region].gen(lo, hi),
                k.full_traces[region].gen(lo, hi))
    # the closed-over data: the body's example carry, then its tensors
    flat_ref = [np.asarray(x) for x in
                (k.carry_example if isinstance(k.carry_example, tuple)
                 else (k.carry_example,))]
    flat_port = [x.numpy() for x in
                 (w.carry_example if isinstance(w.carry_example, tuple)
                  else (w.carry_example,))]
    for a, b in zip(flat_port, flat_ref):
        np.testing.assert_array_equal(a, b)


def _mems(sim, names=fig5.MEM_NAMES, outstanding=True):
    out = {}
    for mn in names:
        m = sim.standard_memory_models()[mn]()
        if outstanding:
            m.max_outstanding = fig5.MAX_OUTSTANDING
        out[mn] = m
    return out


def _grid(sim, fused_stage, df_stages, k, n, **kw):
    traces = list(k.full_traces.values())
    df = sim.simulate_dataflow_many(
        df_stages, _mems(sim), n, fifo_depths=(fig5.FIFO_DEPTH,),
        use_rescache=False, **kw)
    cv = sim.simulate_conventional_many(
        [fused_stage(df_stages)], _mems(sim, outstanding=False), n,
        use_rescache=False, **kw)
    base = sim.simulate_processor(k.instrs_per_iter, traces, n,
                                  use_rescache=False)
    return ({mn: (df[(mn, fig5.FIFO_DEPTH)].cycles,
                  df[(mn, fig5.FIFO_DEPTH)].stage_stall_cycles,
                  cv[mn].cycles, cv[mn].stage_stall_cycles)
             for mn in fig5.MEM_NAMES},
            (base.cycles, base.cache_hits, base.cache_misses))


_REF_GRIDS: dict = {}


def _ref_grid(name, n):
    """The reference's grid on its numpy engine (its processor baseline's
    4- and 8-way caches reach ``nway_core``, whose jax form is broken
    under jax 0.9.0: see ROADMAP, caveats of the reference)."""
    if (name, n) not in _REF_GRIDS:
        k = _ref_kernel(name)
        df_stages, _ = ref_fig5.build_stages(k)
        with ref_engine.use("numpy"):
            _REF_GRIDS[(name, n)] = _grid(ref_sim, ref_fig5.fused_stage,
                                          df_stages, k, n)
    return _REF_GRIDS[(name, n)]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("name,n", [("knapsack", None), ("dfs", None),
                                    ("floyd_warshall", FW_PREFIX)])
def test_grid_cycles_equal_the_reference(name, n, engine):
    """Dataflow and conventional machines on all four memories, and the
    processor baseline: cycles and stall buckets identical to the
    reference's numpy engine (knapsack and DFS: all Table-I iterations)."""
    w = fig5.make_kernel(name, "cpu")
    n = n or w.n_iters_full
    df_stages, _ = fig5.build_stages(w)
    port = _grid(port_sim, fig5.fused_stage, df_stages, w, n, engine=engine)
    assert port == _ref_grid(name, n)


@pytest.mark.parametrize("name", list(chip_smoke.REF_FIG5))
def test_chip_smoke_cycles_are_the_reference(name):
    """Phase 4b's constants: the reference's numpy-engine grid at the
    iterations the phase simulates (Floyd–Warshall: its first 2^22)."""
    assert (chip_smoke.FIG5_MEMS, chip_smoke.FIFO_DEPTH,
            chip_smoke.MAX_OUTSTANDING) == \
        (ref_fig5.MEM_NAMES, ref_fig5.FIFO_DEPTH, ref_fig5.MAX_OUTSTANDING)
    n, cells, base = chip_smoke.REF_FIG5[name]
    assert n == min(_ref_kernel(name).n_iters_full, 1 << 22)
    grid, (base_cycles, _, _) = _ref_grid(name, n)
    assert tuple((grid[mn][0], grid[mn][2]) for mn in ref_fig5.MEM_NAMES) \
        == cells
    assert base_cycles == base
    if name == "spmv":
        assert cells[0] == (chip_smoke.REF_DATAFLOW_CYCLES,
                            chip_smoke.REF_CONVENTIONAL_CYCLES)


@pytest.mark.parametrize("name", list(chip_smoke.REF_TABLE1_PLANS))
def test_chip_smoke_plans_are_the_reference(name):
    """Phase 3b's constants: the reference's plan of each body (nodes,
    stages, channels, bytes per token, II, latency, ops per stage) and
    its simulator stages."""
    k = _ref_kernel(name)
    c = ref_compile(k.loop_body, k.carry_example, *k.body_args, loop=True,
                    nonaliasing_carries=k.nonaliasing_carries)
    sch = c.schedule
    head = (len(c.cdfg.nodes), sch.num_stages, sch.num_channels,
            sch.channel_bytes, sch.pipeline_ii, sch.total_latency,
            [sp.eqn_count for sp in c.program.stages])
    stages = [(s.ii, s.latency, s.mem_in_scc, [a.region for a in s.accesses])
              for s in c.sim_stages(traces=list(k.full_traces.values()))]
    assert (head, stages) == chip_smoke.REF_TABLE1_PLANS[name]


_REF_QUICK: dict = {}


def _ref_run_kernel(name):
    if name not in _REF_QUICK:
        with ref_engine.use("numpy"):
            _REF_QUICK[name] = ref_fig5.run_kernel(_ref_kernel(name))
    return _REF_QUICK[name]


def _port_run_kernels(engine):
    with port_engine.use(engine):
        return {n: fig5.run_kernel(fig5.make_kernel(n, "cpu"))
                for n in ALL_KERNELS}


@pytest.mark.parametrize("engine", ENGINES)
def test_run_kernel_and_summarize_equal_the_reference(engine):
    """``run_kernel(full=False)`` on all four kernels, then
    ``summarize``, equal the reference's (same floats: same cycles)."""
    port = _port_run_kernels(engine)
    ref = {n: _ref_run_kernel(n) for n in REF_KERNELS}
    assert port == ref
    assert fig5.summarize(port) == ref_fig5.summarize(ref)


def test_dfs_paper_claims_on_the_port():
    """The paper's negative result, as tests/test_system.py states it:
    DFS's memory ops sit in one memory-in-SCC stage, and dataflow gains
    under 1.5x over conventional on ACP and ACP+64KB."""
    w = fig5.make_kernel("dfs", "cpu")
    df_stages, _ = fig5.build_stages(w)
    mem_stages = [s for s in df_stages if s.accesses]
    assert len(mem_stages) == 1 and mem_stages[0].mem_in_scc
    r = fig5.run_kernel(w)
    for m in ("ACP", "ACP+64KB"):
        assert r[m]["dataflow_vs_conventional"] < 1.5


def test_unported_options_raise(tmp_path):
    """The options that raised before the chunk-graph executor and the
    daemon were ported now run: ``workers=2`` and ``server=`` (an
    address where no daemon answers: resolved locally) give the cycles
    of a plain run."""
    from repro_torch.serve import client
    plain, _, _ = fig5.run_all(full=False, jobs=1, kernels=("dfs",))
    client.configure_timeouts(max_wait_s=0.5, backoff_cap_s=0.1)
    try:
        for kw in ({"workers": 2},
                   {"server": str(tmp_path / "absent.sock")}):
            got, _, _ = fig5.run_all(full=False, jobs=1, kernels=("dfs",),
                                     **kw)
            for m in fig5.MEM_NAMES:
                for key in ("dataflow_cycles", "conventional_cycles"):
                    assert got["dfs"][m][key] == plain["dfs"][m][key], kw
    finally:
        client.configure_timeouts(None)


def test_cli_spawn_pool_passes_device_and_engine(tmp_path, monkeypatch):
    """``--jobs 2`` runs the tasks in spawned workers, which must get the
    CPU device and the engine from the parent: the JSON's cycles equal
    an in-process run's, and the reference's summary holds."""
    monkeypatch.setenv("REPRO_RESCACHE", "0")
    monkeypatch.setattr(port_rescache._cfg, "enabled",
                        port_rescache._cfg.enabled)
    monkeypatch.setenv("REPRO_TORCH_ENGINE", "torch")
    out = tmp_path / "fig5.json"
    fig5.cli(["--quick", "--kernels", "knapsack", "dfs", "--device", "cpu",
              "--jobs", "2", "--no-rescache", "--out", str(out)])
    got = json.loads(out.read_text())
    inproc, _, _ = fig5.run_all(full=False, jobs=1,
                                kernels=("knapsack", "dfs"))
    for kn in ("knapsack", "dfs"):
        assert got["results"][kn]["baseline_cycles"] == \
            inproc[kn]["baseline_cycles"]
        for m in fig5.MEM_NAMES:
            for key in ("dataflow_cycles", "conventional_cycles"):
                assert got["results"][kn][m][key] == inproc[kn][m][key]
    ref = {n: _ref_run_kernel(n) for n in ("knapsack", "dfs")}
    assert got["summary"]["dataflow_vs_conventional_best"] == \
        pytest.approx(ref_fig5.summarize(ref)[
            "dataflow_vs_conventional_best"], rel=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("name,n", [("knapsack", None),
                                    ("floyd_warshall", FW_PREFIX)])
def test_grid_cycles_on_the_card_equal_the_reference(name, n):
    """The torch engine on the card (its running max is the CUDA kernel,
    launched at least once) gives the reference's numpy-engine grid."""
    import torch
    from repro_torch.kernels import _lib
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    repro_torch.set_device("cuda")
    w = fig5.make_kernel(name)
    n = n or w.n_iters_full
    df_stages, _ = fig5.build_stages(w)
    before = _lib.counts()["running_max"]
    port = _grid(port_sim, fig5.fused_stage, df_stages, w, n, engine="torch")
    assert _lib.counts()["running_max"] > before
    assert port == _ref_grid(name, n)
