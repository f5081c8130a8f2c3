"""The port's simulator, engine and workload traces against the reference.

The simulator is the reference's numpy module re-homed with the port's
engine, so cycles must be bit-identical: the same stage records (carried
across by repro_torch.interop) give the same cycles and stall buckets,
the port's SpMV traces are the reference's, and the port end to end (its
own front end and traces) reproduces the reference's Fig. 5 cycles on the
same window.  The port's engine runs as ``torch`` on the CPU here, so the
solver's running max goes through the kernel's plain version.
"""

import numpy as np
import pytest

import repro_torch
from benchmarks.paper_fig5 import FIFO_DEPTH, MAX_OUTSTANDING, build_stages
from benchmarks.paper_kernels import make_spmv as ref_make_spmv
from repro.core import simulator as ref_sim
from repro.dataflow import compile as ref_compile
from repro.dataflow import fused_stage as ref_fused_stage
from repro_torch import interop
from repro_torch.core import engine as port_engine
from repro_torch.core import rescache as port_rescache
from repro_torch.core import simulator as port_sim
from repro_torch.dataflow import compile as port_compile
from repro_torch.dataflow import fused_stage as port_fused_stage
from repro_torch.workloads import make_spmv

N_ITERS = 20_000
MEMS = ("ACP", "ACP+64KB")


@pytest.fixture(autouse=True)
def _port_on_cpu(tmp_path_factory, monkeypatch):
    repro_torch.set_device("cpu")
    monkeypatch.setattr(port_rescache._cfg, "directory",
                        str(tmp_path_factory.getbasetemp() / "rescache_torch"))
    yield
    repro_torch.set_device(None)


def _mems(sim, names):
    out = {}
    for mn in names:
        m = sim.standard_memory_models()[mn]()
        m.max_outstanding = MAX_OUTSTANDING
        out[mn] = m
    return out


@pytest.fixture(scope="module")
def ref_stages():
    k = ref_make_spmv(0.125)
    df, _ = build_stages(k)
    return df


def _run_both(ref_df, port_df, n, mems=MEMS, engine="torch"):
    ref = ref_sim.simulate_dataflow_many(
        ref_df, _mems(ref_sim, mems), n, fifo_depths=(FIFO_DEPTH,),
        use_rescache=False, engine="numpy")
    port = port_sim.simulate_dataflow_many(
        port_df, _mems(port_sim, mems), n, fifo_depths=(FIFO_DEPTH,),
        use_rescache=False, engine=engine)
    ref_cv = ref_sim.simulate_conventional_many(
        [ref_fused_stage(ref_df)], _mems(ref_sim, mems), n,
        use_rescache=False, engine="numpy")
    port_cv = port_sim.simulate_conventional_many(
        [port_fused_stage(port_df)], _mems(port_sim, mems), n,
        use_rescache=False, engine=engine)
    return ref, port, ref_cv, port_cv


@pytest.mark.parametrize("mem", MEMS)
def test_same_records_give_identical_cycles(ref_stages, mem):
    records = interop.stage_records(ref_stages, N_ITERS)
    ref_df = [ref_sim.SimStage(
        r["name"], r["ii"], r["latency"],
        [ref_sim.MemAccess(a["region"], a["addrs"], is_store=a["is_store"])
         for a in r["accesses"]], r["mem_in_scc"]) for r in records]
    port_df = interop.stages_from_records(records)
    ref, port, ref_cv, port_cv = _run_both(ref_df, port_df, N_ITERS, (mem,))
    r, p = ref[(mem, FIFO_DEPTH)], port[(mem, FIFO_DEPTH)]
    assert p.cycles == r.cycles
    assert p.stage_stall_cycles == r.stage_stall_cycles
    assert (p.cache_hits, p.cache_misses) == (r.cache_hits, r.cache_misses)
    assert port_cv[mem].cycles == ref_cv[mem].cycles
    assert port_cv[mem].stage_stall_cycles == ref_cv[mem].stage_stall_cycles


def test_workload_traces_equal_reference():
    k = ref_make_spmv(0.125)
    w = make_spmv(0.125, device="cpu")
    assert w.n_iters_full == k.n_iters_full == 4096 * 1024
    for name in ("cols", "vals", "x"):
        np.testing.assert_array_equal(w.traces[name].addrs,
                                      k.traces[name].addrs)
        for lo, hi in ((0, N_ITERS), (k.n_iters_full - 5000,
                                      k.n_iters_full)):
            np.testing.assert_array_equal(w.full_traces[name].gen(lo, hi),
                                          k.full_traces[name].gen(lo, hi))
    np.testing.assert_array_equal(w.expected, k.expected)


@pytest.mark.parametrize("n_iters", [N_ITERS, 3 * port_engine.JIT_MIN_ELEMS])
def test_port_end_to_end_matches_reference_cycles(ref_stages, n_iters):
    """The port's own front end, partition and traces, simulated on the
    torch engine (at 3 * JIT_MIN_ELEMS the solver's running max goes
    through the kernel wrapper), reproduce the reference's cycles."""
    w = make_spmv(0.125, device="cpu")
    c = port_compile(w.loop_body, w.carry_example, *w.body_args, loop=True,
                     device="cpu")
    port_df = c.sim_stages(traces=list(w.full_traces.values()))
    ref, port, ref_cv, port_cv = _run_both(ref_stages, port_df, n_iters)
    for mn in MEMS:
        assert port[(mn, FIFO_DEPTH)].cycles == ref[(mn, FIFO_DEPTH)].cycles
        assert port_cv[mn].cycles == ref_cv[mn].cycles


def test_compiled_simulate_matches_reference():
    """``Compiled.simulate`` (the Fig. 5 cell of chip_smoke.py, at a
    window) gives the reference's dataflow and conventional cycles."""
    k = ref_make_spmv(0.125)
    ref_c = ref_compile(k.loop_body, k.carry_example, *k.body_args,
                        loop=True)
    w = make_spmv(0.125, device="cpu")
    port_c = port_compile(w.loop_body, w.carry_example, *w.body_args,
                          loop=True, device="cpu")
    mem_r, mem_p = _mems(ref_sim, ["ACP"])["ACP"], \
        _mems(port_sim, ["ACP"])["ACP"]
    ref = ref_c.simulate(n_iters=N_ITERS, mem=mem_r, fifo_depth=FIFO_DEPTH,
                         traces=list(k.full_traces.values()),
                         use_rescache=False, engine="numpy")
    port = port_c.simulate(n_iters=N_ITERS, mem=mem_p, fifo_depth=FIFO_DEPTH,
                           traces=list(w.full_traces.values()),
                           use_rescache=False, engine="torch")
    assert port.dataflow.cycles == ref.dataflow.cycles
    assert port.conventional.cycles == ref.conventional.cycles
    assert port.dataflow.stage_stall_cycles == ref.dataflow.stage_stall_cycles


def test_rescache_store_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.setattr(port_rescache._cfg, "directory", None)
    monkeypatch.chdir(tmp_path)
    (tmp_path / "experiments").mkdir()
    assert port_rescache._dir() == "experiments/.rescache_torch"


def test_later_slice_paths_raise(ref_stages):
    port_df = interop.stages_from_records(
        interop.stage_records(ref_stages, 100))
    with pytest.raises(NotImplementedError):
        port_sim.simulate_dataflow_many(port_df, _mems(port_sim, ["ACP"]),
                                        100, server="auto")
    with pytest.raises(NotImplementedError):
        port_sim.simulate_dataflow_many(port_df, _mems(port_sim, ["ACP"]),
                                        100, workers=2)
