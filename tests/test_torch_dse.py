"""The port's design-space explorer (``repro_torch.dataflow.dse``) against
the reference's (``repro.dataflow.dse``).

Each case traces the same loop body in both packages (jax and torch.fx
front ends, the same numpy data) and explores it with the same knobs:
every candidate — its plan signature, moves, duplication toggle, FIFO
depth, simulated cycles or pruning reason — and the Pareto front must be
identical.  Knapsack's Table-I body is held at 2^14 iterations to the
front recorded from the reference, and ``chip_smoke.REF_DSE`` (the front
phase 8 holds the card to) to the reference's at 2^17.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import repro_torch
from benchmarks import paper_fig5 as ref_fig5
from repro.core import engine as ref_engine
from repro.core import rescache as ref_rc
from repro.dataflow import ResourceConstraints as RefConstraints
from repro.dataflow import compile as ref_compile
from repro.dataflow import dse as ref_dse
from repro_torch.core import engine as port_engine
from repro_torch.core import rescache as port_rc
from repro_torch.dataflow import ResourceConstraints, enumerate_plans
from repro_torch.dataflow import compile as port_compile
from repro_torch.dataflow import dse as port_dse
from repro_torch.workloads import fig5

#: the reference's knapsack front at 2^14 iterations (Table-I body and
#: traces, 12 candidates, FIFO depth 8, ACP): stages, FIFO bits, cycles
REF_KNAPSACK_14 = ((1, 0, 49_220), (5, 1_536, 17_049), (7, 2_368, 17_044),
                   (35, 6_528, 16_918), (35, 8_128, 16_902))


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch, tmp_path):
    """The port on the CPU; both stores in a fresh directory and off (the
    sharing cases turn them on)."""
    repro_torch.set_device("cpu")
    for rc, name in ((ref_rc, "ref"), (port_rc, "port")):
        rc.clear()
        monkeypatch.setattr(rc._cfg, "directory", str(tmp_path / name))
        monkeypatch.setattr(rc._cfg, "enabled", False)
    yield
    port_rc.clear()
    ref_rc.clear()
    repro_torch.set_device(None)


def _spmv_like_ref():
    def body(acc, j, vals, cols, xv):
        return acc + vals[j] * xv[cols[j]]

    args = (jnp.float32(0.0), jnp.int32(0), jnp.arange(64, dtype=jnp.float32),
            jnp.arange(64) % 16, jnp.arange(16, dtype=jnp.float32))
    return body, args


def _spmv_like_port():
    def body(acc, j, vals, cols, xv):
        return acc + vals[j] * xv[cols[j]]

    args = (torch.tensor(0.0), torch.tensor(0, dtype=torch.int32),
            torch.arange(64, dtype=torch.float32),
            torch.arange(64, dtype=torch.int32) % 16,
            torch.arange(16, dtype=torch.float32))
    return body, args


@pytest.fixture(scope="module")
def spmv_pair():
    body, args = _spmv_like_ref()
    ref = ref_compile(body, *args, loop=True)
    body, args = _spmv_like_port()
    port = port_compile(body, *args, loop=True, device="cpu")
    return ref, port


def _candidates(res):
    return [(c.groups, c.moves, c.duplicate, c.fifo_depth, c.transform,
             c.mem_name, c.cycles, c.pruned, c.pareto, c.n_tokens,
             c.deadlock_min_depth,
             tuple(sorted(c.resources.items()))) for c in res.candidates]


def _front(res):
    return [(c.resources["num_stages"], c.fifo_bits, c.cycles)
            for c in res.front]


def _same_result(port, ref):
    assert _candidates(port) == _candidates(ref)
    assert _front(port) == _front(ref)
    assert port.baseline.groups == ref.baseline.groups
    assert port.baseline.cycles == ref.baseline.cycles
    assert len(port.evaluated()) == len(ref.evaluated())
    assert sum(c.pruned is not None for c in port.candidates) == \
        sum(c.pruned is not None for c in ref.candidates)
    assert (port.n_iters, port.fifo_depth, port.mem_name,
            tuple(port.fifo_depths)) == \
        (ref.n_iters, ref.fifo_depth, ref.mem_name, tuple(ref.fifo_depths))


def test_enumerated_plans_equal_the_reference(spmv_pair):
    ref, port = spmv_pair
    want = [(m, p.groups) for m, p in
            ref_dse.enumerate_plans(ref.cdfg, ref.context.plan, 256)]
    got = [(m, p.groups) for m, p in
           enumerate_plans(port.cdfg, port.context.plan, 256)]
    assert got == want


@pytest.mark.parametrize("engine", ["numpy", "torch"])
@pytest.mark.parametrize("kw", [
    {"n_iters": 1500, "max_candidates": 12},
    {"n_iters": 1200, "max_candidates": 10},
    {"n_iters": 1200, "max_candidates": 8, "fifo_depths": (4, 8, 32)},
], ids=["front", "fresh", "joint-depth"])
def test_explore_equals_the_reference(spmv_pair, kw, engine):
    """``Compiled.explore`` on the synthetic per-region traces: every
    candidate and the front equal the reference's, and every front point
    carries a ``Compiled`` artifact that runs to the plain result."""
    ref, port = spmv_pair
    with ref_engine.use("numpy"):
        want = ref.explore(**kw)
    with port_engine.use(engine):
        got = port.explore(**kw)
    _same_result(got, want)
    body, args = _spmv_like_port()
    expect = body(*args)
    for f in got.front:
        assert f.compiled.num_stages == f.resources["num_stages"]
        assert f.compiled.device == torch.device("cpu")
        torch.testing.assert_close(f.compiled(*args), expect)


def test_front_cycles_equal_a_fresh_simulation(spmv_pair):
    """Every front point's cycles are those of a cold simulation of its
    partition with the same node traces."""
    from repro_torch.core.simulator import acp, simulate_dataflow
    from repro_torch.dataflow.schedule import _cyclic_nodes
    _, port = spmv_pair
    res = port.explore(n_iters=1200, max_candidates=10)
    nt = port_dse.traces_by_node(port.cdfg, port.partition, None,
                                 n_iters=1200, seed=0)
    cyc_mem = {n for n in _cyclic_nodes(port.cdfg)
               if port.cdfg.node(n).is_memory}
    for cand in res.front:
        stages = port_dse.sim_stages_for_partition(cand.compiled.partition,
                                                   nt, cyc_mem)
        fresh = simulate_dataflow(stages, acp(), 1200, fifo_depth=8,
                                  collect_stalls=False, use_rescache=False)
        assert fresh.cycles == cand.cycles


def test_explore_shares_resolution_through_the_store(spmv_pair):
    """With the store on, the candidates resolve a few groups once each
    and a second exploration serves them all, cycles unchanged."""
    _, port = spmv_pair
    port_rc.configure(enabled=True)
    res = port.explore(n_iters=1500, max_candidates=12)
    assert res.eval_stats["resolution_groups"] <= 3
    res2 = port.explore(n_iters=1500, max_candidates=12)
    assert res2.eval_stats["cold_groups"] == 0
    assert _front(res2) == _front(res)


@pytest.mark.parametrize("rc_kw", [
    {"max_fifo_bits": 64}, {"max_stages": 2},
    {"max_mem_ports_per_stage": 1}, {"max_duplicated_nodes": 0},
    {"explore_reassoc": True}, {"unroll_factors": (2,)},
    {"unroll_factors": (2,), "explore_coalesce": True},
], ids=lambda kw: "-".join(kw))
def test_constraints_prune_as_the_reference(spmv_pair, rc_kw):
    """Resource limits, and the transform axes (the region split of
    ``split_by_region`` on the fx CDFG's regions, unrolling, coalescing),
    prune and simulate the same candidates as the reference's."""
    ref, port = spmv_pair
    want = ref_dse.explore_plans(
        ref.cdfg, ref.context.plan,
        constraints=RefConstraints(n_iters=800, max_candidates=12, **rc_kw))
    got = port_dse.explore_plans(
        port.cdfg, port.context.plan,
        constraints=ResourceConstraints(n_iters=800, max_candidates=12,
                                        **rc_kw))
    _same_result(got, want)


def test_dse_pass_compiles_the_references_winner():
    """``options.dse``: the pass re-partitions onto the constrained best,
    the same plan as the reference's, and the program still computes the
    plain result."""
    body, args = _spmv_like_ref()
    ref = ref_compile(body, *args, loop=True,
                      dse=RefConstraints(max_fifo_bits=2048, n_iters=1000,
                                         max_candidates=10))
    body, args = _spmv_like_port()
    port = port_compile(body, *args, loop=True, device="cpu",
                        dse=ResourceConstraints(max_fifo_bits=2048,
                                                n_iters=1000,
                                                max_candidates=10))
    _same_result(port.dse_result, ref.dse_result)
    assert port.context.plan.groups == ref.context.plan.groups
    torch.testing.assert_close(port(*args), body(*args))
    assert port_compile(body, *args, loop=True,
                        device="cpu").dse_result is None


def test_traces_by_node_conventions(spmv_pair):
    """Positional sequences, region mappings and synthetic traces pin the
    same streams to the same memory nodes as the reference."""
    ref, port = spmv_pair
    from repro.core.simulator import MemAccess as RefAccess
    from repro_torch.core.simulator import MemAccess as PortAccess
    mem = [nid for st in port.partition.stages for nid in st.node_ids
           if port.cdfg.node(nid).is_memory]
    regions = sorted({port.cdfg.node(nid).region for nid in mem})
    assert regions == sorted({ref.cdfg.node(nid).region for nid in mem})
    for traces in (
            lambda A: [A(f"t{i}", np.arange(100) * 4)
                       for i in range(len(mem))],
            lambda A: {r: A(r, np.arange(64) * 4) for r in regions},
            lambda A: None):
        want = ref_dse.traces_by_node(ref.cdfg, ref.partition,
                                      traces(RefAccess), n_iters=64, seed=7)
        got = port_dse.traces_by_node(port.cdfg, port.partition,
                                      traces(PortAccess), n_iters=64, seed=7)
        assert sorted(got) == sorted(want)
        for nid in want:
            assert [t.region for t in got[nid]] == \
                [t.region for t in want[nid]]
            for a, b in zip(got[nid], want[nid]):
                np.testing.assert_array_equal(a.addrs, b.addrs)


def _knapsack_pair():
    k = ref_fig5._make_kernel("knapsack")
    ref = ref_compile(k.loop_body, k.carry_example, *k.body_args, loop=True,
                      nonaliasing_carries=k.nonaliasing_carries)
    w = fig5.make_kernel("knapsack", "cpu")
    port = port_compile(w.loop_body, w.carry_example, *w.body_args,
                        loop=True, nonaliasing_carries=w.nonaliasing_carries)
    return (ref, list(k.full_traces.values())), \
        (port, list(w.full_traces.values()))


def test_knapsack_front_equals_the_reference():
    """Knapsack's Table-I body and traces at 2^14 iterations, on the
    torch engine: the reference's candidates and the recorded front."""
    (ref, ref_traces), (port, port_traces) = _knapsack_pair()
    kw = {"n_iters": 1 << 14, "max_candidates": 12, "use_rescache": False}
    with ref_engine.use("numpy"):
        want = ref.explore(traces=ref_traces, **kw)
    with port_engine.use("torch"):
        got = port.explore(traces=port_traces, **kw)
    _same_result(got, want)
    assert tuple(_front(got)) == REF_KNAPSACK_14
    assert len(got.evaluated()) == 12


def test_chip_smoke_dse_front_is_the_reference():
    """Phase 8's constant: the reference's knapsack front at 2^17."""
    (ref, ref_traces), _ = _knapsack_pair()
    with ref_engine.use("numpy"):
        want = ref.explore(traces=ref_traces, n_iters=chip_smoke.DSE_ITERS,
                           max_candidates=12, use_rescache=False)
    assert chip_smoke.DSE_ITERS == 1 << 17
    assert tuple(_front(want)) == chip_smoke.REF_DSE
    assert len(want.evaluated()) == chip_smoke.REF_DSE_EVALUATED
