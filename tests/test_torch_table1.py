"""The other three Table-I loop bodies (knapsack, Floyd–Warshall, DFS)
through the port's front end, against the reference.

The same seeded numpy inputs (``benchmarks/paper_kernels.py`` and the
port's copies in ``repro_torch.workloads``) go through
``repro.dataflow.compile`` and ``repro_torch.compile`` in loop mode: the
plans must be equal field by field (the reference emits ``jnp.where`` as
a nested ``jit`` equation, which the port lowers to ``select_n``), and so
must the simulator stages.  The ``sequential`` and ``emulated`` backends
run each body on the CPU, bit for bit the plain loop, the numpy oracle
or the reference's jax body stepped on the same inputs.  ``at_set`` and
its lowered ``scatter`` drop out-of-range writes as the reference's
``x.at[i].set`` (``FILL_OR_DROP``) does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from benchmarks.paper_kernels import ALL_KERNELS as REF_KERNELS
from repro.dataflow import compile as ref_compile
from repro_torch import at_set
from repro_torch.core.cdfg import Literal
from repro_torch.workloads import (ALL_KERNELS, make_dfs,
                                   make_floyd_warshall, make_knapsack)

BACKENDS = ("sequential", "emulated")

#: the reference's plans (repro.dataflow.compile(..., loop=True,
#: nonaliasing_carries=...), jax 0.9.0): nodes, stages, channels, bytes
#: per token, pipeline II, total latency, ops per stage, duplicated ops
REF_PLANS = {
    "knapsack": (35, 6, 11, 36, 1, 41, [4, 5, 6, 5, 7, 8], 0),
    "floyd_warshall": (30, 8, 13, 40, 1, 46, [1, 5, 2, 5, 2, 5, 4, 6], 0),
    "dfs": (30, 1, 0, 0, 38, 38, [30], 0),
}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    repro_torch.set_device("cpu")
    yield
    repro_torch.set_device(None)


def _i32(v):
    return torch.tensor(v, dtype=torch.int32)


def _plan(c):
    sch = c.schedule
    return {
        "nodes": len(c.cdfg.nodes),
        "stages": sch.num_stages,
        "channels": sch.num_channels,
        "channel_bytes": sch.channel_bytes,
        "pipeline_ii": sch.pipeline_ii,
        "total_latency": sch.total_latency,
        "ops_per_stage": [sp.eqn_count for sp in c.program.stages],
        "duplicated": len(c.partition.duplicated),
        "latencies": [s.latency for s in sch.stages],
        "iis": [s.ii for s in sch.stages],
        "regions": [list(s.regions) for s in sch.stages],
        "mem_in_scc": [s.mem_in_scc for s in sch.stages],
        # the reference's jnp.where is a nested jit equation
        "prims": [["select_n" if p == "jit" else p for p in s.prims]
                  for s in sch.stages],
        "node_ids": [list(s.node_ids) for s in c.partition.stages],
    }


def _sim(stages):
    return [(s.ii, s.latency, s.mem_in_scc, [a.region for a in s.accesses])
            for s in stages]


@pytest.mark.parametrize("name", sorted(REF_PLANS))
def test_plan_matches_reference(name):
    k = REF_KERNELS[name]()
    w = ALL_KERNELS[name](device="cpu")
    ref_c = ref_compile(k.loop_body, k.carry_example, *k.body_args,
                        loop=True, nonaliasing_carries=k.nonaliasing_carries)
    port_c = repro_torch.compile(w.loop_body, w.carry_example, *w.body_args,
                                 loop=True,
                                 nonaliasing_carries=w.nonaliasing_carries)
    ref, port = _plan(ref_c), _plan(port_c)
    assert port == ref
    assert (port["nodes"], port["stages"], port["channels"],
            port["channel_bytes"], port["pipeline_ii"],
            port["total_latency"], port["ops_per_stage"],
            port["duplicated"]) == REF_PLANS[name]
    assert _sim(port_c.sim_stages(traces=list(w.full_traces.values()))) \
        == _sim(ref_c.sim_stages(traces=list(k.full_traces.values())))
    assert [(d.rule, d.severity, d.loc, d.message)
            for d in port_c.verify()] == \
        [(d.rule, d.severity, d.loc, d.message) for d in ref_c.verify()]


def test_scalar_store_value_stays_a_literal():
    """DFS's ``visited.at[node].set(1)`` is ``scatter c o 1:i32[]``: the
    1 is a literal, so the only constant is the adjacency (``const0``)."""
    w = make_dfs(device="cpu")
    c = repro_torch.compile(w.loop_body, w.carry_example, *w.body_args,
                            loop=True)
    stores = [e for e in c.graph.eqns if e.prim == "scatter"]
    assert len(stores) == 2
    lit = stores[0].invars[2]
    assert isinstance(lit, Literal) and lit.val == 1 \
        and lit.aval.dtype == torch.int32
    assert len(c.graph.consts) == 1
    assert [str(v.aval) for v in c.graph.invars] == \
        ["i32[4000]", "i32[1000]", "i32[]", "i32[]"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_knapsack_runs_to_the_dp_table(backend):
    """W 64, N 8: all 520 (i, j) iterations, j descending, equal the
    plain loop and the reference's vectorized DP."""
    w = make_knapsack(0.02, device="cpu")
    W, N = w.carry_example.shape[0] - 1, len(w.data["weights"])
    assert (W, N) == (64, 8)
    c = repro_torch.compile(w.loop_body, w.carry_example, *w.body_args,
                            loop=True,
                            nonaliasing_carries=w.nonaliasing_carries)
    plain = staged = torch.zeros(W + 1, dtype=torch.int32)
    steps = 0
    for i in range(N):
        for j in range(W, -1, -1):
            ij = (_i32(i), _i32(j))
            plain = w.loop_body(plain, ij)
            staged = c(staged, ij, backend=backend)
            steps += 1
    assert steps == 520
    assert torch.equal(staged, plain)
    np.testing.assert_array_equal(staged.numpy(), w.expected)


@pytest.mark.parametrize("backend", BACKENDS)
def test_floyd_warshall_one_k_pass(backend):
    """n 32, k = 0: the 1,024 (i, j) relaxations equal the plain loop and
    numpy's first relaxation step."""
    w = make_floyd_warshall(0.03125, device="cpu")
    d0 = w.data["dist0"]
    n = d0.shape[0]
    assert n == 32
    c = repro_torch.compile(w.loop_body, w.carry_example, *w.body_args,
                            loop=True,
                            nonaliasing_carries=w.nonaliasing_carries)
    plain = staged = w.carry_example.clone()
    for i in range(n):
        for j in range(n):
            kij = (_i32(0), _i32(i), _i32(j))
            plain = w.loop_body(plain, kij)
            staged = c(staged, kij, backend=backend)
    assert torch.equal(staged, plain)
    np.testing.assert_array_equal(
        staged.numpy().reshape(n, n), np.minimum(d0, d0[:, :1] + d0[:1, :]))


def _dfs_start(w, kind):
    stack, visited, sp = (x.clone() for x in w.carry_example)
    if kind == "seeded":
        # node ids past both ends (a store there drops, a load clamps),
        # half the nodes visited, the stack pointer mid-stack
        rng = np.random.default_rng(7)
        n = visited.shape[0]
        stack = torch.from_numpy(
            rng.integers(-2 * n, 2 * n, stack.shape[0]).astype(np.int32))
        visited = torch.from_numpy(
            rng.integers(0, 2, n).astype(np.int32))
        sp = _i32(5)
    return stack, visited, sp


@pytest.mark.parametrize("start", ["example", "seeded"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_dfs_steps_match_the_reference_body(backend, start):
    """200 DFS steps on the CPU give the (stack, visited, sp) the
    reference's jax loop body gives, stepped on the same inputs."""
    w = make_dfs(device="cpu")
    k = REF_KERNELS["dfs"]()
    c = repro_torch.compile(w.loop_body, w.carry_example, *w.body_args,
                            loop=True)
    port = _dfs_start(w, start)
    ref = tuple(jnp.asarray(x.numpy()) for x in port)
    ref_step = jax.jit(k.loop_body)
    plain = port
    for s in range(200):
        ref = ref_step(ref, jnp.int32(s))
        plain = w.loop_body(plain, _i32(s))
        port = c(port, _i32(s), backend=backend)
    assert isinstance(port, tuple) and len(port) == 3
    for got, pl, want in zip(port, plain, ref):
        assert torch.equal(got, pl)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


N_STORE = 6
STORE_INDICES = [0, 3, -1, -N_STORE, N_STORE, N_STORE + 4, -N_STORE - 1,
                 -3 * N_STORE]


def _check_stores(index, dev):
    """``at_set`` eagerly, and its lowered scatter on both backends (with
    a tensor value and with a Python-scalar literal), on ``dev`` against
    ``jnp``'s ``x.at[i].set``."""
    x = np.arange(10, 10 + N_STORE, dtype=np.int32)
    want_v = np.asarray(jnp.asarray(x).at[jnp.int32(index)].set(-7))
    want_1 = np.asarray(jnp.asarray(x).at[jnp.int32(index)].set(1))
    xt = torch.from_numpy(x).to(dev)
    it, vt = _i32(index).to(dev), _i32(-7).to(dev)
    np.testing.assert_array_equal(at_set(xt, it, vt).cpu().numpy(), want_v)
    np.testing.assert_array_equal(at_set(xt, it, 1).cpu().numpy(), want_1)
    np.testing.assert_array_equal(xt.cpu().numpy(), x)   # out of place

    def store(a, i, v):
        return at_set(a, i, v)

    def store_one(a, i):
        return at_set(a, i, 1)

    c = repro_torch.compile(store, xt, it, vt, stream_argnums=(0,),
                            device=dev)
    c1 = repro_torch.compile(store_one, xt, it, stream_argnums=(0,),
                             device=dev)
    assert [e.prim for e in c.graph.eqns] == \
        ["lt", "add", "select_n", "broadcast_in_dim", "scatter"]
    for b in BACKENDS:
        np.testing.assert_array_equal(c(xt, it, vt, backend=b).cpu().numpy(),
                                      want_v)
        np.testing.assert_array_equal(c1(xt, it, backend=b).cpu().numpy(),
                                      want_1)


@pytest.mark.parametrize("index", STORE_INDICES)
def test_at_set_drops_out_of_range_like_the_reference(index):
    """A negative index wraps once, one still out of range drops the
    write (``FILL_OR_DROP``), eagerly and in the lowered program."""
    _check_stores(index, torch.device("cpu"))


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    return torch.device("cuda")


@pytest.mark.cuda
def test_at_set_drops_out_of_range_on_the_card():
    """The same stores on the card: the drop is computed there (a clamped
    index and a select), without a value going to the host."""
    dev = _needs_card()
    for index in STORE_INDICES:
        _check_stores(index, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("start", ["example", "seeded"])
def test_dfs_steps_on_the_card_match_the_cpu(start):
    """200 DFS steps on the card, both backends, equal the plain loop on
    the CPU (the seeded start stores and loads past both ends)."""
    dev = _needs_card()
    w_cpu = make_dfs(device="cpu")
    w = make_dfs(device=dev)
    c = repro_torch.compile(w.loop_body, w.carry_example, *w.body_args,
                            loop=True, device=dev)
    plain = _dfs_start(w_cpu, start)
    runs = {b: tuple(x.to(dev) for x in plain) for b in BACKENDS}
    for s in range(200):
        plain = w_cpu.loop_body(plain, _i32(s))
        for b in BACKENDS:
            runs[b] = c(runs[b], _i32(s).to(dev), backend=b)
    for b in BACKENDS:
        for got, want in zip(runs[b], plain):
            assert torch.equal(got.cpu(), want)


def test_tuple_arguments_are_checked_and_returned():
    """A tuple carry is one input per leaf and comes back as a tuple; a
    call whose structure differs from the example's raises."""
    w = make_dfs(device="cpu")
    c = repro_torch.compile(w.loop_body, w.carry_example, *w.body_args,
                            loop=True)
    assert len(c.graph.invars) == 4 and len(c.graph.outvars) == 3
    out = c(w.carry_example, _i32(0), backend="eager")
    assert isinstance(out, tuple) and len(out) == 3
    with pytest.raises(TypeError, match="structure"):
        c(w.carry_example[:2], _i32(0), backend="sequential")
    kn = make_knapsack(0.02, device="cpu")
    ck = repro_torch.compile(kn.loop_body, kn.carry_example, *kn.body_args,
                             loop=True)
    assert [v.name for v in ck.graph.invars] == ["dp", "ij_1", "ij_2"]
    assert isinstance(ck(kn.carry_example, (_i32(0), _i32(64)),
                         backend="sequential"), torch.Tensor)
