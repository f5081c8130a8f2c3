"""The port's front end and driver (repro_torch.core.cdfg on torch.fx,
partition, decouple, channels, emulated pipeline, backends) against the
JAX reference: the same loop body, traced by each package, must compile
to the same plan, and every execution backend must return the plain
result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from benchmarks.paper_kernels import make_spmv as ref_make_spmv
from repro.dataflow import compile as ref_compile
from repro_torch.core.channels import ChannelSpec, DeviceFIFO
from repro_torch.dataflow import compile as port_compile
from repro_torch.dataflow import dataflow_jit
from repro_torch.dataflow.options import ResourceConstraints
from repro_torch.workloads import make_spmv


@pytest.fixture(autouse=True)
def _port_on_cpu():
    repro_torch.set_device("cpu")
    yield
    repro_torch.set_device(None)


def _plan(compiled):
    sch = compiled.schedule
    return {
        "stages": sch.num_stages,
        "channels": sch.num_channels,
        "channel_bytes": sch.channel_bytes,
        "latencies": [s.latency for s in sch.stages],
        "iis": [s.ii for s in sch.stages],
        "pipeline_ii": sch.pipeline_ii,
        "total_latency": sch.total_latency,
        "regions": [list(s.regions) for s in sch.stages],
        "mem_in_scc": [s.mem_in_scc for s in sch.stages],
        "prims": [list(s.prims) for s in sch.stages],
        "in_bytes": [s.in_channel_bytes for s in sch.stages],
        "node_ids": [list(s.node_ids) for s in compiled.partition.stages],
    }


@pytest.fixture(scope="module")
def spmv_pair():
    k = ref_make_spmv(0.125)
    ref = ref_compile(k.loop_body, k.carry_example, *k.body_args, loop=True)
    w = make_spmv(0.125, device="cpu")
    port = port_compile(w.loop_body, w.carry_example, *w.body_args,
                        loop=True, device="cpu")
    return ref, port, w


def test_spmv_plan_matches_reference(spmv_pair):
    ref, port, _ = spmv_pair
    assert _plan(port) == _plan(ref)
    plan = _plan(port)
    assert plan["stages"] == 5 and plan["channels"] == 6
    assert plan["channel_bytes"] == 24
    assert plan["latencies"] == [5, 6, 6, 5, 1]
    assert plan["pipeline_ii"] == 1 and plan["total_latency"] == 23
    assert plan["regions"][:3] == [["const0"], ["const1"], ["const2"]]


def test_spmv_report_is_clean(spmv_pair):
    _, port, _ = spmv_pair
    rep = port.report()
    assert "5 stages, 6 channels (24B/token)" in rep
    assert "verify: clean" in rep
    assert port.verify() == []


@pytest.mark.parametrize("backend", ["sequential", "emulated", "eager"])
def test_backends_return_the_plain_result(spmv_pair, backend):
    """Each backend over the first row's nonzeros equals the direct call
    bit for bit, and the CSR row product within fp32 summation order."""
    _, port, w = spmv_pair
    acc = plain = torch.zeros(())
    indptr = w.data["indptr"]
    for j in range(int(indptr[0]), int(indptr[1])):
        jt = torch.tensor(j, dtype=torch.int32)
        acc = port(acc, jt, backend=backend)
        plain = w.loop_body(plain, jt)
    assert torch.equal(acc, plain)
    np.testing.assert_allclose(float(acc), w.expected[0], rtol=1e-4,
                               atol=1e-4)


def test_gather_body_plan_matches_reference():
    """A second body through the lowering table: a data-dependent gather
    feeding a transcendental, with a Python-scalar operand."""
    rng = np.random.default_rng(1)
    table = rng.normal(size=64).astype(np.float32)
    idx = rng.integers(0, 64, 32).astype(np.int32)
    tj, ij = jnp.asarray(table), jnp.asarray(idx)
    tt, it = torch.from_numpy(table), torch.from_numpy(idx)

    def ref_body(acc, i):
        return acc + jnp.tanh(tj[ij[i]] * 2.0) - acc * 0.5

    def port_body(acc, i):
        return acc + torch.tanh(tt[it[i]] * 2.0) - acc * 0.5

    ref = ref_compile(ref_body, jnp.float32(0), jnp.int32(0), loop=True)
    port = port_compile(port_body, torch.zeros(()),
                        torch.zeros((), dtype=torch.int32), loop=True,
                        device="cpu")
    assert _plan(port) == _plan(ref)
    acc = torch.zeros(())
    for i in range(8):
        i_t = torch.tensor(i, dtype=torch.int32)
        want = port_body(acc, i_t)
        for backend in ("sequential", "emulated"):
            assert torch.equal(port(acc, i_t, backend=backend), want)
        acc = want


def _quickstart_pair():
    """examples/quickstart.py's kernel, traced by each package: a gather
    through an index vector feeding a multiply and a tanh."""
    def ref_kernel(table, idx, w):
        return jnp.tanh(table[idx] * w) + 1.0

    def port_kernel(table, idx, w):
        return torch.tanh(table[idx] * w) + 1.0

    table = np.arange(1024, dtype=np.float32)
    idx = np.asarray([3, 997, 41, 512, 7, 800, 64, 2], np.int32)
    ref = ref_compile(ref_kernel, jnp.asarray(table), jnp.asarray(idx),
                      jnp.float32(1.5), stream_argnums=(1,))
    port = dataflow_jit(port_kernel, stream_argnums=(1,))
    args = (torch.from_numpy(table), torch.from_numpy(idx),
            torch.tensor(1.5))
    return ref, port, args


def test_quickstart_plan_matches_reference():
    ref, port, args = _quickstart_pair()
    compiled = port.lower(*args)
    assert _plan(compiled) == _plan(ref)
    plan = _plan(compiled)
    assert (plan["stages"], plan["channels"], plan["channel_bytes"],
            plan["pipeline_ii"], plan["total_latency"]) == (4, 3, 96, 1, 15)
    assert plan["prims"][0] == ["lt", "add", "select_n", "broadcast_in_dim",
                                "gather"]
    assert plan["regions"][0] == ["arg0"]


@pytest.mark.parametrize("backend", ["sequential", "emulated", "eager"])
def test_quickstart_backends_return_the_direct_call(backend):
    _, port, args = _quickstart_pair()
    assert torch.equal(port(*args, backend=backend), port.__wrapped__(*args))


def test_quickstart_stream_returns_the_direct_calls():
    _, port, (table, idx, w) = _quickstart_pair()
    stream = torch.stack([(idx + t) % 1024 for t in range(6)])
    got = port.lower(table, idx, w).stream(table, stream, w)
    want = torch.stack([port.__wrapped__(table, s, w) for s in stream])
    assert torch.equal(got, want)


@pytest.mark.parametrize("backend", ["sequential", "emulated", "eager"])
def test_staged_gather_plan_matches_reference(backend):
    """decoupled_gather_staged's function: the plan of the reference's
    vmap of a row function, every backend equal to the direct call."""
    rng = np.random.default_rng(2)
    table = rng.normal(size=(64, 128)).astype(np.float32)
    idx = rng.integers(0, 64, 8).astype(np.int32)

    def ref_fn(i, t):
        return jax.vmap(lambda r: jnp.tanh(r * 2.0))(t[i])

    def port_fn(i, t):
        return torch.tanh(t[i] * 2.0)

    ref = ref_compile(ref_fn, jnp.asarray(idx), jnp.asarray(table),
                      stream_argnums=(0,))
    args = (torch.from_numpy(idx), torch.from_numpy(table))
    port = port_compile(port_fn, *args, stream_argnums=(0,), device="cpu")
    assert _plan(port) == _plan(ref)
    plan = _plan(port)
    assert (plan["stages"], plan["channels"], plan["channel_bytes"],
            plan["total_latency"]) == (3, 2, 8192, 14)
    assert torch.equal(port(*args, backend=backend), port_fn(*args))


def test_negative_index_vector_wraps_as_reference():
    rng = np.random.default_rng(3)
    table = rng.normal(size=(16, 4)).astype(np.float32)
    idx = np.asarray([-1, 0, -16, 5, 15, -7], np.int32)

    def ref_fn(t, i):
        return t[i] * 3.0

    def port_fn(t, i):
        return t[i] * 3.0

    ref = ref_compile(ref_fn, jnp.asarray(table), jnp.asarray(idx))
    args = (torch.from_numpy(table), torch.from_numpy(idx))
    port = port_compile(port_fn, *args, device="cpu")
    assert _plan(port) == _plan(ref)
    want = np.asarray(ref(jnp.asarray(table), jnp.asarray(idx)))
    for backend in ("sequential", "emulated"):
        got = port(*args, backend=backend)
        assert torch.equal(got, port_fn(*args))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("index", [
    np.asarray([16, 40, -17, -1, 3, -100], np.int32),   # x[idx]: gather
    np.asarray(20, np.int32),                           # x[j]: dynamic_slice
], ids=["vector", "scalar"])
def test_out_of_range_indices_trace_and_clamp_as_reference(index):
    """Shapes propagate on meta tensors, so example indices past either
    end of the table trace (eager indexing would raise on them), and the
    lowered program clamps them as the reference's gather and
    dynamic_slice do."""
    rng = np.random.default_rng(4)
    table = rng.normal(size=(16, 4)).astype(np.float32)

    def ref_fn(t, i):
        return t[i] * 3.0

    def port_fn(t, i):
        return t[i] * 3.0

    ref = ref_compile(ref_fn, jnp.asarray(table), jnp.asarray(index))
    args = (torch.from_numpy(table), torch.from_numpy(index))
    port = port_compile(port_fn, *args, device="cpu")
    assert _plan(port) == _plan(ref)
    want = np.asarray(ref(jnp.asarray(table), jnp.asarray(index)))
    for backend in ("sequential", "emulated"):
        np.testing.assert_array_equal(port(*args, backend=backend).numpy(),
                                      want)


def test_unlowered_operations_raise():
    x = torch.arange(8.0)

    def body(acc, j):            # cumprod has no lowering rule yet
        return torch.cumprod(acc * x, 0)[j]

    with pytest.raises(NotImplementedError):
        port_compile(body, torch.zeros(()), torch.zeros((), dtype=torch.int32),
                     loop=True, device="cpu")


def test_dse_option_raises_until_ported(spmv_pair):
    """``options.dse`` raised until the explorer was ported; now the dse
    pass explores and re-partitions onto the same plan as the
    reference's."""
    from repro.dataflow import ResourceConstraints as RefConstraints
    _, _, w = spmv_pair
    k = ref_make_spmv(0.125)
    rc = {"n_iters": 512, "max_candidates": 4, "max_fifo_bits": 4096}
    ref = ref_compile(k.loop_body, k.carry_example, *k.body_args, loop=True,
                      dse=RefConstraints(**rc))
    port = port_compile(w.loop_body, w.carry_example, *w.body_args,
                        loop=True, device="cpu",
                        dse=ResourceConstraints(**rc))
    assert port.dse_result is not None
    assert [c.cycles for c in port.dse_result.candidates] == \
        [c.cycles for c in ref.dse_result.candidates]
    assert port.context.plan.groups == ref.context.plan.groups


def test_compile_cache_returns_the_same_artifact(spmv_pair):
    _, port, w = spmv_pair
    again = port_compile(w.loop_body, w.carry_example, *w.body_args,
                         loop=True, device="cpu")
    assert again is port


def test_dataflow_jit_dispatches():
    w = torch.tensor([1.0, -2.0, 3.0])

    @dataflow_jit(device="cpu")
    def f(x):
        return torch.tanh(x * w) + 1.0

    x = torch.tensor([0.5, 0.25, -1.0])
    assert torch.equal(f(x), torch.tanh(x * w) + 1.0)
    assert torch.equal(f(x, backend="emulated"), torch.tanh(x * w) + 1.0)
    assert f.lower(x).num_stages >= 1


@pytest.mark.parametrize("dtype,shape", [
    (torch.float32, ()), (torch.int64, (3,)), (torch.bool, (5,)),
    (torch.float16, (3,)), (torch.int8, (2, 3)),
])
def test_channel_spec_roundtrip(dtype, shape):
    x = (torch.arange(int(np.prod(shape)) or 1) - 2).reshape(shape).to(dtype)
    y = torch.ones((), dtype=torch.float32) * 7.5
    spec = ChannelSpec.from_avals([x, y])
    word = spec.pack([x, y], pad_to=spec.width + 3)
    assert word.dtype == torch.int32 and word.numel() == spec.width + 3
    gx, gy = spec.unpack(word)
    assert torch.equal(gx, x) and torch.equal(gy, y)


def test_device_fifo_backpressure():
    fifo = DeviceFIFO(depth=2, width=3)
    s = fifo.init()
    words = [torch.full((3,), v, dtype=torch.int32) for v in (1, 2, 3)]
    for wd in words:
        s = fifo.push(s, wd)          # the third push meets a full FIFO
    assert int(s.count) == 2 and not bool(fifo.can_push(s))
    out = []
    for _ in range(3):                # the third pop meets an empty one
        wd, s = fifo.pop(s, fifo.can_pop(s))
        out.append(int(wd[0]))
    assert out[:2] == [1, 2] and int(s.count) == 0
