"""The port's chunk-graph executor (``simulate_dataflow_many(...,
workers=N)``) against the reference.

The same seeded numpy traces go through the reference's streaming engine
and the port's sharded one; cycles, stall buckets and cache counters must
be identical.  The port's pool runs spawned workers, which must take the
master's device policy and engine: here the CPU, on both engines.
"""

import multiprocessing

import numpy as np
import pytest

import repro_torch
from repro.core import rescache as ref_rc
from repro.core import simulator as ref_sim
from repro_torch.core import chunkgraph as port_cg
from repro_torch.core import engine as port_engine
from repro_torch.core import rescache as port_rc
from repro_torch.core import simulator as port_sim

N = 5000


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch, tmp_path):
    """The port on the CPU, both stores in a fresh directory, and a
    canonical chunk of 512 iterations so that N spans ten chunks."""
    repro_torch.set_device("cpu")
    for rc, name in ((ref_rc, "ref"), (port_rc, "port")):
        rc.clear()
        monkeypatch.setattr(rc._cfg, "directory", str(tmp_path / name))
        monkeypatch.setattr(rc._cfg, "enabled", False)
        monkeypatch.setattr(rc, "CHUNK_ITERS", 512)
    yield
    port_rc.clear()
    ref_rc.clear()
    port_engine.select(None)
    repro_torch.set_device(None)


def _pipeline(sim, n=N, seed=5):
    rng = np.random.default_rng(seed)
    return [
        sim.SimStage("addr", ii=1, latency=2,
                     accesses=[sim.MemAccess("i", np.arange(n) * 4)]),
        sim.SimStage("fetch", ii=1, latency=3,
                     accesses=[sim.MemAccess(
                         "x", rng.integers(0, 1 << 19, n) * 4),
                         sim.MemAccess("y", np.arange(n) * 4 + (1 << 22),
                                       is_store=True)]),
        sim.SimStage("fma", ii=4, latency=6),
    ]


def _mems(sim):
    return {"ACP": sim.acp(), "ACPC": sim.acp_cache(),
            "HPC": sim.hp_cache()}


def _same(a, b, what=""):
    assert a.cycles == b.cycles, what
    assert a.stage_stall_cycles == b.stage_stall_cycles, what
    assert (a.cache_hits, a.cache_misses) == \
        (b.cache_hits, b.cache_misses), what


def _sharded(*args, **kwargs):
    """The port's simulate_dataflow_many through the pool, asserting that
    the pool engaged (a silent fallback to streaming would make the
    equality vacuous)."""
    runs0 = port_cg._POOL_RUNS
    out = port_sim.simulate_dataflow_many(*args, **kwargs)
    assert port_cg._POOL_RUNS == runs0 + 1, "the pool did not engage"
    return out


def _reference(stages_of, mems_of, depths):
    return ref_sim.simulate_dataflow_many(
        stages_of(ref_sim), mems_of(ref_sim), N, fifo_depths=depths,
        use_rescache=False)


@pytest.mark.parametrize("engine", ["numpy", "torch"])
@pytest.mark.parametrize("workers", [2, 3])
def test_sharded_equals_streaming_no_cache(workers, engine):
    """Sharded over 2 and 3 workers == the port's streaming engine == the
    reference's, on both engines (torch: the workers run on the CPU the
    master asked for)."""
    ref = _reference(_pipeline, _mems, (4, 16))
    with port_engine.use(engine):
        stream = port_sim.simulate_dataflow_many(
            _pipeline(port_sim), _mems(port_sim), N, fifo_depths=(4, 16),
            use_rescache=False)
        got = _sharded(_pipeline(port_sim), _mems(port_sim), N,
                       fifo_depths=(4, 16), use_rescache=False,
                       workers=workers)
    assert set(got) == set(ref)
    for key in ref:
        _same(stream[key], ref[key], key)
        _same(got[key], ref[key], key)


def test_sharded_write_around_draw_positions():
    """Write-around stores draw from the backing store without touching
    the cache: the master's draw offsets must count them."""
    def stages(sim):
        rng = np.random.default_rng(21)
        return [sim.SimStage("ld", ii=1, latency=2, accesses=[
                    sim.MemAccess("x", rng.integers(0, 1 << 14, N) * 4)]),
                sim.SimStage("st", ii=1, latency=2, accesses=[
                    sim.MemAccess("y", rng.integers(0, 1 << 14, N) * 4,
                                  is_store=True)])]

    def mems(sim):
        return {"wa": sim.MemoryModel(
            name="wa", cache=sim.CacheConfig(write_allocate=False))}

    ref = _reference(stages, mems, (16,))
    got = _sharded(stages(port_sim), mems(port_sim), N, fifo_depths=(16,),
                   use_rescache=False, workers=2)
    _same(got[("wa", 16)], ref[("wa", 16)])


@pytest.mark.parametrize("chunk", [512, 1024])
def test_sharded_equals_streaming_with_store(chunk, monkeypatch):
    """Sharded with the store on (writing chunk records) == the
    reference's cold streaming run; a rerun is served from the store and
    resolves nothing."""
    monkeypatch.setattr(port_rc, "CHUNK_ITERS", chunk)
    port_rc.configure(enabled=True)
    mems = {"ACP": ref_sim.acp(), "ACPC": ref_sim.acp_cache()}
    ref = ref_sim.simulate_dataflow_many(
        _pipeline(ref_sim, seed=6), mems, N, fifo_depths=(16,),
        use_rescache=False)

    def port_mems():
        return {"ACP": port_sim.acp(), "ACPC": port_sim.acp_cache()}

    got = _sharded(_pipeline(port_sim, seed=6), port_mems(), N,
                   fifo_depths=(16,), workers=2)
    for key in ref:
        _same(got[key], ref[key], key)
    assert port_rc.census()["chunks"] > 0
    cold0 = port_rc.stats()["cold_chunks"]
    again = port_sim.simulate_dataflow_many(
        _pipeline(port_sim, seed=6), port_mems(), N, fifo_depths=(16,),
        workers=2)
    for key in ref:
        _same(again[key], ref[key], key)
    assert port_rc.stats()["cold_chunks"] == cold0


def _sharded_in_a_pool_worker(n):
    """``workers=2`` inside a ``multiprocessing.Pool`` worker (a daemonic
    process, which may not start children): the run falls back to the
    streaming engine; returns the cycles and whether the pool engaged."""
    repro_torch.set_device("cpu")
    port_rc.configure(enabled=False)
    port_rc.CHUNK_ITERS = 512
    runs0 = port_cg._POOL_RUNS
    got = port_sim.simulate_dataflow_many(
        _pipeline(port_sim), _mems(port_sim), n, fifo_depths=(16,),
        use_rescache=False, workers=2)
    return {k: v.cycles for k, v in got.items()}, port_cg._POOL_RUNS - runs0


def test_sharded_inside_a_pool_worker_falls_back():
    """The Fig. 5 harness runs its tasks in a pool of daemonic processes,
    where the chunk graph cannot start its workers (the reference fails
    there with "daemonic processes are not allowed to have children"):
    the port resolves in the task's process instead, with the reference's
    cycles."""
    ref = _reference(_pipeline, _mems, (16,))
    with multiprocessing.get_context("spawn").Pool(1) as pool:
        got, pool_runs = pool.apply(_sharded_in_a_pool_worker, (N,))
    assert pool_runs == 0
    assert got == {k: v.cycles for k, v in ref.items()}


def test_default_workers_heuristic():
    """The harness's ``--workers`` default is the reference's."""
    from repro.core.chunkgraph import default_workers as ref_default
    for kw in ({"cpus": 2}, {"cpus": 3, "jobs": 1}, {"cpus": 8, "jobs": 4},
               {"cpus": 8, "jobs": 1}, {"cpus": 16, "jobs": 3},
               {"cpus": 8, "full": False}, {"cpus": 2, "explicit": 3},
               {"cpus": 8, "explicit": 0}):
        assert port_cg.default_workers(**kw) == ref_default(**kw), kw
