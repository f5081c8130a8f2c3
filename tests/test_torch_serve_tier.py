"""The port's resolution daemon and its client (``repro_torch.serve``)
against the reference's library results.

The same seeded pipelines go through the reference's streaming engine
and through the port's daemon: served results must be the library's bit
for bit, and the reference's exactly-once and fallback contracts must
hold — racing clients resolve each chunk once, a killed worker is
respawned and its chunks replayed, a client with no daemon resolves
locally, and a daemon killed mid-stream is restarted from its journal.
Every client here runs with short timeouts, so no test waits out the
client's defaults.  The daemon and its workers run on the CPU.
"""

import contextlib
import json
import multiprocessing
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest

import repro_torch
from repro.core import simulator as ref_sim
from repro_torch.core import rescache as rc
from repro_torch.core import simulator as port_sim
from repro_torch.serve import client, faults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 5000
#: client timeouts for every test: a missing or dead daemon is given up
#: on within a second, not the defaults' minute
SHORT = client.ServeTimeouts(connect_timeout_s=2.0, request_timeout_s=120.0,
                             max_wait_s=1.0, backoff_base_s=0.02,
                             backoff_cap_s=0.1)


def pipeline(sim, n=N, seed=5):
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


def _key(v):
    return (v.cycles, v.cache_hits, v.cache_misses, v.stage_stall_cycles)


def _library(mems_of=lambda sim: {"ACPC": sim.acp_cache()}, depths=(8,)):
    """The reference's clean library run: no store, streaming engine."""
    return ref_sim.simulate_dataflow_many(
        pipeline(ref_sim), mems_of(ref_sim), N, fifo_depths=depths,
        use_rescache=False)


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")
                + os.pathsep + os.environ.get("PYTHONPATH", ""))


@pytest.fixture()
def store(tmp_path, monkeypatch):
    """The port on the CPU, a fresh store, a chunk grid of 512 (passed
    to spawned clients through the environment), no fault plan, and the
    short client timeouts."""
    repro_torch.set_device("cpu")
    d = str(tmp_path / "store")
    rc.clear()
    rc.configure(enabled=True, directory=d)
    monkeypatch.setattr(rc, "CHUNK_ITERS", 512)
    monkeypatch.setenv("REPRO_CHUNK_ITERS", "512")
    monkeypatch.delenv(faults.ENV, raising=False)
    faults.reset()
    client.configure_timeouts(SHORT)
    yield d
    client.configure_timeouts(None)
    faults.reset()
    rc.clear()
    rc.configure(enabled=False)
    repro_torch.set_device(None)


@contextlib.contextmanager
def daemon(**kw):
    """An in-process daemon on a short private socket path (AF_UNIX paths
    cap at ~107 bytes)."""
    from repro_torch.serve.daemon import ResolutionDaemon
    kw.setdefault("workers", 2)
    d = ResolutionDaemon(address=os.path.join(
        tempfile.mkdtemp(prefix="serve-"), "d.sock"), **kw)
    d.start()
    try:
        yield d
    finally:
        d.stop()


def race_client(i, store, sock, barrier, q, n):
    """One racing tenant in a spawned process: build the request, meet
    the other at the barrier, resolve through the daemon, and report the
    results and the chunks it resolved locally."""
    repro_torch.set_device("cpu")
    rc.configure(enabled=True, directory=store)
    client.configure_timeouts(SHORT)
    stages = pipeline(port_sim, n)
    mems = {"ACPC": port_sim.acp_cache()}
    barrier.wait()
    try:
        out = client.simulate_dataflow_served(stages, mems, n,
                                              fifo_depths=(8,),
                                              address=sock)
        q.put((i, {k: (v.cycles, v.cache_hits, v.cache_misses)
                   for k, v in out.items()}, rc.stats()["cold_chunks"]))
    except Exception as e:  # noqa: BLE001 — reported to the test
        q.put((i, f"ERROR: {type(e).__name__}: {e}", -1))


def test_served_equals_library(store):
    """Cold resolution through the port's daemon == the reference's
    library run, on cached, uncached and write-around-free models and two
    FIFO depths; the daemon resolved every chunk once."""
    def mems(sim):
        return {"ACP": sim.acp(), "ACPC": sim.acp_cache(),
                "HPC": sim.hp_cache()}

    ref = _library(mems, (4, 16))
    with daemon() as d:
        got = client.simulate_dataflow_served(
            pipeline(port_sim), mems(port_sim), N, fifo_depths=(4, 16),
            address=d.address)
        st = d.stats()
    assert set(got) == set(ref)
    for k in ref:
        assert _key(got[k]) == _key(ref[k]), k
    assert st["dedup"]["cold_chunks"] == 10      # ceil(5000 / 512)
    assert st["jobs_completed"] == 1


def test_server_kwarg_falls_back_without_daemon(store):
    """``server=`` with no daemon answers from the local engines."""
    ref = _library(lambda sim: {"ACP": sim.acp()})
    t0 = time.monotonic()
    got = port_sim.simulate_dataflow_many(
        pipeline(port_sim), {"ACP": port_sim.acp()}, N, fifo_depths=(8,),
        server=os.path.join(tempfile.mkdtemp(), "absent.sock"))
    assert time.monotonic() - t0 < 30
    for k in ref:
        assert _key(got[k]) == _key(ref[k]), k


def test_racing_clients_resolve_exactly_once(store):
    """Two client processes race one request through one daemon: both get
    the library's results, neither resolves anything locally, and every
    chunk is resolved cold exactly once (the other client's copy came
    from the store or by attaching in flight)."""
    ref = {k: (v.cycles, v.cache_hits, v.cache_misses)
           for k, v in _library().items()}
    ctx = multiprocessing.get_context("spawn")
    with daemon(throttle_s=0.1) as d:
        barrier = ctx.Barrier(2)
        q = ctx.Queue()
        procs = [ctx.Process(target=race_client,
                             args=(i, store, d.address, barrier, q, N))
                 for i in range(2)]
        for p in procs:
            p.start()
        outs = {}
        try:
            for _ in range(2):
                i, o, local_cold = q.get(timeout=120)
                outs[i] = o
                assert local_cold == 0, o
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.terminate()
        st = d.stats()
    assert outs[0] == ref and outs[1] == ref, outs
    ded = st["dedup"]
    assert ded["inflight_chunks"] > 0          # the race overlapped
    assert ded["cold_chunks"] == \
        ded["store_chunks"] + ded["inflight_chunks"] == 10
    assert st["jobs_completed"] == 1


def test_worker_death_recovery_and_stats(store):
    """A pool worker killed while it holds a chunk is respawned, its
    chunks replayed, the result is the library's, and the churn shows in
    the stats."""
    ref = _library()
    out, err = {}, []

    def run(address):
        try:
            out.update(client.simulate_dataflow_served(
                pipeline(port_sim), {"ACPC": port_sim.acp_cache()}, N,
                fifo_depths=(8,), address=address))
        except Exception as e:  # noqa: BLE001 — reported below
            err.append(e)

    with daemon(throttle_s=0.2, workers=2) as d:
        t = threading.Thread(target=run, args=(d.address,))
        t.start()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            if any(w == 0 for w in d._inflight.values()):
                d._procs[0].kill()
                break
            time.sleep(0.02)
        else:
            pytest.fail("worker 0 never held an in-flight chunk")
        t.join(timeout=120)
        assert not t.is_alive()
        st = d.stats()
    assert not err, err
    for k in ref:
        assert _key(out[k]) == _key(ref[k]), k
    assert st["failures"]["worker_restarts"] >= 1
    assert st["failures"]["chunk_retries"] >= 1
    assert st["census"]["worker_retries"] >= 1


def _arm(monkeypatch, tmp_path, specs):
    """Arm a fault plan through the environment (it reaches the spawned
    workers) with a log file as the cross-process firing registry."""
    log = str(tmp_path / "plan.log")
    monkeypatch.setenv(faults.ENV, json.dumps({"faults": specs,
                                               "log": log}))
    faults.reset()
    return log


def _served_under_fault(monkeypatch, tmp_path, spec, request_timeout_s):
    """One 5000-iteration request through a two-worker daemon with
    ``spec`` armed: the results, the daemon's stats and the fault log."""
    log = _arm(monkeypatch, tmp_path, [spec])
    client.configure_timeouts(client.ServeTimeouts(
        connect_timeout_s=2.0, request_timeout_s=request_timeout_s,
        max_wait_s=1.0, backoff_base_s=0.02, backoff_cap_s=0.1))
    with daemon() as d:
        got = client.simulate_dataflow_served(
            pipeline(port_sim), {"ACPC": port_sim.acp_cache()}, N,
            fifo_depths=(8,), address=d.address)
        st = d.stats()
    return got, st, faults.log_counts(log)


def test_worker_killed_mid_reply_does_not_wedge_the_daemon(
        store, monkeypatch, tmp_path):
    """A worker killed with its reply for chunk 3 half-written: only its
    own channel breaks, the daemon respawns the slot and replays its
    chunks, and the request is served within a short timeout with the
    library's result.  A channel shared by all workers stalls here: the
    torn reply (or the dead writer's lock) holds every other reply back
    until the request times out."""
    ref = _library()
    got, st, fired = _served_under_fault(
        monkeypatch, tmp_path, {"kind": "reply_kill", "chunk": 3}, 30.0)
    for k in ref:
        assert _key(got[k]) == _key(ref[k]), k
    assert fired == {"reply_kill": 1}
    assert st["failures"]["worker_restarts"] >= 1
    assert st["failures"]["chunk_retries"] >= 1
    assert st["jobs_completed"] == 1


def test_chaos_worker_sigkill_mid_chunk(store, monkeypatch, tmp_path):
    """The reference's chaos case: a pool worker SIGKILLs itself at the
    start of chunk 3's task; the daemon respawns the slot, replays its
    in-flight chunks, and the served result is the library's bit for
    bit.  The kill shows in the stats and the fault log."""
    ref = _library()
    got, st, fired = _served_under_fault(
        monkeypatch, tmp_path, {"kind": "worker_kill", "chunk": 3}, 60.0)
    for k in ref:
        assert _key(got[k]) == _key(ref[k]), k
    assert fired == {"worker_kill": 1}
    assert st["failures"]["worker_restarts"] >= 1
    assert st["failures"]["chunk_retries"] >= 1
    assert st["jobs_completed"] == 1


def test_sweep_rows_record_resolution_mode(store):
    """``sweep_schedule`` rows name the resolution that ran: streaming,
    then served through the daemon, with the same cycles."""
    from repro_torch.dataflow.schedule import sweep_schedule

    class _Sched:
        channel_bytes = 4

        def sim_stages(self, traces=None, **kw):
            return pipeline(port_sim, 2000)

    res = sweep_schedule(_Sched(), n_iters=2000, mems={"ACP": port_sim.acp},
                         fifo_depths=(8,))
    assert all(r["resolution_mode"] == "streaming" for r in res.rows)
    with daemon() as d:
        res2 = sweep_schedule(_Sched(), n_iters=2000,
                              mems={"ACP": port_sim.acp}, fifo_depths=(8,),
                              server=d.address)
    assert all(r["resolution_mode"] == f"served:{d.address}"
               for r in res2.rows)
    for a, b in zip(res.rows, res2.rows):
        assert a["dataflow_cycles"] == b["dataflow_cycles"]


def test_options_serve_block_configures_client(store):
    """``CompileOptions.serve`` installs its timeouts in the client and
    defaults ``server=``; with no daemon the simulation runs locally."""
    import torch
    from repro_torch.dataflow import ServeOptions

    def f(x):
        return x * 2.0 + 1.0

    c = repro_torch.compile(f, torch.arange(64, dtype=torch.float32),
                            serve=ServeOptions(max_wait_s=0.5,
                                               backoff_cap_s=0.1),
                            device="cpu")
    assert c.simulate(n_iters=256) is not None
    assert client._cfg(None).max_wait_s == 0.5


def _spawn_daemon_proc(sock, store, extra_env=None):
    """``python -m repro_torch.launch.serve daemon`` on the CPU, waited
    for until it answers."""
    env = _env()
    env.update(extra_env or {})
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "daemon",
         "--socket", sock, "--workers", "2", "--store-dir", store,
         "--speculate-after", "0", "--device", "cpu"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and not client.ping(sock):
        if proc.poll() is not None:
            break
        time.sleep(0.2)
    return proc


def _children(pid):
    """The live child processes of ``pid`` (from ``/proc``)."""
    out = []
    for d in os.listdir("/proc"):
        try:
            with open(f"/proc/{d}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        if ppid == pid:
            out.append(int(d))
    return out


def _kill(pids):
    for pid in pids:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


def _store_files(store):
    """Chunk records only: the cache-effect records committed beside them
    would skew the committed-prefix counts."""
    return sorted(f for f in os.listdir(store) if rc._CHUNK_RE.match(f))


def test_daemon_sigkill_and_journal_restart(store, tmp_path):
    """The daemon kills itself after committing chunk 4.  (a) The client
    fails over and, through ``server=``, finishes from the committed
    prefix with the library's result.  (b) A restarted daemon replays
    its journal and finishes the orphaned job into the store with no
    client attached; a later client is then served with no cold chunk."""
    ref = _library()
    log = str(tmp_path / "dk.log")
    plan = json.dumps({"faults": [{"kind": "daemon_kill", "chunk": 4}],
                       "log": log})
    sock = os.path.join(tempfile.mkdtemp(prefix="serve-"), "d.sock")
    proc = _spawn_daemon_proc(sock, store, {faults.ENV: plan})
    # the daemon's pool: a SIGKILLed daemon leaves it behind, so the test
    # ends it
    pool = _children(proc.pid)
    try:
        assert client.ping(sock), "daemon never came up"
        with pytest.raises(client.ServeUnavailable):
            client.simulate_dataflow_served(
                pipeline(port_sim), {"ACPC": port_sim.acp_cache()}, N,
                fifo_depths=(8,), address=sock)
        assert rc.stats()["serve_failovers"] == 1
        assert faults.log_counts(log) == {"daemon_kill": 1}
        committed = len(_store_files(store))
        assert 1 <= committed < 10
        got = port_sim.simulate_dataflow_many(
            pipeline(port_sim), {"ACPC": port_sim.acp_cache()}, N,
            fifo_depths=(8,), server=sock)
        for k in ref:
            assert _key(got[k]) == _key(ref[k]), k

        proc.wait(timeout=30)
        for f in _store_files(store)[committed:]:
            os.unlink(os.path.join(store, f))
        rc.clear()
        rc.configure(enabled=True, directory=store)
        proc2 = _spawn_daemon_proc(sock, store)
        try:
            assert client.ping(sock), "restarted daemon never came up"
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline \
                    and len(_store_files(store)) < 10:
                time.sleep(0.2)
            assert len(_store_files(store)) == 10, \
                "the restarted daemon did not finish the journaled job"
            st = client.get_stats(sock)
            assert st["journal"]["enabled"]
            assert st["journal"]["restarts"] >= 1
            assert st["journal"]["resumed_jobs"] >= 1
            assert client.shutdown(sock)
            proc2.wait(timeout=30)
        finally:
            if proc2.poll() is None:
                proc2.kill()
        rc.clear()
        rc.configure(enabled=True, directory=store)
        warm = port_sim.simulate_dataflow_many(
            pipeline(port_sim), {"ACPC": port_sim.acp_cache()}, N,
            fifo_depths=(8,))
        for k in ref:
            assert _key(warm[k]) == _key(ref[k]), k
        assert rc.stats()["cold_chunks"] == 0
    finally:
        if proc.poll() is None:
            proc.kill()
        _kill(pool)


def test_daemon_cli_stats_and_shutdown(store):
    """The launch CLI: ``daemon --device cpu`` in the foreground, ``stats``
    as JSON, ``shutdown`` ends the process."""
    sock = os.path.join(tempfile.mkdtemp(prefix="serve-"), "cli.sock")
    env = _env()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "daemon",
         "--socket", sock, "--workers", "1", "--store-dir", rc._dir(),
         "--device", "cpu"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not client.ping(sock):
            time.sleep(0.2)
        assert client.ping(sock)
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "stats",
             "--socket", sock], env=env, capture_output=True, text=True,
            timeout=60)
        assert out.returncode == 0, out.stderr
        stats = json.loads(out.stdout)
        assert stats["chunk_iters"] == 512 and stats["workers"] == 1
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "shutdown",
             "--socket", sock], env=env, capture_output=True, text=True,
            timeout=60)
        assert out.returncode == 0, out.stderr
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()


def test_ensure_daemon_spawns_the_ports_daemon(store):
    """``ensure_daemon`` starts ``repro_torch.launch.serve`` (not the
    reference's) on this process's device and engine, under a socket
    name of the port's own; a second call finds it."""
    assert os.path.basename(client.protocol.default_address()) \
        .startswith("repro-torch-serve-")
    sock = os.path.join(tempfile.mkdtemp(prefix="serve-"), "e.sock")
    try:
        assert client.ensure_daemon(sock, workers=1) == sock
        assert client.ensure_daemon(sock, workers=1) == sock
        assert client.get_stats(sock)["workers"] == 1
        with open(sock + ".pid") as f:
            pid = int(f.read().split(".")[0])
        with open(f"/proc/{pid}/cmdline") as f:
            argv = f.read().split("\0")
        assert argv[1:3] == ["-m", "repro_torch.launch.serve"], argv
        assert argv[argv.index("--device") + 1] == "cpu"
        assert argv[argv.index("--store-dir") + 1] == store
    finally:
        assert client.shutdown(sock)


def test_serve_timeouts_env_and_configure(monkeypatch):
    monkeypatch.setenv("REPRO_SERVE_CONNECT_TIMEOUT_S", "3.5")
    monkeypatch.setenv("REPRO_SERVE_MAX_WAIT_S", "7")
    monkeypatch.setenv("REPRO_SERVE_DEADLINE_S", "42")
    t = client.ServeTimeouts.from_env()
    assert t.connect_timeout_s == 3.5
    assert t.max_wait_s == 7.0 and t.deadline_s == 42.0
    try:
        client.configure_timeouts(max_wait_s=1.25)
        assert client._cfg(None).max_wait_s == 1.25
        assert client._cfg(client.ServeTimeouts(max_wait_s=9.0)) \
            .max_wait_s == 9.0
    finally:
        client.configure_timeouts(None)


def test_step_guard_retries_from_checkpoint():
    from repro_torch.runtime.fault_tolerance import GuardConfig, StepGuard
    calls = {"restores": 0}

    def restore():
        calls["restores"] += 1
        return {"w": 0.0}, 0

    guard = StepGuard(lambda s, b: (s, {"loss": 1.0}),
                      GuardConfig(max_retries=3, restore_fn=restore,
                                  fail_at=lambda step: step == 2))
    for step in range(4):
        _, m = guard.run({"w": 0.0}, {}, step)
        assert m["loss"] == 1.0
    assert guard.failures == 1 and guard.restores == 1
    assert calls["restores"] == 1


def test_step_guard_budget_exhausted():
    from repro_torch.runtime.fault_tolerance import (GuardConfig,
                                                     StepFailure, StepGuard)

    def always_fail(s, b):
        raise StepFailure("boom")

    guard = StepGuard(always_fail, GuardConfig(max_retries=2))
    with pytest.raises(StepFailure):
        guard.run({}, {}, 0)
    assert guard.failures == 3


def test_speculation_policy_overdue_logic():
    from repro_torch.runtime.fault_tolerance import SpeculationPolicy
    pol = SpeculationPolicy(min_wait_s=2.0, latency_factor=4.0)
    assert not pol.overdue(1e9)
    for w in (0.1, 0.2, 0.3):
        pol.observe(w)
    assert pol.median_wall() == 0.2
    assert not pol.overdue(1.9)
    assert pol.overdue(2.1)
    pol2 = SpeculationPolicy(min_wait_s=0.1, latency_factor=4.0)
    for w in (1.0, 1.0, 1.0):
        pol2.observe(w)
    assert not pol2.overdue(3.9)
    assert pol2.overdue(4.1)
    snap = pol2.snapshot()
    assert snap["median_wall_s"] == 1.0 and snap["issued"] == 0
