"""The chunk-graph executor: sharded trace resolution on a process pool.

The streaming resolver of :mod:`repro_torch.core.simulator` visits a kernel's
iteration range chunk by chunk with *carried* state — the on-PL cache's
replacement state and each memory model's RNG draw position thread
serially through the chunks, so one core does all the work while the
rest idle behind its memory bandwidth.  This module breaks that chain
into a **chunk graph** whose expensive nodes are independent:

* **Phase A+B (parallel, fused)** — each chunk replays **once** from
  an empty cache
  (:meth:`~repro_torch.core.simulator._SharedResolver.chunk_effects_fused`),
  producing both its *own* cache effect — the per-set "last N distinct
  lines" recency stacks, an associative monoid needing no incoming
  state — and its hit flags up to a small boundary-ambiguity table
  (the chunk's first ``ways`` first-touches per set, the only verdicts
  an incoming state can change).  Earlier revisions ran phases A and B
  as two full replays, which made 2-way sharding an honest slowdown
  (0.19× recorded in BENCH_sim.json); the fused pass does the work
  exactly once.  Effects are additionally persisted as rescache
  *effect records* (``<key>.eNNNNN.npz``) so a re-shard composes
  stored effects instead of waiting for phase-A messages at all.
* **Compose (master, cheap)** — a serial scan over the tiny per-chunk
  effect snapshots (:func:`~repro_torch.core.simulator.compose_stacks`) —
  stored effect records when present, phase-A messages otherwise —
  yields every chunk's exact *incoming* cache state.
* **Finalize (parallel, tiny)** — each worker patches its chunk's
  ambiguous verdicts against the incoming state
  (:meth:`~repro_torch.core.simulator._SharedResolver.finalize_replay`)
  and installs the composed outgoing stacks — bit-identical to a full
  warm replay, at the cost of a few hundred boundary lookups.
* **Phase C (parallel)** — backing-store draws.  The draw stream is
  position-exact (one PCG64 double per draw), so the master turns the
  per-chunk miss counts into per-chunk draw *offsets* and each worker
  fast-forwards a fresh seeded RNG with ``advance`` — draw-for-draw
  identical to the streaming pass.  The per-op latency matrices are
  committed to the rescache as ordinary v3 chunk records (or handed
  back inline when the artifact is above the size cap).
* **Fold + solve (master, overlapped)** — the master consumes chunks in
  order, folds them into per-stage arrays, and runs every (memory model
  × FIFO depth) lane's wavefront solve with the depth-incremental warm
  start — concurrently with the workers resolving ahead.

The result is bit-identical to the streaming engine (same canonical
access order, same replacement decisions, same draw stream — asserted
access-for-access in tests); only the wall clock changes.  Served and
resumed prefixes compose with sharding: chunks below the store's resume
point never reach the pool.

Workers receive the stage list via ``cloudpickle`` (the paper kernels'
window generators are closures, which plain pickle rejects); when
``cloudpickle`` is unavailable or the payload will not serialize, the
caller transparently falls back to the streaming path.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import time
import traceback
from collections import deque
from typing import Mapping, Sequence

import numpy as np

#: Outstanding chunks per worker before the master stops dispatching
#: (bounds queue memory: at most ``workers * _WINDOW`` unconsumed
#: per-op matrices are in flight).
_WINDOW = 2

#: Chunk re-dispatches tolerated per run after worker deaths (OOM
#: kills, segfaults) before the run hard-fails instead of looping —
#: every retry is counted in ``rescache.census()["worker_retries"]``.
RETRY_BUDGET = 3

#: Completed pool executions in this process — lets tests assert the
#: sharded path actually engaged rather than silently falling back to
#: the streaming engine (missing cloudpickle, too few chunks, …).
_POOL_RUNS = 0


def default_workers(*, cpus: int | None = None, jobs: int = 1,
                    explicit: int | None = None,
                    full: bool = True) -> int:
    """The ``--workers`` default heuristic, shared by every benchmark
    driver: the fused effect+replay pass made sharding break even on
    2 cores (``worker_scaling`` in BENCH_sim.json; it recorded 0.19×
    when phases A and B were two separate replays), but process spawn
    and payload pickling still cost seconds that only amortize when
    several cores actually run concurrently — so auto-sharding keeps
    falling back to the streaming engine below 4 cores unless the user
    passed an explicit count.  ``jobs`` is the concurrent task-pool
    width the workers share the cores with."""
    if explicit is not None:
        return max(1, explicit)
    if cpus is None:
        cpus = multiprocessing.cpu_count()
    if not full or cpus < 4:
        return 1
    return max(2, cpus // max(1, jobs))


def _compose_state(older, newer):
    """Compose two per-geometry state maps (``None`` = empty cache)."""
    from .simulator import compose_stacks
    if older is None:
        return newer
    out = {}
    for geo, (stk_new, mt_new) in newer.items():
        old = older.get(geo)
        if old is None:
            out[geo] = (stk_new, mt_new)
        else:
            out[geo] = (compose_stacks(old[0], stk_new),
                        max(old[1], mt_new))
    return out


def _worker_main(payload_bytes: bytes, task_q, result_q,
                 device=None) -> None:
    """One pool worker: processes its chunks' A/B/C phases, exchanging
    tiny state messages with the master (see the module docstring).
    ``device`` is the master's device policy: a spawned worker starts
    with the port's defaults, so it is installed before anything else."""
    from .. import _device
    _device.set_device(device)
    current = -1
    try:
        import cloudpickle
        p = cloudpickle.loads(payload_bytes)
        from . import engine as _eng
        from . import rescache as _rc
        from ..serve import faults as _faults
        from .simulator import _SharedResolver, _lat_itemsize
        _rc.configure(**p["rescache_cfg"])
        _rc.CHUNK_ITERS = p["C"]
        if p.get("engine"):  # master's backend, not the worker's env
            _eng.select(p["engine"])
        resolver = _SharedResolver(p["stages"], p["mems"], p["seed"],
                                   capture=p["capture"])
        writers = {mn: _rc.ChunkWriter(
            key, resolver.K, p["n_iters"],
            itemsize=_lat_itemsize(p["mems"][mn]))
            for mn, key in p["keys"].items() if key is not None}
        writers = {mn: w for mn, w in writers.items() if not w.dead}
        pending: deque = deque()
        mailbox: dict[tuple, tuple] = {}

        def next_msg(kind: str, k: int):
            """Wait for the master's (kind, k) reply, buffering tasks
            and replies that belong to this worker's later chunks."""
            want = (kind, k)
            while want not in mailbox:
                m = task_q.get()
                if m[0] == "task":
                    pending.append(m)
                elif m[0] == "stop":
                    return None
                else:
                    mailbox[(m[0], m[1])] = m
            return mailbox.pop(want)

        def next_task():
            if pending:
                return pending.popleft()
            while True:
                m = task_q.get()
                if m[0] in ("task", "stop"):
                    return m
                mailbox[(m[0], m[1])] = m

        while True:
            msg = next_task()
            if msg[0] == "stop":
                return
            _, k, lo, hi = msg
            current = k
            if _faults.active():  # chaos: die mid-chunk
                _faults.maybe_kill("worker_kill", chunk=k)
            # A+B fused: one empty-cache replay yields the chunk's own
            # effect AND its hit flags up to the boundary-ambiguity
            # table finalize_replay patches below — the second full
            # replay the unfused executor paid is gone
            effects, n_addrs = resolver.chunk_effects_fused(lo, hi)
            with _eng.phase("effect"):
                for mn, ekey in p.get("effect_keys", {}).items():
                    geo = resolver.cache_keys[mn]
                    if geo is not None and geo in effects:
                        _rc.put_effect(ekey, k, effects[geo], n_addrs)
            result_q.put(("effect", k, effects, n_addrs))
            # B: patch the fused verdicts against the composed
            # incoming state and install the outgoing stacks
            m = next_msg("state", k)
            if m is None:
                return
            deltas = resolver.finalize_replay(m[2])
            result_q.put(("replay", k, deltas))
            # C: position the draw streams, materialize latencies
            m = next_msg("draws", k)
            if m is None:
                return
            if _faults.active():  # chaos: straggle in the heavy phase
                _faults.maybe_sleep("straggler", chunk=k)
            for mn, cum in m[2].items():
                resolver.import_resume(mn, {}, {"draws": cum["base"]})
                geo = resolver.cache_keys[mn]
                if geo is not None:
                    resolver.caches[geo].hits = cum["hits_after"]
                    resolver.caches[geo].misses = cum["misses_after"]
            resolver.finish(lo, hi, fold=False)
            ops_payload = {}
            for mn in p["mems"]:
                w = writers.get(mn)
                if w is not None and lo // p["C"] < w.max_chunks:
                    hb = vb = None
                    if resolver.last_hits.get(mn) is not None:
                        hb = _rc.pack_flags(resolver.last_hits[mn])
                        vb = _rc.pack_flags(resolver.last_visits[mn])
                    states, cum = resolver.export_resume(mn)
                    w.add(lo // p["C"], hi - lo,
                          np.ascontiguousarray(resolver.last_ops[mn]),
                          hb, vb, states, cum)
                    ops_payload[mn] = None  # master reads the record
                else:
                    # no writer, or past the artifact's stored-prefix
                    # budget: hand the matrix back inline
                    ops_payload[mn] = _rc.shrink_ops(
                        resolver.last_ops[mn])
            cums = {mn: resolver.export_resume(mn)[1]
                    for mn in p["mems"]}
            walls = _eng.walls()
            _eng.reset_walls()
            result_q.put(("done", k, cums, ops_payload, walls))
    except Exception:  # noqa: BLE001 - forwarded to the master verbatim
        result_q.put(("error", current, traceback.format_exc()))


def simulate_dataflow_sharded(
    stages: Sequence,
    mems: Mapping[str, object],
    n_iters: int,
    *,
    fifo_depths: Sequence[int],
    freq_mhz: float,
    seed: int,
    workers: int,
    collect_stalls: bool,
    use_rescache: bool | None,
    depth_incremental: bool = True,
):
    """Grid simulation with resolution sharded over ``workers``
    processes — the entry point behind
    ``simulate_dataflow_many(..., workers=N)``.  Falls back to the
    streaming engine whenever sharding cannot help (no live resolution,
    too few chunks) or the stage list will not serialize."""
    from . import engine as _eng
    from . import rescache as _rc
    from .simulator import (SimResult, _LaneSolver, _OpFolder,
                            _ResolutionPlan, _ServeLost,
                            _dataflow_many_stream)

    mems = dict(mems)

    def _stream(rescache_override):
        try:
            return _dataflow_many_stream(
                stages, mems, n_iters, fifo_depths=fifo_depths,
                freq_mhz=freq_mhz, seed=seed,
                chunk_iters=_rc.CHUNK_ITERS,
                collect_stalls=collect_stalls,
                use_rescache=rescache_override,
                depth_incremental=depth_incremental)
        except _ServeLost:  # raced store eviction: redo cold
            if rescache_override is False:
                raise
            return _dataflow_many_stream(
                stages, mems, n_iters, fifo_depths=fifo_depths,
                freq_mhz=freq_mhz, seed=seed,
                chunk_iters=_rc.CHUNK_ITERS,
                collect_stalls=collect_stalls, use_rescache=False,
                depth_incremental=depth_incremental)

    try:
        plan = _ResolutionPlan("dataflow", stages, mems, seed, n_iters,
                               use_rescache)
    except _ServeLost:
        return _stream(False)
    C = plan.C
    n_chunks = -(-n_iters // C)
    first_live = plan.resume // C
    # a daemonic process (a multiprocessing.Pool worker, such as a task
    # of the Fig. 5 harness's --jobs pool) may not start children
    if not plan.live or n_chunks - first_live < 2 or workers < 2 \
            or multiprocessing.current_process().daemon:
        return _stream(use_rescache)
    # every live cached model with a v3 key also persists its chunks'
    # cache-effect monoids as effect records (tiny, content-determined)
    # — the next shard of this artifact composes them from the store
    # and never waits on the phase-A message chain
    effect_keys = {}
    if _rc.enabled(use_rescache):
        effect_keys = {
            mn: plan.keys[mn] for mn in plan.live
            if plan.keys.get(mn) is not None
            and plan.resolver.cache_keys[mn] is not None}
    try:
        import cloudpickle
        payload = cloudpickle.dumps({
            "stages": list(stages),
            "mems": plan.live,
            "seed": seed,
            "n_iters": n_iters,
            "C": C,
            "capture": bool(plan.writers),
            "keys": {mn: plan.keys[mn] for mn in plan.writers},
            "engine": _eng.current(),
            "effect_keys": effect_keys,
            "rescache_cfg": {
                "enabled": _rc._cfg.enabled,
                "directory": _rc._dir(),
                "memory_mb": _rc._cfg.memory_mb,
                "artifact_mb": _rc._cfg.artifact_mb,
                "disk_mb": _rc._cfg.disk_mb,
            },
        })
    except Exception:  # unpicklable traces: shard is impossible
        return _stream(use_rescache)

    W = min(workers, n_chunks - first_live)
    ctx = multiprocessing.get_context("spawn")
    result_q = ctx.Queue()
    task_qs = [ctx.Queue() for _ in range(W)]
    from .. import _device
    procs = [ctx.Process(target=_worker_main,
                         args=(payload, task_qs[w], result_q,
                               _device.policy()),
                         daemon=True)
             for w in range(W)]
    for pr in procs:
        pr.start()

    #: chunk -> worker; seeded round-robin, rewritten when a dead
    #: worker's in-flight chunks are re-dispatched
    owner_of: dict[int, int] = {}

    def owner(k: int) -> int:
        return owner_of.setdefault(k, (k - first_live) % W)

    folder = _OpFolder(stages)
    live_cold: set[int] = set()  # live chunks, for the store census
    solvers = {(mn, d): _LaneSolver(stages, d, collect_stalls)
               for mn in mems for d in fifo_depths}
    depth_order = sorted(set(fifo_depths), reverse=True)
    resolver = plan.resolver

    def solve_chunk(k: int, ops_by_model) -> None:
        lo = k * C
        hi = min(lo + C, n_iters)
        for mn in mems:
            if mn in plan.served:
                L = plan.served[mn].chunk(lo, hi)
                _rc.note_chunks(served=1)
            elif k < first_live:
                L = plan.live_ops(mn, lo, hi)
                _rc.note_chunks(served=1)
            elif ops_by_model[mn] is not None:
                L = ops_by_model[mn]
            else:
                # refresh: the worker just (re)wrote this record; a
                # stale partial tail may still sit in the master's LRU
                rec = _rc.get_chunk(plan.keys[mn], k, refresh=True)
                if rec is None:
                    raise _ServeLost(
                        f"sharded record {plan.keys[mn]}.c{k} vanished")
                L = rec.ops
            if L.dtype != np.int32:  # widen shrunk records for the fold
                L = L.astype(np.int32)
            res = folder.fold(mems[mn], lo, hi, L)
            if mn not in plan.served and k >= first_live:
                live_cold.add(k)
            warm = None
            for d in depth_order:
                warm = solvers[(mn, d)].solve_chunk(
                    res, warm=warm if depth_incremental else None)

    # master bookkeeping: effect composition, draw prefixes, dispatch
    state_at: dict[int, dict | None] = {
        first_live: ({geo: sim.export_stacks()
                      for geo, sim in resolver.caches.items()}
                     if plan.resume > 0 else None)}
    effects: dict[int, dict] = {}
    n_addrs: dict[int, int] = {}
    # stored effect records seed the state chain ahead of the workers:
    # walk forward from the resume point while every geometry's effect
    # is on disk, so pump_sends never waits on a phase-A message for a
    # chunk this store has seen before (snapshots are ~KB each and the
    # send-side prune below keeps the live set O(workers))
    if effect_keys and resolver.caches:
        need: dict[tuple, str] = {}
        for mn, ekey in effect_keys.items():
            need.setdefault(resolver.cache_keys[mn], ekey)
        if set(need) == set(resolver.caches):
            k = first_live
            while k < n_chunks:
                recs = {geo: _rc.get_effect(ekey, k)
                        for geo, ekey in need.items()}
                if any(r is None for r in recs.values()):
                    break
                state_at[k + 1] = _compose_state(
                    state_at[k],
                    {geo: (r[0], r[1]) for geo, r in recs.items()})
                n_addrs[k] = next(iter(recs.values()))[2]
                k += 1
    deltas: dict[int, dict] = {}
    done: dict[int, dict] = {}
    cum_draws = dict(resolver.draws)
    geo_cum = {geo: (sim.hits, sim.misses)
               for geo, sim in resolver.caches.items()}
    final_cums: dict[str, dict] = {}
    #: master-side replay log for worker-death recovery: every state /
    #: draws message stays addressable until its chunk's ``done``
    #: arrives, so a respawned worker can be fed the exact same
    #: messages (bit-identical replay; bounded by ``W * _WINDOW``)
    sent_state: dict[int, dict] = {}
    sent_draws: dict[int, dict] = {}
    retries = 0

    # speculative straggler re-dispatch (the StragglerPolicy
    # bounded-staleness rule applied to chunk dispatch): a phase-C
    # chunk whose wall exceeds the SpeculationPolicy threshold is
    # replayed in full (task + state + draws) on a second live worker.
    # The master's fold stalls at the straggling chunk while its peers
    # drain to idle, so the duplicate lands on an idle worker;
    # resolution is deterministic, so the first "done" wins and the
    # loser's messages die on the ordinary duplicate guards below.
    spec_after = float(os.environ.get("REPRO_SPECULATE_AFTER_S",
                                      "30") or 0)
    spec_policy = None
    if W > 1 and spec_after > 0:
        from ..runtime.fault_tolerance import SpeculationPolicy
        spec_policy = SpeculationPolicy(min_wait_s=spec_after,
                                        max_inflight=max(1, W // 2))
    draws_t: dict[int, float] = {}   # chunk -> phase-C dispatch time
    spec_owner: dict[int, int] = {}  # chunk -> speculative worker
    # the idle-poll interval is also the straggler-detection latency:
    # shrink it when the speculation threshold is below the default
    poll_s = 5.0 if spec_policy is None else \
        min(5.0, max(0.25, spec_policy.min_wait_s / 2))

    dispatched = first_live
    state_sent = first_live
    draws_sent = first_live
    solved = 0
    failure: str | None = None
    try:
        def dispatch_upto(limit: int) -> None:
            nonlocal dispatched
            while dispatched < min(limit, n_chunks):
                k = dispatched
                task_qs[owner(k)].put(
                    ("task", k, k * C, min((k + 1) * C, n_iters)))
                dispatched += 1

        def pump_sends() -> None:
            nonlocal state_sent, draws_sent
            while state_sent < dispatched and state_sent in state_at:
                k = state_sent
                sent_state[k] = state_at[k] or {}
                task_qs[owner(k)].put(("state", k, sent_state[k]))
                state_sent += 1
            while draws_sent < dispatched and draws_sent in deltas:
                k = draws_sent
                msg = {}
                for mn, mem in plan.live.items():
                    geo = resolver.cache_keys[mn]
                    entry = {"base": cum_draws[mn]}
                    if mem.backing_hit_rate > 0.0:
                        # draws consumed this chunk: every backing trip
                        # (misses + write-around stores) for cached
                        # models, every participating access otherwise
                        cum_draws[mn] += deltas[k][geo][2] \
                            if geo is not None else n_addrs[k]
                    if geo is not None:
                        h, m = geo_cum[geo]
                        entry["hits_after"] = h + deltas[k][geo][0]
                        entry["misses_after"] = m + deltas[k][geo][1]
                    msg[mn] = entry
                for geo, d in deltas[k].items():
                    h, m = geo_cum[geo]
                    geo_cum[geo] = (h + d[0], m + d[1])
                sent_draws[k] = msg
                task_qs[owner(k)].put(("draws", k, msg))
                draws_t[k] = time.monotonic()
                del deltas[k]  # fully consumed: keep the master O(W)
                n_addrs.pop(k, None)
                effects.pop(k, None)  # duplicate after a retry replay
                draws_sent += 1
            # a state snapshot is dead once it was sent and composed
            # into its successor — prune so a thousand-chunk run keeps
            # O(workers) snapshots, not O(chunks)
            for j in [j for j in state_at
                      if j < state_sent and j + 1 in state_at]:
                del state_at[j]

        dispatch_upto(first_live + W * _WINDOW)
        pump_sends()
        # chunks below the resume point solve immediately from records
        while solved < first_live:
            solve_chunk(solved, None)
            solved += 1
        while solved < n_chunks:
            if solved in done:
                cums, ops = done.pop(solved)
                final_cums.update(cums)
                solve_chunk(solved, ops)
                solved += 1
                dispatch_upto(solved + W * _WINDOW)
                pump_sends()
                continue
            try:
                msg = result_q.get(timeout=poll_s)
            except queue.Empty:
                if spec_policy is not None:
                    now = time.monotonic()
                    for k in sorted(draws_t):
                        if (k in spec_owner or k in done
                                or len(spec_owner)
                                >= spec_policy.max_inflight
                                or not spec_policy.overdue(
                                    now - draws_t[k])):
                            continue
                        alts = [w for w in range(W)
                                if w != owner_of.get(k)
                                and procs[w].is_alive()]
                        if not alts:
                            continue
                        w2 = alts[k % len(alts)]
                        task_qs[w2].put(
                            ("task", k, k * C,
                             min((k + 1) * C, n_iters)))
                        task_qs[w2].put(("state", k, sent_state[k]))
                        task_qs[w2].put(("draws", k, sent_draws[k]))
                        spec_owner[k] = w2
                        spec_policy.issued += 1
                        _rc.note_speculation()
                dead = [w for w, pr in enumerate(procs)
                        if not pr.is_alive()]
                if not dead:
                    continue
                # died without posting (OOM kill, segfault): respawn
                # the slot and replay its in-flight chunks' messages
                # verbatim — resolution is deterministic, so the retry
                # is bit-identical — under a bounded budget
                for k in [k for k, w in spec_owner.items()
                          if w in dead]:
                    spec_owner.pop(k)  # spec copy lost with its worker
                redo = [k for k in range(solved, dispatched)
                        if k not in done and owner_of.get(k) in dead]
                retries += len(redo)
                _rc.note_worker_retries(len(redo))
                if retries > RETRY_BUDGET:
                    failure = (
                        f"worker(s) {dead} exited with code(s) "
                        f"{[procs[w].exitcode for w in dead]}; retry "
                        f"budget exhausted ({retries} > {RETRY_BUDGET})")
                    break
                for w in dead:
                    task_qs[w] = ctx.Queue()
                    procs[w] = ctx.Process(
                        target=_worker_main,
                        args=(payload, task_qs[w], result_q,
                              _device.policy()),
                        daemon=True)
                    procs[w].start()
                for k in sorted(redo):
                    w = owner_of[k]
                    task_qs[w].put(
                        ("task", k, k * C, min((k + 1) * C, n_iters)))
                    if k < state_sent:
                        task_qs[w].put(("state", k, sent_state[k]))
                    if k < draws_sent:
                        task_qs[w].put(("draws", k, sent_draws[k]))
                continue
            kind = msg[0]
            if kind == "error":
                failure = msg[2]
                break
            if kind == "effect":
                _, k, eff, na = msg
                if k + 1 in state_at or k < draws_sent:
                    continue  # duplicate from a retried chunk
                effects[k] = eff
                n_addrs[k] = na
                while (k + 1 not in state_at) and k in state_at \
                        and k in effects:
                    state_at[k + 1] = _compose_state(state_at[k],
                                                     effects.pop(k))
                    k += 1
            elif kind == "replay":
                if msg[1] >= draws_sent:  # else: retry duplicate
                    deltas[msg[1]] = msg[2]
            elif kind == "done":
                t0 = draws_t.pop(msg[1], None)
                if spec_policy is not None:
                    if msg[1] in spec_owner:
                        spec_policy.wins += 1  # a duplicate was live
                    if t0 is not None:
                        spec_policy.observe(time.monotonic() - t0)
                spec_owner.pop(msg[1], None)
                if msg[1] >= solved:
                    if msg[1] not in done:  # not a speculative dup
                        _eng.merge_walls(msg[4])
                    done[msg[1]] = (msg[2], msg[3])
                    sent_state.pop(msg[1], None)
                    sent_draws.pop(msg[1], None)
            pump_sends()
        if failure is not None:
            raise RuntimeError(
                f"chunk-graph worker failed:\n{failure}")
    except _ServeLost:
        for q in task_qs:
            q.put(("stop",))
        for pr in procs:
            pr.terminate()
        return _stream(False)
    finally:
        for q in task_qs:
            try:
                q.put(("stop",))
            except Exception:
                pass
        for pr in procs:
            pr.join(timeout=5)
            if pr.is_alive():
                pr.terminate()

    global _POOL_RUNS
    _POOL_RUNS += 1
    _rc.note_chunks(cold=len(live_cold))
    out: dict[tuple[str, int], SimResult] = {}
    for (mn, d), solver in solvers.items():
        if mn in plan.served:
            ch, cm = plan.served[mn].stats_upto(n_iters)
        else:
            cum = final_cums.get(mn, {})
            ch, cm = int(cum.get("hits", 0)), int(cum.get("misses", 0))
        out[(mn, d)] = SimResult("dataflow", solver.last_finish, n_iters,
                                 freq_mhz, solver.stall, ch, cm)
    return out