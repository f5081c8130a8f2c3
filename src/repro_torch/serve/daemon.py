"""The resolution daemon: one global scheduler, many tenants.

``ResolutionDaemon`` owns a spawn-pool of :mod:`repro_torch.serve.worker`
processes and a single work-stealing scheduler feeding them.  Clients
(:mod:`repro_torch.serve.client`) submit *resolution requests* — the live
(un-served) models of one ``simulate_dataflow_many`` grid — over a
local socket; the daemon answers with a stream of per-chunk completion
records the client folds and solves incrementally.

Requests dedup three ways, in order:

* **store** — chunks inside the v3 rescache's stored prefix are never
  scheduled; the client folds them straight from the records
  (prefix-serving included).
* **in-flight** — requests are keyed by their per-op content keys; a
  request whose key set matches a running **job** attaches to it and
  receives the same stream (N clients asking for overlapping grids pay
  for one resolution).  A request needing *more* chunks of the same
  artifact extends the job in place — chunks always resolve on the
  canonical full-chunk grid, so extension is seamless.
* **cold** — only the residue becomes chunk tasks, scheduled globally
  across all jobs: the long tail of one client's Floyd–Warshall run
  backfills workers another client just freed (work stealing by
  construction — chunks go wherever capacity is).

Fairness and admission control: each job earns credits at the summed
weight of its attached clients (weighted deficit round-robin) and pays
one credit per dispatched chunk; a request whose residue would push the
global queue or its client's outstanding-chunks budget past the caps is
rejected with a ``busy``/retry-after instead of queueing unboundedly.

Failure semantics: a dead worker is respawned and its in-flight chunks'
phase messages are replayed verbatim (resolution is deterministic, so
the retry is bit-identical) under a per-job retry budget — beyond it
the job fails loudly.  A disconnected client's requests detach; chunks
no other client needs are cancelled (never dispatched), chunks already
in flight or shared keep running, and the job's results remain
attachable until the daemon retires it.

The daemon is a *scheduling* layer only: workers run the same resolver,
the same cache-effect monoid composition, and the same PCG64 draw
positioning as the library engines, so results are bit-identical by
construction.
"""

from __future__ import annotations

import multiprocessing
import os
import queue
import threading
import time
import traceback
import itertools
from collections import OrderedDict

from . import faults, protocol
from .journal import Journal
from .worker import worker_main

#: per-process daemon-instance counter for the pidfile token (two
#: daemon objects in one process must still conflict on one socket)
_INSTANCE_IDS = itertools.count(1)

#: Outstanding chunks per worker (matches the chunk-graph executor).
_WINDOW = 2


def _mk_rescache_cfg():
    from ..core import rescache as _rc
    return {
        "enabled": _rc._cfg.enabled,
        "directory": _rc._dir(),
        "memory_mb": _rc._cfg.memory_mb,
        "artifact_mb": _rc._cfg.artifact_mb,
        "disk_mb": _rc._cfg.disk_mb,
    }


class _Request:
    """One client's view of one job: which chunks it still needs and
    the walls the stats endpoint reports."""

    __slots__ = ("conn", "req", "n_chunks", "n_iters", "names",
                 "t_admit", "queue_s", "next_notify", "done", "record",
                 "deadline")

    def __init__(self, conn, req, n_chunks, n_iters, names,
                 deadline_s=None):
        self.conn = conn
        self.req = req
        self.n_chunks = n_chunks
        self.n_iters = n_iters
        #: request model name -> job model name (content keys match)
        self.names = names
        self.t_admit = time.monotonic()
        self.queue_s: float | None = None
        self.next_notify = 0  # set to job.first_live at attach
        self.done = False
        self.record: dict | None = None
        #: absolute monotonic deadline (per-request, layered on WDRR:
        #: admission is unchanged, but an expired request is failed at
        #: the next health tick and its client falls back locally)
        self.deadline = (self.t_admit + deadline_s) \
            if deadline_s else None


class _Job:
    """One in-flight resolution: the chunk-graph master state for one
    content-key set, shared by every attached request."""

    def __init__(self, jid, keyset, payload, keys, mems, seed, n_iters):
        from ..core.simulator import _cache_group_key
        self.jid = jid
        self.keyset = keyset
        self.payload = payload
        self.keys = keys          # job model name -> v3 key
        self.mems = mems
        self.seed = seed
        self.n_iters_hint = n_iters
        self.geos = {mn: _cache_group_key(m) for mn, m in mems.items()}
        self.first_live = 0
        self.sched_upto = 0       # chunks demanded so far
        self.next_k = 0           # dispatch pointer
        self.state_sent = 0
        self.draws_sent = 0
        self.committed = 0        # in-order commit watermark
        self.state_at: dict[int, dict | None] = {}
        self.effects: dict[int, dict] = {}
        self.n_addrs: dict[int, int] = {}
        self.deltas: dict[int, dict] = {}
        self.done_buf: dict[int, tuple] = {}
        self.sent_state: dict[int, dict] = {}
        self.sent_draws: dict[int, dict] = {}
        self.cum_draws: dict[str, int] = {}
        self.geo_cum: dict[tuple, tuple[int, int]] = {}
        self.cums_hist: dict[int, dict] = {}
        self.inline_hist: OrderedDict[int, tuple[int, dict]] = \
            OrderedDict()         # k -> (nbytes, inline)
        self.inline_bytes = 0
        self.inline_dropped: set[int] = set()
        self.requests: list[_Request] = []
        self.retries = 0
        self.completions = 0  # sched_upto high-water at last retire
        self.failed = False
        self.first_dispatch_t: float | None = None
        #: journal-resumed orphan: dispatchable with no client attached
        #: (a restarted daemon finishing what its predecessor promised)
        self.keep_alive = False

    def weight(self, clients) -> float:
        conns = {r.conn for r in self.requests if not r.done}
        return max(0.001, sum(clients[c]["weight"] for c in conns
                              if c in clients))

    def live(self) -> bool:
        return not self.failed and self.next_k < self.sched_upto


class ResolutionDaemon:
    """See the module docstring.  ``throttle_s`` sleeps before each
    chunk dispatch — a test/debug knob that widens the in-flight window
    so racing clients deterministically overlap."""

    def __init__(self, address: str | None = None,
                 workers: int | None = None, *,
                 max_queued_chunks: int = 4096,
                 max_client_chunks: int = 4096,
                 retry_budget: int | None = None,
                 throttle_s: float = 0.0,
                 inline_history_mb: int = 64,
                 journal: bool = True,
                 speculate_after_s: float | None = None,
                 speculate_factor: float = 4.0):
        from ..core import rescache as _rc
        from ..core.chunkgraph import RETRY_BUDGET
        from ..runtime.fault_tolerance import SpeculationPolicy
        if not _rc.enabled(None) or not _rc._dir():
            raise RuntimeError(
                "the resolution daemon requires an enabled rescache "
                "with a disk store (repro_torch.core.rescache.configure)")
        self.address = address or protocol.default_address()
        self.workers = workers if workers is not None \
            else max(2, multiprocessing.cpu_count() - 1)
        self.C = _rc.CHUNK_ITERS
        self.store_dir = os.path.realpath(_rc._dir())
        self.max_queued_chunks = max_queued_chunks
        self.max_client_chunks = max_client_chunks
        self.retry_budget = RETRY_BUDGET if retry_budget is None \
            else retry_budget
        self.throttle_s = throttle_s
        self.inline_cap = inline_history_mb * (1 << 20)
        self._rc = _rc
        self._events: queue.Queue = queue.Queue()
        self._stop_evt = threading.Event()
        self._jobs: dict[int, _Job] = {}
        self._by_keyset: dict[frozenset, int] = {}
        self._clients: dict = {}          # conn -> {weight, reqs}
        self._reqs: dict = {}             # (conn id, req) -> _Request
        self._req_log: list[dict] = []    # last completed requests
        self._jid = 0
        self._t0 = time.monotonic()
        self._pid_token = f"{os.getpid()}.{next(_INSTANCE_IDS)}"
        self._stats = {"accepted": 0, "rejected": 0, "jobs_completed": 0,
                       "jobs_failed": 0, "cancelled_chunks": 0,
                       "worker_restarts": 0, "chunk_retries": 0,
                       "dedup_store": 0, "dedup_inflight": 0,
                       "dedup_cold": 0,
                       "deadline_failures": 0, "resumed_jobs": 0,
                       "speculative_dispatches": 0,
                       "speculative_wins": 0}
        self._threads: list[threading.Thread] = []
        self._journal = Journal(self.store_dir, enabled=journal)
        self._base: dict[str, int] = {}   # journaled pre-restart totals
        self._restarts = 0
        if speculate_after_s is None:
            try:
                speculate_after_s = float(
                    os.environ.get("REPRO_SPECULATE_AFTER_S", "30"))
            except ValueError:
                speculate_after_s = 30.0
        self._spec_policy = None if speculate_after_s <= 0 else \
            SpeculationPolicy(min_wait_s=speculate_after_s,
                              latency_factor=speculate_factor,
                              max_inflight=max(1, self.workers // 2))

    # -- lifecycle -----------------------------------------------------------

    def _pidfile(self) -> str | None:
        return None if protocol.is_inet(self.address) \
            else self.address + ".pid"

    def _guard_pidfile(self) -> None:
        """Refuse to start over a *live* daemon on the same socket —
        binding an AF_UNIX path unlinks whatever is there, so without
        this check the loser of a spawn race would silently steal the
        winner's socket.  The pidfile holds a per-instance token (two
        daemon objects in one process must conflict too); a stale
        entry (dead pid) is overwritten."""
        pf = self._pidfile()
        if pf is None:
            return
        try:
            with open(pf) as f:
                token = f.read().strip()
            pid = int(token.split(".", 1)[0] or 0)
            if token and token != self._pid_token:
                os.kill(pid, 0)  # raises if the process is gone
                raise RuntimeError(
                    f"daemon pid {pid} already serves {self.address} "
                    f"(pidfile {pf})")
        except (OSError, ValueError):
            pass  # no pidfile / unreadable / dead pid: ours to take
        try:
            with open(pf, "w") as f:
                f.write(self._pid_token)
        except OSError:
            pass

    def start(self) -> None:
        self._guard_pidfile()
        ctx = multiprocessing.get_context("spawn")
        self._ctx = ctx
        self._result_q = ctx.Queue()
        cfg = _mk_rescache_cfg()
        self._cfg = cfg
        # spawned workers start with the port's defaults: hand them the
        # daemon's device policy and engine
        from .. import _device
        from ..core import engine as _engine
        self._setup = (_device.policy(), _engine.current())
        self._task_qs = [ctx.Queue() for _ in range(self.workers)]
        self._procs = [ctx.Process(
            target=worker_main,
            args=(w, self.C, self._task_qs[w], self._result_q, cfg,
                  *self._setup),
            daemon=True) for w in range(self.workers)]
        for p in self._procs:
            p.start()
        self._known = [set() for _ in range(self.workers)]
        self._load = [0] * self.workers
        self._busy_s = [0.0] * self.workers
        self._inflight: dict[tuple[int, int], int] = {}
        #: chunk -> speculative (second) owner; first commit wins
        self._spec: dict[tuple[int, int], int] = {}
        self._dispatch_t: dict[tuple[int, int], float] = {}
        self._recover_journal()
        self._sock = protocol.listen(self.address)
        self._threads = [
            threading.Thread(target=self._listen_loop, daemon=True),
            threading.Thread(target=self._run, daemon=True)]
        for t in self._threads:
            t.start()

    def _recover_journal(self) -> None:
        """Load the previous lifetime's state: counter totals, the
        request log, and — the durability contract — every job that was
        admitted but never completed, re-created from its journaled
        payload with its demand restored.  The store prefix says which
        chunks survived the crash; the remainder resolves with no
        client attached, so a client that failed over mid-stream finds
        the full artifact on its next run."""
        import pickle
        rep = self._journal.replay()
        self._base = rep["base_stats"]
        self._restarts = rep["starts"]
        self._req_log = list(rep["req_log"])
        self._jid = rep["max_jid"]
        self._journal.compact()
        self._journal.append({"ev": "start", "pid": os.getpid()},
                             sync=True)
        for jid, ev in sorted(rep["open_jobs"].items()):
            payload = self._journal.load_payload(jid)
            if payload is None:
                continue
            try:
                d = pickle.loads(payload)
            except Exception:  # noqa: BLE001 — torn payload blob
                self._journal.drop_payload(jid)
                continue
            msg = {"payload": payload, "mems": d["mems"],
                   "seed": ev.get("seed", d.get("seed", 0)),
                   "n_iters": ev.get("n_iters", d.get("n_iters", 0))}
            j = self._new_job(msg, dict(ev["keys"]))
            # the resumed job gets a fresh jid; close the old journal
            # entry either way and re-open under the new one if work
            # remains (committed < demanded)
            self._journal.append({"ev": "job_done", "jid": jid})
            self._journal.drop_payload(jid)
            if j is None:
                continue
            n_chunks = int(ev.get("n_chunks", 0))
            if j.committed >= n_chunks:
                continue  # store prefix already covers the demand
            j.sched_upto = n_chunks
            j.keep_alive = True
            self._stats["resumed_jobs"] += 1
            self._journal_job(j)

    def _journal_job(self, j: _Job) -> None:
        self._journal.save_payload(j.jid, j.payload)
        self._journal.append(
            {"ev": "job", "jid": j.jid, "keys": dict(j.keys),
             "seed": j.seed, "n_iters": j.n_iters_hint,
             "n_chunks": j.sched_upto}, sync=True)

    def _journal_stats(self) -> None:
        merged = {k: v + self._base.get(k, 0)
                  for k, v in self._stats.items()}
        self._journal.append({"ev": "stats", "stats": merged})

    def serve_forever(self) -> None:
        self.start()
        try:
            while not self._stop_evt.wait(0.5):
                pass
        except KeyboardInterrupt:
            pass
        self.stop()

    def stop(self) -> None:
        self._stop_evt.set()
        self._journal_stats()
        pf = self._pidfile()
        if pf is not None:
            try:
                os.unlink(pf)
            except OSError:
                pass
        try:
            self._sock.close()
        except OSError:
            pass
        if not protocol.is_inet(self.address):
            try:
                os.unlink(self.address)
            except OSError:
                pass
        for q in getattr(self, "_task_qs", []):
            try:
                q.put(("stop",))
            except Exception:
                pass
        for p in getattr(self, "_procs", []):
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
        for q in getattr(self, "_task_qs", []):
            # a worker that died without draining leaves the feeder
            # blocked; don't let its exit finalizer hang the process
            q.cancel_join_thread()
            q.close()

    # -- socket side ---------------------------------------------------------

    def _listen_loop(self) -> None:
        while not self._stop_evt.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._read_loop, args=(conn,),
                             daemon=True).start()

    def _read_loop(self, conn) -> None:
        self._events.put(("hello", conn))
        try:
            while True:
                msg = protocol.recv_msg(conn)
                self._events.put(("msg", conn, msg))
                if msg.get("type") == "shutdown":
                    return
        except (protocol.ProtocolError, OSError, EOFError):
            self._events.put(("bye", conn))

    def _send(self, conn, obj) -> None:
        """All sends happen on the scheduler thread (single writer); a
        failed send is a disconnect."""
        try:
            protocol.send_msg(conn, obj)
        except (OSError, ValueError):
            self._drop_client(conn)

    # -- scheduler thread ----------------------------------------------------

    def _run(self) -> None:
        last_health = time.monotonic()
        while not self._stop_evt.is_set():
            busy = any(j.live() for j in self._jobs.values()) \
                or self._inflight
            try:
                msg = self._result_q.get(timeout=0.05 if busy else 0.25)
            except queue.Empty:
                msg = None
            if msg is not None:
                self._on_worker_msg(msg)
            while True:
                try:
                    self._on_worker_msg(self._result_q.get_nowait())
                except queue.Empty:
                    break
            while True:
                try:
                    ev = self._events.get_nowait()
                except queue.Empty:
                    break
                self._on_event(ev)
            self._dispatch()
            now = time.monotonic()
            if now - last_health > 1.0:
                last_health = now
                self._check_workers()
                self._check_deadlines(now)
                self._check_stragglers(now)

    # -- client events -------------------------------------------------------

    def _on_event(self, ev) -> None:
        kind = ev[0]
        if kind == "hello":
            self._clients[ev[1]] = {"weight": 1.0, "reqs": set()}
            return
        if kind == "bye":
            self._drop_client(ev[1])
            return
        conn, msg = ev[1], ev[2]
        t = msg.get("type")
        if t == "ping":
            self._send(conn, {"type": "pong"})
        elif t == "stats":
            self._send(conn, {"type": "stats", "stats": self.stats()})
        elif t == "shutdown":
            self._send(conn, {"type": "ok"})
            self._stop_evt.set()
        elif t == "resolve":
            try:
                self._admit(conn, msg)
            except Exception:  # noqa: BLE001 — bad request, not a crash
                self._send(conn, {"type": "error",
                                  "req": msg.get("req"),
                                  "reason": traceback.format_exc()})
        elif t == "solved":
            rec = self._reqs.get((id(conn), msg.get("req")))
            if rec is not None and rec.record is not None:
                rec.record["solve_s"] = float(msg.get("solve_wall_s", 0))
        elif t == "cancel":
            r = self._reqs.get((id(conn), msg.get("req")))
            if r is not None and not r.done:
                self._detach(r)

    def _drop_client(self, conn) -> None:
        cl = self._clients.pop(conn, None)
        if cl is None:
            return
        for rid in list(cl["reqs"]):
            r = self._reqs.get(rid)
            if r is not None and not r.done:
                self._detach(r)
        try:
            conn.close()
        except OSError:
            pass

    def _detach(self, r: _Request) -> None:
        """Remove a request from its job; cancel chunks nobody else
        needs (never-dispatched ones only — in-flight chunks finish and
        commit, keeping the job attachable)."""
        r.done = True
        j = next((j for j in self._jobs.values()
                  if r in j.requests), None)
        if j is None:
            return
        j.requests.remove(r)
        self._cancel_unneeded(j)

    def _cancel_unneeded(self, j: _Job) -> None:
        """Cancel never-dispatched chunks no live request needs — except
        on journal-resumed orphans, whose whole point is finishing with
        nobody attached."""
        if j.keep_alive:
            return
        if not any(not q.done for q in j.requests):
            cancelled = max(0, j.sched_upto - j.next_k)
            if cancelled:
                self._stats["cancelled_chunks"] += cancelled
                j.sched_upto = j.next_k
            self._maybe_retire(j)

    # -- admission -----------------------------------------------------------

    def _admit(self, conn, msg) -> None:
        req_id = msg["req"]
        if os.path.realpath(msg["store_dir"]) != self.store_dir:
            self._send(conn, {
                "type": "error", "req": req_id,
                "reason": f"daemon serves store {self.store_dir}, "
                          f"client uses {msg['store_dir']}"})
            return
        if int(msg["chunk_iters"]) != self.C:
            self._send(conn, {
                "type": "error", "req": req_id,
                "reason": f"daemon chunk_iters={self.C}, "
                          f"client={msg['chunk_iters']}"})
            return
        keys = dict(msg["keys"])      # request model name -> v3 key
        n_iters = int(msg["n_iters"])
        n_chunks = -(-n_iters // self.C)
        cl = self._clients[conn]
        cl["weight"] = min(100.0, max(0.1,
                                      float(msg.get("weight", 1.0))))
        j = self._find_job(keys)
        if j is None:
            j = self._new_job(msg, keys)
            if j is None:  # store raced away mid-probe: client retries
                self._send(conn, {"type": "error", "req": req_id,
                                  "reason": "resume record vanished"})
                return
        names = {rmn: self._by_key(j, k) for rmn, k in keys.items()}
        # dedup accounting relative to this job's current frontier
        store = min(n_chunks, j.first_live)
        inflight = max(0, min(n_chunks, j.sched_upto) - j.first_live)
        cold = max(0, n_chunks - max(j.first_live, j.sched_upto))
        # backpressure: reject rather than queue unboundedly
        queued = sum(max(0, q.sched_upto - q.next_k)
                     for q in self._jobs.values() if not q.failed)
        outstanding = sum(q.n_chunks - q.next_notify
                          for rid in cl["reqs"]
                          if (q := self._reqs.get(rid)) is not None
                          and not q.done)
        want = max(0, n_chunks - j.first_live)
        if (cold and queued + cold > self.max_queued_chunks) or \
                outstanding + want > self.max_client_chunks:
            self._stats["rejected"] += 1
            retry = min(30.0, 0.1 + 0.05 * (queued + cold)
                        / max(1, self.workers))
            self._send(conn, {"type": "busy", "req": req_id,
                              "retry_after_s": round(retry, 2)})
            return
        self._stats["accepted"] += 1
        self._stats["dedup_store"] += store
        self._stats["dedup_inflight"] += inflight
        self._stats["dedup_cold"] += cold
        demand_grew = n_chunks > j.sched_upto
        j.sched_upto = max(j.sched_upto, n_chunks)
        if demand_grew and j.sched_upto > j.first_live:
            # durability point: once accepted, a crash must not lose
            # the promise — the restarted daemon re-attaches this job
            # from the journal + store prefix and finishes it
            self._journal_job(j)
        dl = msg.get("deadline_s")
        r = _Request(conn, req_id, n_chunks, n_iters, names,
                     deadline_s=float(dl) if dl else None)
        r.next_notify = j.first_live
        r.record = {"req": str(req_id), "models": sorted(keys),
                    "chunks": n_chunks, "queue_s": None,
                    "resolve_s": None, "solve_s": None,
                    "dedup": {"store": store, "inflight": inflight,
                              "cold": cold}}
        j.requests.append(r)
        rid = (id(conn), req_id)
        self._reqs[rid] = r
        cl["reqs"].add(rid)
        if j.first_dispatch_t is not None:
            r.queue_s = 0.0
        self._send(conn, {
            "type": "accepted", "req": req_id,
            "first_live": j.first_live, "committed": j.committed,
            "dedup": {"store": store, "inflight": inflight,
                      "cold": cold}})
        # late attach: replay already-committed chunks from history
        while not r.done and r.next_notify < min(j.committed,
                                                 r.n_chunks):
            if not self._notify(j, r, r.next_notify):
                return
        self._finish_if_served(j, r)

    def _by_key(self, j: _Job, key: str) -> str:
        for jmn, k in j.keys.items():
            if k == key:
                return jmn
        raise KeyError(key)

    def _find_job(self, keys) -> _Job | None:
        ks = frozenset(keys.values())
        jid = self._by_keyset.get(ks)
        if jid is not None and not self._jobs[jid].failed:
            return self._jobs[jid]
        for j in self._jobs.values():  # subset attach
            if not j.failed and ks <= j.keyset:
                return j
        return None

    def _new_job(self, msg, keys) -> _Job | None:
        _rc = self._rc
        self._jid += 1
        j = _Job(self._jid, frozenset(keys.values()), msg["payload"],
                 keys, dict(msg["mems"]), int(msg["seed"]),
                 int(msg["n_iters"]))
        full = [(_rc.prefix(k, self.C))[0] for k in keys.values()]
        j.first_live = min(full) if full else 0
        if j.first_live > 0:
            recs = {mn: _rc.get_chunk(k, j.first_live - 1, refresh=True)
                    for mn, k in j.keys.items()}
            if any(rec is None for rec in recs.values()):
                j.first_live = 0
        if j.first_live > 0:
            state = {}
            for mn, rec in recs.items():
                j.cum_draws[mn] = int(rec.cum.get("draws", 0))
                geo = j.geos[mn]
                if geo is not None:
                    state[geo] = (rec.states["cache"],
                                  int(rec.cum.get("max_tag", -1)))
                    j.geo_cum[geo] = (int(rec.cum.get("hits", 0)),
                                      int(rec.cum.get("misses", 0)))
            j.state_at[j.first_live] = state
        else:
            j.state_at[0] = None
            j.cum_draws = {mn: 0 for mn in j.keys}
            j.geo_cum = {g: (0, 0) for g in j.geos.values()
                         if g is not None}
        j.next_k = j.state_sent = j.draws_sent = j.first_live
        j.committed = j.first_live
        self._jobs[j.jid] = j
        self._by_keyset[j.keyset] = j.jid
        return j

    # -- dispatch ------------------------------------------------------------

    def _dispatch(self) -> None:
        ready = [j for j in self._jobs.values()
                 if j.live() and (j.keep_alive
                                  or any(not r.done for r in j.requests))]
        if not ready:
            return
        while True:
            w = min(range(self.workers), key=lambda i: self._load[i])
            if self._load[w] >= _WINDOW:
                return
            ready = [j for j in ready if j.live()]
            if not ready:
                return
            # weighted deficit round-robin: refill credits at client
            # weight, pay one per chunk
            if all(getattr(j, "credit", 0.0) < 1.0 for j in ready):
                for j in ready:
                    j.credit = getattr(j, "credit", 0.0) \
                        + j.weight(self._clients)
            j = max(ready, key=lambda q: getattr(q, "credit", 0.0))
            j.credit = getattr(j, "credit", 0.0) - 1.0
            if self.throttle_s:
                time.sleep(self.throttle_s)
            k = j.next_k
            if j.jid not in self._known[w]:
                self._task_qs[w].put(("job", j.jid, j.payload))
                self._known[w].add(j.jid)
            # full canonical chunks always: traces pad past their end,
            # so records never need a partial tail (see worker module)
            self._task_qs[w].put(("task", j.jid, k, k * self.C,
                                  (k + 1) * self.C))
            self._inflight[(j.jid, k)] = w
            self._dispatch_t[(j.jid, k)] = time.monotonic()
            self._load[w] += 1
            j.next_k += 1
            now = time.monotonic()
            if j.first_dispatch_t is None:
                j.first_dispatch_t = now
            for r in j.requests:
                if r.queue_s is None:
                    r.queue_s = now - r.t_admit
            self._pump(j)

    def _pump(self, j: _Job) -> None:
        """Send composed states and draw offsets for chunks whose
        predecessors have reported — the serial scans of the chunk
        graph, identical to the chunk-graph master."""
        while j.state_sent < j.next_k and j.state_sent in j.state_at:
            k = j.state_sent
            w = self._inflight.get((j.jid, k))
            if w is None:
                break
            j.sent_state[k] = j.state_at[k] or {}
            self._task_qs[w].put(("state", j.jid, k, k * self.C,
                                  (k + 1) * self.C, j.sent_state[k]))
            j.state_sent += 1
        while j.draws_sent < j.next_k and j.draws_sent in j.deltas:
            k = j.draws_sent
            w = self._inflight.get((j.jid, k))
            if w is None:
                break
            msg = {}
            for mn, mem in j.mems.items():
                geo = j.geos[mn]
                entry = {"base": j.cum_draws[mn]}
                if mem.backing_hit_rate > 0.0:
                    j.cum_draws[mn] += j.deltas[k][geo][2] \
                        if geo is not None else j.n_addrs[k]
                if geo is not None:
                    h, m = j.geo_cum[geo]
                    entry["hits_after"] = h + j.deltas[k][geo][0]
                    entry["misses_after"] = m + j.deltas[k][geo][1]
                msg[mn] = entry
            for geo, d in j.deltas[k].items():
                h, m = j.geo_cum[geo]
                j.geo_cum[geo] = (h + d[0], m + d[1])
            j.sent_draws[k] = msg
            self._task_qs[w].put(("draws", j.jid, k, msg))
            del j.deltas[k]
            j.n_addrs.pop(k, None)
            j.effects.pop(k, None)
            j.draws_sent += 1
        for i in [i for i in j.state_at
                  if i < j.state_sent and i + 1 in j.state_at]:
            del j.state_at[i]

    # -- worker replies ------------------------------------------------------

    def _on_worker_msg(self, msg) -> None:
        kind = msg[0]
        if kind == "error":
            _, wid, jid, k, tb = msg
            self._busy_s[wid] += 0.0
            j = self._jobs.get(jid)
            if j is not None and not j.failed:
                self._fail_job(j, f"worker {wid} raised:\n{tb}")
            return
        _, wid, jid, k, *rest = msg
        self._busy_s[wid] += rest[-1]
        j = self._jobs.get(jid)
        if j is None or j.failed:
            if kind == "done":
                if wid == self._inflight.get((jid, k)):
                    self._inflight.pop((jid, k))
                    self._load[wid] = max(0, self._load[wid] - 1)
                elif wid == self._spec.get((jid, k)):
                    self._spec.pop((jid, k))
                    self._load[wid] = max(0, self._load[wid] - 1)
            return
        if kind == "effect":
            eff, na = rest[0], rest[1]
            if k + 1 in j.state_at or k < j.draws_sent:
                return  # duplicate from a retried chunk
            from ..core.chunkgraph import _compose_state
            j.effects[k] = eff
            j.n_addrs[k] = na
            while (k + 1 not in j.state_at) and k in j.state_at \
                    and k in j.effects:
                j.state_at[k + 1] = _compose_state(j.state_at[k],
                                                   j.effects.pop(k))
                k += 1
            self._pump(j)
        elif kind == "replay":
            if k >= j.draws_sent:
                j.deltas[k] = rest[0]
            self._pump(j)
        elif kind == "done":
            key = (j.jid, k)
            from_spec = False
            if wid == self._inflight.get(key):
                self._inflight.pop(key)
                self._load[wid] = max(0, self._load[wid] - 1)
                t0 = self._dispatch_t.pop(key, None)
                if self._spec_policy is not None and t0 is not None:
                    self._spec_policy.observe(time.monotonic() - t0)
            elif wid == self._spec.get(key):
                from_spec = True
                self._spec.pop(key)
                self._load[wid] = max(0, self._load[wid] - 1)
            if k >= j.committed and k not in j.done_buf:
                if from_spec and self._spec_policy is not None:
                    # the duplicate beat the straggler to the commit
                    self._spec_policy.wins += 1
                    self._stats["speculative_wins"] += 1
                j.done_buf[k] = (rest[0], rest[1])
                j.sent_state.pop(k, None)
                j.sent_draws.pop(k, None)
                self._commit(j)

    def _commit(self, j: _Job) -> None:
        while j.committed in j.done_buf:
            k = j.committed
            cums, inline = j.done_buf.pop(k)
            j.cums_hist[k] = cums
            if any(v is not None for v in inline.values()):
                nb = sum(v["ops"].nbytes
                         + (v["hits"].nbytes if v["hits"] is not None
                            else 0)
                         + (v["visits"].nbytes
                            if v["visits"] is not None else 0)
                         for v in inline.values() if v is not None)
                j.inline_hist[k] = (nb, inline)
                j.inline_bytes += nb
                while j.inline_bytes > self.inline_cap \
                        and len(j.inline_hist) > 1:
                    old, (ob, _) = j.inline_hist.popitem(last=False)
                    j.inline_bytes -= ob
                    j.inline_dropped.add(old)
            j.committed += 1
            self._rc.note_chunks(cold=1)
            for r in list(j.requests):
                if not r.done and r.next_notify == k \
                        and k < r.n_chunks:
                    if self._notify(j, r, k):
                        self._finish_if_served(j, r)
            if faults.active():
                # chaos: die mid-stream *after* committing chunk N —
                # the record is on disk, the journal holds the job, and
                # clients must fail over to the committed prefix
                faults.maybe_kill("daemon_kill", chunk=j.committed)
        self._maybe_retire(j)

    def _notify(self, j: _Job, r: _Request, k: int) -> bool:
        """Stream one committed chunk to one request (translated to the
        request's model names).  Returns False when the request had to
        be failed (evicted inline history)."""
        cums = j.cums_hist[k]
        if k in j.inline_dropped:
            self._fail_request(
                j, r, f"inline history for chunk {k} evicted "
                      f"(raise inline_history_mb)")
            return False
        entry = j.inline_hist.get(k)
        inline = entry[1] if entry is not None else {}
        self._send(r.conn, {
            "type": "chunk", "req": r.req, "idx": k,
            "cums": {rmn: cums[jmn] for rmn, jmn in r.names.items()},
            "inline": {rmn: inline.get(jmn)
                       for rmn, jmn in r.names.items()}})
        r.next_notify = k + 1
        return True

    def _finish_if_served(self, j: _Job, r: _Request) -> None:
        if r.done or r.next_notify < r.n_chunks:
            return
        r.done = True
        now = time.monotonic()
        r.record["queue_s"] = round(r.queue_s or 0.0, 4)
        r.record["resolve_s"] = round(now - r.t_admit, 4)
        self._req_log.append(r.record)
        del self._req_log[:-64]
        self._journal.append({"ev": "req", "record": dict(r.record)})
        self._send(r.conn, {"type": "done", "req": r.req})
        self._maybe_retire(j)

    def _maybe_retire(self, j: _Job) -> None:
        """A job with nothing left to dispatch or commit releases its
        worker-side resolvers; the daemon keeps its history so later
        identical requests still attach (and can extend it)."""
        if j.failed or j.next_k < j.sched_upto:
            return
        # completion is a property of the committed range alone — a
        # speculative loser still straggling in-flight must not delay
        # the job_done journal entry or the completion counter
        if j.committed >= j.sched_upto and \
                j.sched_upto > max(j.first_live, j.completions):
            j.completions = j.sched_upto
            j.keep_alive = False
            self._stats["jobs_completed"] += 1
            self._journal.append({"ev": "job_done", "jid": j.jid})
            self._journal.drop_payload(j.jid)
            self._journal_stats()
        if any(key[0] == j.jid for key in self._inflight) or \
                any(key[0] == j.jid for key in self._spec):
            return
        for w, known in enumerate(self._known):
            if j.jid in known:
                self._task_qs[w].put(("forget", j.jid))
                known.discard(j.jid)

    def _fail_request(self, j: _Job, r: _Request, reason: str) -> None:
        r.done = True
        self._send(r.conn, {"type": "failed", "req": r.req,
                            "reason": reason})
        if r in j.requests:
            j.requests.remove(r)

    def _fail_job(self, j: _Job, reason: str) -> None:
        j.failed = True
        j.keep_alive = False
        self._stats["jobs_failed"] += 1
        self._journal.append({"ev": "job_failed", "jid": j.jid})
        self._journal.drop_payload(j.jid)
        for r in list(j.requests):
            if not r.done:
                self._fail_request(j, r, reason)
        for key in [key for key in self._inflight if key[0] == j.jid]:
            w = self._inflight.pop(key)
            self._dispatch_t.pop(key, None)
            self._load[w] = max(0, self._load[w] - 1)
        for key in [key for key in self._spec if key[0] == j.jid]:
            w = self._spec.pop(key)
            self._load[w] = max(0, self._load[w] - 1)
        for w, known in enumerate(self._known):
            if j.jid in known:
                try:
                    self._task_qs[w].put(("forget", j.jid))
                except Exception:
                    pass
                known.discard(j.jid)
        self._by_keyset.pop(j.keyset, None)

    # -- worker health -------------------------------------------------------

    def _check_workers(self) -> None:
        dead = [w for w, p in enumerate(self._procs)
                if not p.is_alive()]
        if not dead or self._stop_evt.is_set():
            return
        self._stats["worker_restarts"] += len(dead)
        # a dead speculative copy just disappears (the primary is still
        # on it); a dead *primary* with a live speculative copy promotes
        # the copy instead of re-dispatching
        for key in [key for key, w in self._spec.items() if w in dead]:
            del self._spec[key]
        redo = []
        for key, w in sorted(self._inflight.items()):
            if w not in dead:
                continue
            sw = self._spec.pop(key, None)
            if sw is not None:
                self._inflight[key] = sw
                self._dispatch_t[key] = time.monotonic()
            else:
                redo.append(key + (w,))
        self._rc.note_worker_retries(len(redo))
        self._stats["chunk_retries"] += len(redo)
        for w in dead:
            # the old queue's feeder thread may be wedged on a pipe
            # whose reader died mid-write; never join it at exit
            old = self._task_qs[w]
            old.cancel_join_thread()
            old.close()
            self._task_qs[w] = self._ctx.Queue()
            self._procs[w] = self._ctx.Process(
                target=worker_main,
                args=(w, self.C, self._task_qs[w], self._result_q,
                      self._cfg, *self._setup),
                daemon=True)
            self._procs[w].start()
            self._known[w] = set()
            self._load[w] = 0
        over_budget = set()
        for jid, k, w in redo:
            j = self._jobs.get(jid)
            if j is None or j.failed or jid in over_budget:
                self._inflight.pop((jid, k), None)
                self._dispatch_t.pop((jid, k), None)
                continue
            if k < j.committed:
                # a speculative copy already committed this chunk; the
                # straggler died afterwards — nothing to redo
                self._inflight.pop((jid, k), None)
                self._dispatch_t.pop((jid, k), None)
                continue
            j.retries += 1
            if j.retries > self.retry_budget:
                over_budget.add(jid)
                self._fail_job(
                    j, f"worker(s) {dead} died; retry budget "
                       f"exhausted ({j.retries} > {self.retry_budget})")
                continue
            if jid not in self._known[w]:
                self._task_qs[w].put(("job", jid, j.payload))
                self._known[w].add(jid)
            self._task_qs[w].put(("task", jid, k, k * self.C,
                                  (k + 1) * self.C))
            if k < j.state_sent:
                self._task_qs[w].put(("state", jid, k, k * self.C,
                                      (k + 1) * self.C,
                                      j.sent_state[k]))
            if k < j.draws_sent:
                self._task_qs[w].put(("draws", jid, k,
                                      j.sent_draws[k]))
            self._dispatch_t[(jid, k)] = time.monotonic()
            self._load[w] += 1

    def _check_deadlines(self, now: float) -> None:
        """Fail requests past their deadline (1 Hz).  The request's
        chunks keep resolving if anyone else — or the journal's
        keep-alive — still wants them; otherwise the undispatched tail
        is cancelled, exactly like a client disconnect."""
        for j in list(self._jobs.values()):
            expired = [r for r in j.requests
                       if not r.done and r.deadline is not None
                       and now > r.deadline]
            for r in expired:
                self._stats["deadline_failures"] += 1
                self._fail_request(
                    j, r, f"deadline exceeded "
                          f"({now - r.t_admit:.1f}s elapsed)")
            if expired:
                self._cancel_unneeded(j)

    def _check_stragglers(self, now: float) -> None:
        """Speculative re-dispatch (1 Hz): a chunk whose wall exceeds
        the policy threshold gets a duplicate dispatch on another
        worker — task, state, and draws replayed verbatim, which is
        only possible once all three were sent (a phase-C straggler:
        the heavy phase).  Both copies compute identical bits; the
        first ``done`` commits, the loser's is discarded by the
        ordinary duplicate guards."""
        pol = self._spec_policy
        if pol is None:
            return
        for key, w in list(self._inflight.items()):
            if key in self._spec:
                continue
            jid, k = key
            j = self._jobs.get(jid)
            if j is None or j.failed:
                continue
            if k not in j.sent_state or k not in j.sent_draws:
                continue  # not yet in phase C: nothing to replay
            t0 = self._dispatch_t.get(key)
            if t0 is None or not pol.overdue(now - t0):
                continue
            if len(self._spec) >= pol.max_inflight:
                break
            cands = [i for i in range(self.workers)
                     if i != w and self._load[i] < _WINDOW
                     and self._procs[i].is_alive()]
            if not cands:
                break
            w2 = min(cands, key=lambda i: self._load[i])
            if jid not in self._known[w2]:
                self._task_qs[w2].put(("job", jid, j.payload))
                self._known[w2].add(jid)
            self._task_qs[w2].put(("task", jid, k, k * self.C,
                                   (k + 1) * self.C))
            self._task_qs[w2].put(("state", jid, k, k * self.C,
                                   (k + 1) * self.C, j.sent_state[k]))
            self._task_qs[w2].put(("draws", jid, k, j.sent_draws[k]))
            self._spec[key] = w2
            self._load[w2] += 1
            pol.issued += 1
            self._stats["speculative_dispatches"] += 1

    # -- observability -------------------------------------------------------

    def stats(self) -> dict:
        up = max(1e-9, time.monotonic() - self._t0)
        # counters are reported as journal base + current lifetime, so
        # `serve stats` is monotone across daemon restarts
        s = {k: v + self._base.get(k, 0)
             for k, v in self._stats.items()}
        total = s["dedup_store"] + s["dedup_inflight"] + s["dedup_cold"]
        return {
            "address": self.address,
            "uptime_s": round(up, 3),
            "workers": self.workers,
            "chunk_iters": self.C,
            "clients": len(self._clients),
            "jobs_active": sum(1 for j in self._jobs.values()
                               if j.live()),
            "queued_chunks": sum(max(0, j.sched_upto - j.next_k)
                                 for j in self._jobs.values()
                                 if not j.failed),
            "inflight_chunks": len(self._inflight),
            "utilization": [round(b / up, 4) for b in self._busy_s],
            "dedup": {
                "store_chunks": s["dedup_store"],
                "inflight_chunks": s["dedup_inflight"],
                "cold_chunks": s["dedup_cold"],
                "hit_rate": round(
                    (s["dedup_store"] + s["dedup_inflight"])
                    / total, 4) if total else 0.0},
            "admission": {
                "accepted": s["accepted"], "rejected": s["rejected"],
                "max_queued_chunks": self.max_queued_chunks,
                "max_client_chunks": self.max_client_chunks},
            "failures": {
                "worker_restarts": s["worker_restarts"],
                "chunk_retries": s["chunk_retries"],
                "jobs_failed": s["jobs_failed"],
                "cancelled_chunks": s["cancelled_chunks"],
                "deadline_failures": s["deadline_failures"]},
            "speculation": (dict(self._spec_policy.snapshot(),
                                 issued=s["speculative_dispatches"],
                                 wins=s["speculative_wins"])
                            if self._spec_policy is not None else None),
            "journal": {
                "enabled": self._journal.enabled,
                "restarts": self._restarts,
                "resumed_jobs": s["resumed_jobs"]},
            "faults_injected": faults.stats(),
            "jobs_completed": s["jobs_completed"],
            "requests": list(self._req_log),
            "census": self._rc.census(),
        }
