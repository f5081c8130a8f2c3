"""Thin client of the resolution daemon.

:func:`simulate_dataflow_served` is the serve-mode twin of the library
engines: it probes the store, ships the *live* residue of a
``simulate_dataflow_many`` grid to the daemon as one resolution
request, and folds + solves the streamed per-chunk completion records
incrementally — the client does exactly the cheap work (fold, wavefront
solve) while resolution happens in the daemon's shared pool.  Cycle
counts, stall buckets, and cache statistics are bit-identical to
library mode: same records, same fold, same solver.

Everything that prevents serving raises :exc:`ServeUnavailable`
(daemon not running, store mismatch, unpicklable traces, a raced store
eviction mid-stream, …); callers catch it and fall back to the local
engines.  Because the daemon commits ordinary v3 records as it goes,
the fallback rerun is mostly store-served — failure costs latency, not
resolution work.

:func:`ensure_daemon` implements ``--server auto``: connect to the
store's canonical socket or spawn a detached daemon
(``python -m repro_torch.launch.serve daemon``) and wait for it to answer
pings.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import subprocess
import sys
import time

import numpy as np

from . import faults, protocol


class ServeUnavailable(RuntimeError):
    """Serving is not possible / failed mid-run — run locally instead."""


_REQ_COUNTER = itertools.count()


def _env_f(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


@dataclasses.dataclass(frozen=True)
class ServeTimeouts:
    """Client-side timeout/backoff knobs.

    Resolution order: explicit argument > :func:`configure_timeouts` >
    ``REPRO_SERVE_*`` environment > defaults.  ``CompileOptions.serve``
    feeds the same knobs from the compile-options side (the driver
    converts a :class:`repro_torch.dataflow.options.ServeOptions` into one of
    these).  ``max_wait_s`` is a **cumulative** budget across connect
    retries *and* busy-backpressure retries of one request — not
    per-attempt — so a client's worst-case patience is bounded.
    ``deadline_s`` (optional) rides the resolve request to the daemon,
    which fails the request server-side once exceeded (the client then
    falls back to library mode)."""

    connect_timeout_s: float = 10.0
    request_timeout_s: float = 600.0
    max_wait_s: float = 60.0
    backoff_base_s: float = 0.05
    backoff_cap_s: float = 2.0
    deadline_s: float | None = None

    @classmethod
    def from_env(cls) -> "ServeTimeouts":
        dl = _env_f("REPRO_SERVE_DEADLINE_S", 0.0)
        return cls(
            connect_timeout_s=_env_f("REPRO_SERVE_CONNECT_TIMEOUT_S",
                                     cls.connect_timeout_s),
            request_timeout_s=_env_f("REPRO_SERVE_TIMEOUT_S",
                                     cls.request_timeout_s),
            max_wait_s=_env_f("REPRO_SERVE_MAX_WAIT_S", cls.max_wait_s),
            backoff_base_s=_env_f("REPRO_SERVE_BACKOFF_BASE_S",
                                  cls.backoff_base_s),
            backoff_cap_s=_env_f("REPRO_SERVE_BACKOFF_CAP_S",
                                 cls.backoff_cap_s),
            deadline_s=dl if dl > 0 else None)


_timeouts: ServeTimeouts | None = None


def configure_timeouts(timeouts: ServeTimeouts | None = None,
                       **kw) -> ServeTimeouts:
    """Install process-wide client timeouts (the driver calls this when
    ``CompileOptions.serve`` is set; ``None`` + no kwargs resets to the
    environment).  Returns the effective config."""
    global _timeouts
    if timeouts is None and kw:
        timeouts = dataclasses.replace(ServeTimeouts.from_env(), **kw)
    _timeouts = timeouts
    return _timeouts or ServeTimeouts.from_env()


def _cfg(timeouts: ServeTimeouts | None) -> ServeTimeouts:
    return timeouts or _timeouts or ServeTimeouts.from_env()


def _backoff(cfg: ServeTimeouts, attempt: int) -> float:
    """Exponential backoff with deterministic jitter (keyed on pid and
    attempt — two racing clients desynchronize, one client replays)."""
    base = min(cfg.backoff_cap_s, cfg.backoff_base_s * (2 ** attempt))
    j = ((os.getpid() * 2654435761 + attempt * 40503) % 1000) / 1000.0
    return base * (0.5 + 0.5 * j)


def _connect(addr: str, cfg: ServeTimeouts, deadline: float):
    """Connect with backoff + jitter under the cumulative deadline.
    Transient refusals (daemon restarting, listen backlog burst) are
    retried; a hard failure at the deadline raises the last error."""
    attempt = 0
    while True:
        try:
            conn = protocol.connect(addr, timeout=cfg.connect_timeout_s)
            conn.settimeout(cfg.request_timeout_s)
            return conn
        except OSError as e:
            delay = _backoff(cfg, attempt)
            attempt += 1
            if time.monotonic() + delay >= deadline:
                raise ServeUnavailable(
                    f"no daemon at {addr} after {attempt} attempts: "
                    f"{e}") from e
            time.sleep(delay)


def _request(conn, msg, *, cfg: ServeTimeouts | None = None,
             deadline: float | None = None) -> dict:
    """Submit one resolve and honor admission control: ``busy`` replies
    carry a retry-after; give up (→ local fallback) once the cumulative
    deadline would be exceeded."""
    cfg = _cfg(cfg)
    if deadline is None:
        deadline = time.monotonic() + cfg.max_wait_s
    attempt = 0
    while True:
        protocol.send_msg(conn, msg)
        resp = protocol.recv_msg(conn)
        t = resp.get("type")
        if t == "accepted":
            return resp
        if t == "busy":
            delay = max(float(resp.get("retry_after_s", 1.0)),
                        _backoff(cfg, attempt))
            attempt += 1
            if time.monotonic() + delay >= deadline:
                raise ServeUnavailable(
                    f"daemon busy past the {cfg.max_wait_s:.0f}s "
                    f"cumulative wait budget (backpressure)")
            time.sleep(delay)
            continue
        raise ServeUnavailable(
            f"daemon rejected request: {resp.get('reason', resp)}")


def simulate_dataflow_served(
    stages, mems, n_iters, *,
    fifo_depths=(8,), freq_mhz=150.0, seed=0,
    collect_stalls=True, depth_incremental=True,
    address: str | None = None, weight: float = 1.0,
    timeouts: ServeTimeouts | None = None,
):
    """``simulate_dataflow_many`` with resolution delegated to the
    daemon at ``address`` (default: the store's canonical socket)."""
    from ..core import rescache as _rc
    from ..core.simulator import (SimResult, _LaneSolver, _OpFolder,
                                  _ServedOps, _ServeLost)
    if not _rc.enabled(None) or not _rc._dir():
        raise ServeUnavailable("serving requires an enabled rescache "
                               "with a disk store")
    C = _rc.CHUNK_ITERS
    mems = dict(mems)
    stages = list(stages)
    keys: dict[str, str] = {}
    served: dict[str, _ServedOps] = {}
    live: dict[str, object] = {}
    for mn, mem in mems.items():
        key = _rc.resolution_key("dataflow", stages, mem, seed)
        if key is None:
            raise ServeUnavailable(f"model {mn} is not keyable")
        keys[mn] = key
        _, avail = _rc.prefix(key, C)
        if avail >= n_iters:
            served[mn] = _ServedOps(key, n_iters)
        else:
            live[mn] = mem
    if not live:
        raise ServeUnavailable("fully served from the store")
    try:
        import cloudpickle
        payload = cloudpickle.dumps({
            "stages": stages, "mems": live, "seed": seed,
            "n_iters": n_iters,
            "keys": {mn: keys[mn] for mn in live}})
    except Exception as e:  # noqa: BLE001 — unpicklable traces
        raise ServeUnavailable(f"stages will not serialize: {e}") \
            from e

    cfg = _cfg(timeouts)
    wait_deadline = time.monotonic() + cfg.max_wait_s
    addr = address or protocol.default_address()
    conn = _connect(addr, cfg, wait_deadline)
    try:
        req = f"{os.getpid()}.{next(_REQ_COUNTER)}"
        resp = _request(conn, {
            "type": "resolve", "req": req,
            "keys": {mn: keys[mn] for mn in live}, "mems": live,
            "seed": seed, "n_iters": n_iters, "chunk_iters": C,
            "store_dir": _rc._dir(), "payload": payload,
            "weight": weight, "deadline_s": cfg.deadline_s},
            cfg=cfg, deadline=wait_deadline)
        first_live = int(resp["first_live"])
        n_chunks = -(-n_iters // C)
        live_view = {mn: _ServedOps(keys[mn],
                                    min(n_iters, first_live * C))
                     for mn in live} if first_live > 0 else {}

        folder = _OpFolder(stages)
        solvers = {(mn, d): _LaneSolver(stages, d, collect_stalls)
                   for mn in mems for d in fifo_depths}
        depth_order = sorted(set(fifo_depths), reverse=True)
        pending: dict[int, dict] = {}

        n_recv = itertools.count(1)

        def take(idx: int) -> dict:
            while idx not in pending:
                if faults.active():  # chaos harness: lossy client link
                    i = next(n_recv)
                    faults.maybe_sleep("delay_socket", msg=i)
                    faults.maybe_drop(conn, msg=i)
                m = protocol.recv_msg(conn)
                t = m.get("type")
                if t == "chunk":
                    pending[m["idx"]] = m
                elif t == "done":
                    continue
                elif t in ("failed", "error"):
                    raise ServeUnavailable(
                        f"daemon failed request: {m.get('reason')}")
            return pending.pop(idx)

        last_idx = n_chunks - 1
        prev_cum: dict[str, dict] = {}
        last_cum: dict[str, dict] = {}
        tail_planes: dict[str, tuple] = {}
        solve_wall = 0.0
        for k in range(n_chunks):
            lo, hi = k * C, min((k + 1) * C, n_iters)
            msg = take(k) if k >= first_live else None
            t0 = time.perf_counter()
            for mn in mems:
                if mn in served:
                    L = served[mn].chunk(lo, hi)
                    _rc.note_chunks(served=1)
                elif k < first_live:
                    L = live_view[mn].chunk(lo, hi)
                    _rc.note_chunks(served=1)
                else:
                    info = msg["inline"][mn]
                    if info is not None:
                        L = info["ops"][:hi - lo]
                        if k == last_idx:
                            tail_planes[mn] = (info["hits"],
                                               info["visits"])
                    else:
                        # (re)written by the pool just now: skip the
                        # in-process LRU's possibly-stale copy
                        rec = _rc.get_chunk(keys[mn], k, refresh=True)
                        if rec is None:
                            raise _ServeLost(
                                f"served chunk {keys[mn]}.c{k} "
                                f"vanished")
                        L = rec.ops[:hi - lo]
                        if k == last_idx:
                            tail_planes[mn] = (rec.hitbits,
                                               rec.hitbits2)
                    if k == last_idx - 1:
                        prev_cum[mn] = msg["cums"][mn]
                    if k == last_idx:
                        last_cum[mn] = msg["cums"][mn]
                if L.dtype != np.int32:
                    L = L.astype(np.int32)
                res = folder.fold(mems[mn], lo, hi, L)
                warm = None
                for d in depth_order:
                    warm = solvers[(mn, d)].solve_chunk(
                        res, warm=warm if depth_incremental else None)
            solve_wall += time.perf_counter() - t0

        def live_stats(mn: str) -> tuple[int, int]:
            """Exact (hits, misses) at ``n_iters`` for a live model —
            from the streamed cumulative counters when the run ends on
            the canonical grid, else counters + the tail chunk's
            hit/visit planes (the same reconstruction
            ``_ServedOps.stats_upto`` performs on records)."""
            from ..core.simulator import _cache_group_key
            if _cache_group_key(mems[mn]) is None:
                return 0, 0
            if last_idx < first_live:  # whole run inside the prefix
                return _ServedOps(keys[mn], n_iters).stats_upto(n_iters)
            cum = last_cum[mn]
            if n_iters == (last_idx + 1) * C:
                return int(cum["hits"]), int(cum["misses"])
            if last_idx == first_live and first_live > 0:
                rec = _rc.get_chunk(keys[mn], first_live - 1)
                if rec is None:
                    raise _ServeLost("resume record vanished")
                h0 = int(rec.cum.get("hits", 0))
                m0 = int(rec.cum.get("misses", 0))
            elif last_idx == 0:
                h0 = m0 = 0
            else:
                pc = prev_cum[mn]
                h0, m0 = int(pc["hits"]), int(pc["misses"])
            hb, vb = tail_planes[mn]
            if hb is None or vb is None:
                return h0, m0
            K = max(folder.K, 1)
            tail = n_iters - last_idx * C
            h = np.unpackbits(hb, count=C * K)[:tail * K]
            v = np.unpackbits(vb, count=C * K)[:tail * K]
            th, tv = int(h.sum()), int(v.sum())
            return h0 + th, m0 + (tv - th)

        stats = {mn: (served[mn].stats_upto(n_iters) if mn in served
                      else live_stats(mn)) for mn in mems}
        try:
            protocol.send_msg(conn, {"type": "solved", "req": req,
                                     "solve_wall_s": solve_wall})
        except OSError:
            pass  # stats-only ack: never fail a finished run over it
        return {(mn, d): SimResult("dataflow", solver.last_finish,
                                   n_iters, freq_mhz, solver.stall,
                                   *stats[mn])
                for (mn, d), solver in solvers.items()}
    except (_ServeLost, protocol.ProtocolError, OSError, EOFError,
            KeyError) as e:
        # mid-stream daemon death / dropped socket / raced eviction:
        # the caller falls back to library mode and — because every
        # already-streamed chunk was committed to the store — resumes
        # from the committed prefix rather than restarting cold.
        # Count it so fallback is visible, not folklore.
        _rc.note_failover()
        raise ServeUnavailable(f"serving failed mid-run: {e}") from e
    finally:
        try:
            conn.close()
        except OSError:
            pass


def prefetch(stages, mems, n_iters, *, seed=0,
             address: str | None = None, weight: float = 1.0) -> dict:
    """Resolve through the daemon *without* folding: drain the stream
    and return the dedup summary.  A following local run then serves
    from the store — the serve path for the scalar/DSE engines, which
    fold chunk-by-chunk internally.  Best-effort: artifacts past the
    store cap still resolve cold locally."""
    from ..core import rescache as _rc
    from ..core.simulator import _ServeLost
    if not _rc.enabled(None) or not _rc._dir():
        raise ServeUnavailable("serving requires an enabled rescache")
    C = _rc.CHUNK_ITERS
    stages = list(stages)
    keys, live = {}, {}
    for mn, mem in dict(mems).items():
        key = _rc.resolution_key("dataflow", stages, mem, seed)
        if key is None:
            raise ServeUnavailable(f"model {mn} is not keyable")
        _, avail = _rc.prefix(key, C)
        if avail < n_iters:
            keys[mn], live[mn] = key, mem
    if not live:
        return {"store": -(-n_iters // C), "inflight": 0, "cold": 0}
    try:
        import cloudpickle
        payload = cloudpickle.dumps({
            "stages": stages, "mems": live, "seed": seed,
            "n_iters": n_iters, "keys": keys})
    except Exception as e:  # noqa: BLE001
        raise ServeUnavailable(f"stages will not serialize: {e}") \
            from e
    cfg = _cfg(None)
    wait_deadline = time.monotonic() + cfg.max_wait_s
    addr = address or protocol.default_address()
    conn = _connect(addr, cfg, wait_deadline)
    try:
        req = f"{os.getpid()}.{next(_REQ_COUNTER)}"
        resp = _request(conn, {
            "type": "resolve", "req": req, "keys": keys, "mems": live,
            "seed": seed, "n_iters": n_iters, "chunk_iters": C,
            "store_dir": _rc._dir(), "payload": payload,
            "weight": weight}, cfg=cfg, deadline=wait_deadline)
        while True:
            m = protocol.recv_msg(conn)
            t = m.get("type")
            if t == "done":
                break
            if t in ("failed", "error"):
                raise ServeUnavailable(
                    f"daemon failed request: {m.get('reason')}")
        protocol.send_msg(conn, {"type": "solved", "req": req,
                                 "solve_wall_s": 0.0})
        return dict(resp.get("dedup", {}))
    except (_ServeLost, protocol.ProtocolError, OSError,
            EOFError) as e:
        raise ServeUnavailable(f"prefetch failed: {e}") from e
    finally:
        try:
            conn.close()
        except OSError:
            pass


# -- daemon control ----------------------------------------------------------

def ping(address: str | None = None, timeout: float = 2.0) -> bool:
    addr = address or protocol.default_address()
    try:
        s = protocol.connect(addr, timeout=timeout)
        protocol.send_msg(s, {"type": "ping"})
        ok = protocol.recv_msg(s).get("type") == "pong"
        s.close()
        return ok
    except (OSError, protocol.ProtocolError, EOFError):
        return False


def get_stats(address: str | None = None) -> dict:
    addr = address or protocol.default_address()
    try:
        s = protocol.connect(addr, timeout=10.0)
        protocol.send_msg(s, {"type": "stats"})
        out = protocol.recv_msg(s)["stats"]
        s.close()
        return out
    except (OSError, protocol.ProtocolError, EOFError, KeyError) as e:
        raise ServeUnavailable(f"no daemon at {addr}: {e}") from e


def shutdown(address: str | None = None) -> bool:
    addr = address or protocol.default_address()
    try:
        s = protocol.connect(addr, timeout=10.0)
        protocol.send_msg(s, {"type": "shutdown"})
        ok = protocol.recv_msg(s).get("type") == "ok"
        s.close()
        return ok
    except (OSError, protocol.ProtocolError, EOFError):
        return False


def _clear_stale_socket(addr: str) -> None:
    """A crashed daemon leaves its AF_UNIX socket file behind; connect
    then raises ``ECONNREFUSED`` forever.  Since :func:`ping` just said
    nobody answers, an existing path is stale — unlink it so the daemon
    we are about to spawn binds cleanly (its own bind would also clear
    it, but a half-spawned daemon must never unlink a *live* socket,
    which is why this runs only under the spawn lock)."""
    if protocol.is_inet(addr):
        return
    if os.path.exists(addr):
        try:
            os.unlink(addr)
        except OSError:
            pass


def ensure_daemon(address: str | None = None,
                  workers: int | None = None,
                  wait_s: float = 60.0) -> str:
    """``--server auto``: return a live daemon's address, spawning a
    detached one for this store (inheriting the current rescache
    configuration, chunk grid, device policy and engine) when none
    answers.

    The probe-and-spawn sequence holds an ``flock`` on ``<addr>.lock``
    so two racing clients cannot both observe "no daemon" and spawn
    two: the loser blocks on the lock, re-pings, and finds the winner's
    daemon.  Stale socket files from a crashed daemon are unlinked
    under the same lock."""
    import fcntl
    import hashlib
    from ..core import rescache as _rc
    addr = address or protocol.default_address()
    if ping(addr):
        return addr
    if protocol.is_inet(addr):
        lock_path = os.path.join(
            tempfile_dir(), "repro-torch-serve-"
            + hashlib.blake2b(addr.encode(), digest_size=8).hexdigest()
            + ".lock")
    else:
        lock_path = addr + ".lock"
    with open(lock_path, "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        # somebody else may have spawned while we waited for the lock
        if ping(addr):
            return addr
        _clear_stale_socket(addr)
        from .. import _device
        from ..core import engine as _engine
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "daemon",
               "--socket", addr, "--store-dir", _rc._dir() or "",
               "--device", _device.default_device_type()]
        if workers is not None:
            cmd += ["--workers", str(workers)]
        env = dict(os.environ)
        env["REPRO_CHUNK_ITERS"] = str(_rc.CHUNK_ITERS)
        # the daemon runs this package, on this process's engine
        env["REPRO_TORCH_ENGINE"] = _engine.current()
        src = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (src, env.get("PYTHONPATH")) if p)
        subprocess.Popen(cmd, stdout=subprocess.DEVNULL,
                         stderr=subprocess.DEVNULL,
                         start_new_session=True, env=env)
        deadline = time.monotonic() + wait_s
        while time.monotonic() < deadline:
            if ping(addr, timeout=1.0):
                return addr
            time.sleep(0.2)
    raise ServeUnavailable(f"spawned daemon at {addr} never answered")


def tempfile_dir() -> str:
    import tempfile
    return tempfile.gettempdir()


class ResolutionClient:
    """Object handle over one daemon: the form `Compiled.simulate /
    sweep / explore` and the benchmark drivers plumb through
    ``server=``."""

    def __init__(self, address: str | None = None,
                 weight: float = 1.0):
        self.address = address or protocol.default_address()
        self.weight = weight

    def simulate_many(self, stages, mems, n_iters, **kw):
        return simulate_dataflow_served(stages, mems, n_iters,
                                        address=self.address,
                                        weight=self.weight, **kw)

    def prefetch(self, stages, mems, n_iters, *, seed=0):
        return prefetch(stages, mems, n_iters, seed=seed,
                        address=self.address, weight=self.weight)

    def ping(self) -> bool:
        return ping(self.address)

    def stats(self) -> dict:
        return get_stats(self.address)

    def shutdown(self) -> bool:
        return shutdown(self.address)
