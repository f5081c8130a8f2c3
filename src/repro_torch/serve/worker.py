"""Pool worker of the resolution daemon.

A *serve* worker is the chunk-graph worker generalized from one run to
many: it multiplexes chunks of several concurrent **jobs** (one job per
distinct resolution key set) and processes each phase as a separate
message instead of blocking for the master's replies — the daemon's
scheduler interleaves phases of different jobs on one worker, so a long
Floyd–Warshall tail from one client backfills with another client's
chunks.

Phase messages (daemon → worker):

* ``("job", jid, payload)`` — install a job context: the cloudpickled
  stage list + live memory models + seed, a shared resolver, and the
  v3 chunk writers.
* ``("task", jid, k, lo, hi)`` — phases A+B fused: **one** empty-cache
  replay yields the chunk's own cache effect (state-free, freely
  parallel) plus its hit flags up to a small boundary-ambiguity table;
  the fused scratch is saved per ``(jid, k)`` so later phases survive
  interleaving with other chunks.  The effect is also persisted as a
  rescache effect record (``<key>.eNNNNN.npz``) when the job has a v3
  key.
* ``("state", jid, k, lo, hi, st)`` — finalize: patch the ambiguous
  verdicts against the composed incoming state (no second replay) and
  snapshot what phase C consumes (hit flags, flattened participation,
  *end-of-chunk* cache stacks).
* ``("draws", jid, k, msg)`` — phase C: position each model's PCG64
  stream at its absolute draw offset, materialize latencies, commit the
  v3 chunk record (or return the matrix inline past the artifact cap).
* ``("forget", jid)`` / ``("stop",)`` — drop a job / exit.

Chunks are resolved on the **canonical full-chunk grid** (``hi`` is
always a multiple of ``CHUNK_ITERS``; traces pad with −1 past their
end), so every committed record is a full chunk: any client's shorter
``n_iters`` is served as a prefix of the same bits, and a later client
extending the job never meets a poisoned partial tail.  Results are
draw-for-draw identical to the streaming engine.
"""

from __future__ import annotations

import time
import traceback

import numpy as np

from . import faults


def _reply(conn, msg: tuple, wid: int, k: int) -> None:
    """Write one reply whole to this worker's own channel before the
    next message is taken: a worker that dies later loses nothing it
    has answered, and one that dies mid-write breaks only its own
    channel, which the daemon replaces when it respawns the slot."""
    if faults.active():  # chaos: die with the reply half-written
        faults.maybe_cut_reply(conn, msg, worker=wid, chunk=k)
    conn.send(msg)


def worker_main(wid: int, C: int, task_q, reply,
                rescache_cfg: dict, device=None,
                engine: str | None = None) -> None:
    """One pool worker of the daemon; ``device`` and ``engine`` are the
    daemon's, installed before anything else (a spawned process starts
    with the port's defaults).  ``reply`` is the write end of this
    worker's own one-way pipe to the daemon."""
    from .. import _device
    from ..core import engine as _engine
    _device.set_device(device)
    _engine.select(engine)
    jid = k = -1
    try:
        import cloudpickle
        from ..core import rescache as _rc
        from ..core.simulator import _SharedResolver, _lat_itemsize
        _rc.configure(**rescache_cfg)
        _rc.CHUNK_ITERS = C
    except Exception:  # noqa: BLE001 — forwarded verbatim
        _reply(reply, ("error", wid, jid, k, traceback.format_exc()),
               wid, k)
        return
    jobs: dict[int, dict] = {}
    scratch: dict[tuple[int, int], dict] = {}
    while True:
        m = task_q.get()
        op = m[0]
        if op == "stop":
            return
        t0 = time.perf_counter()
        try:
            if op == "job":
                _, jid, payload = m
                p = cloudpickle.loads(payload)
                resolver = _SharedResolver(p["stages"], p["mems"],
                                           p["seed"], capture=True)
                writers = {mn: _rc.ChunkWriter(
                    key, resolver.K, p["n_iters"],
                    itemsize=_lat_itemsize(p["mems"][mn]))
                    for mn, key in p["keys"].items() if key is not None}
                jobs[jid] = {
                    "resolver": resolver,
                    "writers": {mn: w for mn, w in writers.items()
                                if not w.dead},
                    "mems": p["mems"],
                    "effect_keys": {
                        mn: key for mn, key in p["keys"].items()
                        if key is not None
                        and resolver.cache_keys[mn] is not None},
                }
            elif op == "forget":
                _, jid = m
                jobs.pop(jid, None)
                for sk in [sk for sk in scratch if sk[0] == jid]:
                    del scratch[sk]
            elif op == "task":
                _, jid, k, lo, hi = m
                if faults.active():  # chaos: die / straggle mid-chunk
                    faults.maybe_kill("worker_kill", worker=wid,
                                      chunk=k)
                j = jobs[jid]
                r = j["resolver"]
                effects, n_addrs = r.chunk_effects_fused(lo, hi)
                for mn, ekey in j["effect_keys"].items():
                    geo = r.cache_keys[mn]
                    if geo is not None and geo in effects:
                        _rc.put_effect(ekey, k, effects[geo], n_addrs)
                # the fused replay scratch, snapshotted before another
                # chunk's task overwrites the resolver
                scratch[(jid, k)] = {
                    "lo": lo, "hi": hi,
                    "fused": r._fused,
                    "store_flat": r._store_flat,
                    "n_addrs": r._n_addrs,
                    "flat_p": r._flat_p,
                    "burst_words": r._burst_words,
                }
                _reply(reply, ("effect", wid, jid, k, effects, n_addrs,
                               time.perf_counter() - t0), wid, k)
            elif op == "state":
                _, jid, k, lo, hi, st = m
                r = jobs[jid]["resolver"]
                sc = scratch[(jid, k)]
                r._fused = sc["fused"]
                r._store_flat = sc["store_flat"]
                r._n_addrs = sc["n_addrs"]
                r._flat_p = sc["flat_p"]
                r._burst_words = sc["burst_words"]
                deltas = r.finalize_replay(st)
                # everything phase C consumes, completed with the
                # finalize outputs: the hit flags *and* the
                # end-of-chunk cache stacks (the record's resume state)
                sc["hits_by_key"] = r._hits_by_key
                sc["end"] = {geo: sim.export_stacks()
                             for geo, sim in r.caches.items()}
                sc.pop("fused", None)
                _reply(reply, ("replay", wid, jid, k, deltas,
                               time.perf_counter() - t0), wid, k)
            elif op == "draws":
                _, jid, k, msg = m
                if faults.active():
                    # phase C is the heavy phase (draw materialization
                    # + record write): a straggler here stalls the
                    # commit watermark — exactly what the daemon's
                    # speculative re-dispatch exists to absorb
                    faults.maybe_sleep("straggler", worker=wid,
                                       chunk=k)
                j = jobs[jid]
                r = j["resolver"]
                sc = scratch.pop((jid, k))
                lo, hi = sc["lo"], sc["hi"]
                r._store_flat = sc["store_flat"]
                r._hits_by_key = sc["hits_by_key"]
                r._n_addrs = sc["n_addrs"]
                r._flat_p = sc["flat_p"]
                r._burst_words = sc["burst_words"]
                for mn, cum in msg.items():
                    r.import_resume(mn, {}, {"draws": cum["base"]})
                r.finish(lo, hi, fold=False)
                cums: dict[str, dict] = {}
                inline: dict[str, dict | None] = {}
                for mn in j["mems"]:
                    geo = r.cache_keys[mn]
                    cum = {"draws": r.draws[mn]}
                    if geo is not None:
                        cum["hits"] = msg[mn]["hits_after"]
                        cum["misses"] = msg[mn]["misses_after"]
                        cum["max_tag"] = sc["end"][geo][1]
                    cums[mn] = cum
                    hb = vb = None
                    if r.last_hits.get(mn) is not None:
                        hb = _rc.pack_flags(r.last_hits[mn])
                        vb = _rc.pack_flags(r.last_visits[mn])
                    w = j["writers"].get(mn)
                    if w is not None and k < w.max_chunks:
                        states = {}
                        if geo is not None:
                            states["cache"] = sc["end"][geo][0]
                        w.add(k, hi - lo,
                              np.ascontiguousarray(r.last_ops[mn]),
                              hb, vb, states, cum)
                        inline[mn] = None  # clients read the record
                    else:
                        # no writer / past the artifact cap: the matrix
                        # (and the planes, for mid-chunk cache stats)
                        # rides back inline through the daemon
                        inline[mn] = {
                            "ops": _rc.shrink_ops(r.last_ops[mn]),
                            "hits": hb, "visits": vb}
                _reply(reply, ("done", wid, jid, k, cums, inline,
                               time.perf_counter() - t0), wid, k)
        except Exception:  # noqa: BLE001 — the daemon fails the job,
            _reply(reply,  # the worker keeps serving its other jobs
                   ("error", wid, jid, k, traceback.format_exc()), wid, k)
