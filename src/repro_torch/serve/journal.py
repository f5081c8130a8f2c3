"""Append-only journal of the resolution daemon.

The daemon is a scheduling layer over a store that already holds every
*committed* result, so durability needs very little: enough to (a) keep
``serve stats`` counters monotone across restarts, and (b) let a
restarted daemon *finish* jobs that were in flight when it died —
"re-attach from store prefixes": the store's contiguous prefix says
which chunks survived, the journal says which jobs wanted how many.

Layout (under ``<store_dir>/.serve-journal/``):

* ``journal.jsonl`` — one JSON event per line:

  ===========  ============================================================
  ``start``    a daemon lifetime began (``pid``); the count of these is
               the restart counter
  ``job``      a job was admitted or extended: ``jid``, ``keys`` (model →
               v3 key), ``seed``, ``n_iters``, ``n_chunks`` (the demand
               high-water); fsynced — an un-journaled job is a lost job
  ``job_done`` the job committed every demanded chunk (its payload blob
               is deleted)
  ``job_failed``  the job failed permanently
  ``req``      one completed request record (the ``serve stats`` log)
  ``stats``    cumulative counter snapshot (base + current lifetime),
               so replay just takes the last one
  ===========  ============================================================

* ``job-<jid>.payload`` — the job's cloudpickled stage/model payload,
  exactly the bytes the client shipped; a restarted daemon re-creates
  the job from it and resolves the remainder with no client attached.

Replay is a single forward scan; a torn final line (the daemon died
mid-append) is skipped.  The journal never holds results — corrupting
it can lose *counters* and orphan *pending work*, never bits.
"""

from __future__ import annotations

import json
import os
import tempfile


class Journal:
    def __init__(self, store_dir: str, enabled: bool = True):
        self.enabled = enabled
        self.dir = os.path.join(store_dir, ".serve-journal")
        self.path = os.path.join(self.dir, "journal.jsonl")
        if enabled:
            os.makedirs(self.dir, exist_ok=True)

    # -- writing -------------------------------------------------------------

    def append(self, ev: dict, sync: bool = False) -> None:
        if not self.enabled:
            return
        try:
            with open(self.path, "a") as f:
                f.write(json.dumps(ev, sort_keys=True) + "\n")
                if sync:
                    f.flush()
                    os.fsync(f.fileno())
        except OSError:
            pass  # journaling is best-effort; serving never stops for it

    def payload_path(self, jid: int) -> str:
        return os.path.join(self.dir, f"job-{jid}.payload")

    def save_payload(self, jid: int, payload: bytes) -> None:
        if not self.enabled:
            return
        try:
            fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
            with os.fdopen(fd, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.payload_path(jid))
        except OSError:
            pass

    def load_payload(self, jid: int) -> bytes | None:
        try:
            with open(self.payload_path(jid), "rb") as f:
                return f.read()
        except OSError:
            return None

    def drop_payload(self, jid: int) -> None:
        try:
            os.unlink(self.payload_path(jid))
        except OSError:
            pass

    # -- replay --------------------------------------------------------------

    def replay(self) -> dict:
        """Scan the journal: ``{starts, base_stats, open_jobs, req_log,
        max_jid}``.  ``open_jobs`` maps jid → the latest ``job`` event
        of every job without a terminal event (the restarted daemon's
        re-attach worklist)."""
        starts = 0
        base: dict = {}
        open_jobs: dict[int, dict] = {}
        req_log: list[dict] = []
        max_jid = 0
        if not self.enabled or not os.path.exists(self.path):
            return {"starts": 0, "base_stats": {}, "open_jobs": {},
                    "req_log": [], "max_jid": 0}
        try:
            with open(self.path) as f:
                for line in f:
                    try:
                        ev = json.loads(line)
                    except ValueError:
                        continue  # torn tail line from a crash
                    t = ev.get("ev")
                    if t == "start":
                        starts += 1
                    elif t == "job":
                        jid = int(ev["jid"])
                        open_jobs[jid] = ev
                        max_jid = max(max_jid, jid)
                    elif t in ("job_done", "job_failed"):
                        open_jobs.pop(int(ev["jid"]), None)
                    elif t == "req":
                        req_log.append(ev.get("record", {}))
                        del req_log[:-64]
                    elif t == "stats":
                        base = dict(ev.get("stats", {}))
        except OSError:
            pass
        return {"starts": starts, "base_stats": base,
                "open_jobs": open_jobs, "req_log": req_log,
                "max_jid": max_jid}

    def compact(self) -> None:
        """Rewrite the journal to just the current replay state — called
        on clean startup so the file stays O(open jobs), not O(history).
        Counter snapshots and request history survive (re-serialized);
        per-lifetime ``start`` events collapse into a count carried by a
        synthetic stats snapshot's ``restarts`` key handled by the
        daemon, so this only rewrites events replay actually reads."""
        if not self.enabled:
            return
        rep = self.replay()
        try:
            fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                for _ in range(rep["starts"]):
                    f.write(json.dumps({"ev": "start"}) + "\n")
                if rep["base_stats"]:
                    f.write(json.dumps(
                        {"ev": "stats", "stats": rep["base_stats"]},
                        sort_keys=True) + "\n")
                for rec in rep["req_log"]:
                    f.write(json.dumps({"ev": "req", "record": rec},
                                       sort_keys=True) + "\n")
                for ev in rep["open_jobs"].values():
                    f.write(json.dumps(ev, sort_keys=True) + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except OSError:
            pass
