"""Deterministic fault injection for the resolution/serving stack.

A :class:`FaultPlan` is a seeded list of :class:`FaultSpec` entries,
each naming a fault *kind*, a 1-based occurrence index ``at`` (fire on
the Nth matching event), and optional filters (worker id, chunk index,
artifact key).  The plan is installed either programmatically
(:func:`install`, in-process tests) or through the environment
(``REPRO_FAULT_PLAN`` holding JSON or a path to JSON), which is how it
reaches spawned daemon and worker processes — the env var is inherited,
so one setting arms every process of the serving stack.

Hook sites are sprinkled through the stack and are **no-ops when no
plan is armed** (a cached module check, no I/O):

========================  =====================================================
kind                      site / effect
========================  =====================================================
``worker_kill``           pool worker, start of a chunk task: SIGKILL itself
``reply_kill``            pool worker, replying on chunk N: write half the
                          reply to the daemon, then SIGKILL itself
``straggler``             pool worker, start of phase C: sleep ``delay_s``
``daemon_kill``           daemon, after committing chunk N: SIGKILL itself
``corrupt_chunk``         rescache ``put_chunk``: bit-flip bytes of the
                          just-written record (detected later by checksum)
``truncate_chunk``        rescache ``put_chunk``: truncate the record file
``drop_socket``           serve client, after the Nth streamed message:
                          close the connection mid-stream
``delay_socket``          serve client, before the Nth recv: sleep ``delay_s``
========================  =====================================================

Every fault is **deterministic**: the same plan against the same
workload fires at the same event, so chaos scenarios replay exactly.
Fired faults are counted per process (:func:`stats`) and, when the plan
names a ``log`` file, appended there *before* the fault is enacted —
the only way a self-SIGKILL can be observed from outside.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time
from typing import Any

KINDS = ("worker_kill", "reply_kill", "daemon_kill", "corrupt_chunk", "truncate_chunk",
         "drop_socket", "delay_socket", "straggler")

ENV = "REPRO_FAULT_PLAN"


@dataclasses.dataclass
class FaultSpec:
    """One fault: fire on occurrences ``at .. at+count-1`` of matching
    events at the ``kind`` hook site.  ``target`` filters on worker id,
    ``chunk`` on chunk index, ``key`` on an artifact-key prefix; an
    unset filter matches everything."""

    kind: str
    at: int = 1
    count: int = 1
    target: int | None = None
    chunk: int | None = None
    key: str | None = None
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {KINDS}")

    def matches(self, ctx: dict[str, Any]) -> bool:
        if self.target is not None and ctx.get("worker") != self.target:
            return False
        if self.chunk is not None and ctx.get("chunk") != self.chunk:
            return False
        if self.key is not None and \
                not str(ctx.get("key", "")).startswith(self.key):
            return False
        return True


class FaultPlan:
    """A seeded, replayable set of faults plus per-process accounting."""

    def __init__(self, faults: Any = (), seed: int = 0,
                 log: str | None = None):
        self.faults = [f if isinstance(f, FaultSpec) else FaultSpec(**f)
                       for f in faults]
        self.seed = int(seed)
        self.log = log
        # per-spec event counters: spec index -> matching events seen
        self._seen = [0] * len(self.faults)
        self.injected: dict[str, int] = {}

    @classmethod
    def from_json(cls, raw: str) -> "FaultPlan":
        d = json.loads(raw)
        if isinstance(d, list):
            d = {"faults": d}
        return cls(d.get("faults", ()), seed=d.get("seed", 0),
                   log=d.get("log"))

    def to_json(self) -> str:
        return json.dumps({
            "seed": self.seed, "log": self.log,
            "faults": [dataclasses.asdict(f) for f in self.faults]})

    def rng_byte(self, n: int) -> int:
        """Deterministic pseudo-random byte for corruption payloads."""
        import hashlib
        h = hashlib.blake2b(f"{self.seed}:{n}".encode(), digest_size=1)
        return h.digest()[0] or 0xFF

    def check(self, kind: str, **ctx: Any) -> FaultSpec | None:
        """Count this event against every matching spec; return the
        first spec whose firing window covers it, else ``None``.

        When the plan carries a ``log``, it is also the cross-process
        firing registry: a spec fires at most ``count`` times *across
        all processes of the plan* — without this, a respawned worker
        (fresh process, same env plan) would re-kill itself at the same
        chunk forever, and the crash loop would eat the retry budget
        instead of proving recovery."""
        hit = None
        for i, f in enumerate(self.faults):
            if f.kind != kind or not f.matches(ctx):
                continue
            self._seen[i] += 1
            if hit is None and f.at <= self._seen[i] < f.at + f.count:
                hit = f
        if hit is not None and self.log and \
                log_counts(self.log).get(kind, 0) >= hit.count:
            return None
        if hit is not None:
            self.injected[kind] = self.injected.get(kind, 0) + 1
            self._note(kind, ctx)
        return hit

    def _note(self, kind: str, ctx: dict[str, Any]) -> None:
        if not self.log:
            return
        try:
            with open(self.log, "a") as f:
                f.write(json.dumps({"kind": kind, "pid": os.getpid(),
                                    **{k: v for k, v in ctx.items()
                                       if isinstance(v, (int, str))}})
                        + "\n")
                f.flush()
        except OSError:
            pass


_plan: FaultPlan | None = None
_env_loaded = False


def install(plan: FaultPlan | None) -> None:
    """Arm (or with ``None`` disarm) a plan in this process; overrides
    any environment plan."""
    global _plan, _env_loaded
    _plan = plan
    _env_loaded = True


def reset() -> None:
    """Disarm and forget, re-reading the environment on next use."""
    global _plan, _env_loaded
    _plan = None
    _env_loaded = False


def plan() -> FaultPlan | None:
    global _plan, _env_loaded
    if not _env_loaded:
        _env_loaded = True
        raw = os.environ.get(ENV)
        if raw:
            if os.path.isfile(raw):
                with open(raw) as f:
                    raw = f.read()
            try:
                _plan = FaultPlan.from_json(raw)
            except (ValueError, TypeError, KeyError):
                _plan = None
    return _plan


def active() -> bool:
    return plan() is not None


def stats() -> dict[str, int]:
    """Faults injected *by this process* (kind -> count)."""
    p = _plan if _env_loaded else plan()
    return dict(p.injected) if p is not None else {}


def log_counts(path: str) -> dict[str, int]:
    """Merge a plan's cross-process fault log (kind -> count) — the
    harness-side view that survives self-SIGKILLed processes."""
    out: dict[str, int] = {}
    try:
        with open(path) as f:
            for line in f:
                try:
                    kind = json.loads(line).get("kind")
                except ValueError:
                    continue
                if kind:
                    out[kind] = out.get(kind, 0) + 1
    except OSError:
        pass
    return out


# ---------------------------------------------------------------------------
# Hook helpers — each is a no-op unless a plan is armed and fires.
# ---------------------------------------------------------------------------

def maybe_kill(kind: str, **ctx: Any) -> None:
    """SIGKILL the current process if a ``kind`` spec fires (worker- and
    daemon-crash injection; the log line lands before the kill)."""
    p = plan()
    if p is None:
        return
    if p.check(kind, **ctx) is not None:
        os.kill(os.getpid(), signal.SIGKILL)


def maybe_cut_reply(conn: Any, msg: Any, **ctx: Any) -> None:
    """SIGKILL the current process with ``msg`` half-written to the
    pipe ``conn`` if a ``reply_kill`` spec fires: the length header and
    the first half of the pickle reach the reader, the rest never
    does."""
    p = plan()
    if p is None or p.check("reply_kill", **ctx) is None:
        return
    import struct
    from multiprocessing.reduction import ForkingPickler
    buf = bytes(ForkingPickler.dumps(msg))
    os.write(conn.fileno(),
             struct.pack("!i", len(buf)) + buf[:len(buf) // 2])
    os.kill(os.getpid(), signal.SIGKILL)


def maybe_sleep(kind: str, **ctx: Any) -> float:
    """Sleep ``delay_s`` if a spec fires (straggler / socket delay);
    returns the injected delay."""
    p = plan()
    if p is None:
        return 0.0
    f = p.check(kind, **ctx)
    if f is None or f.delay_s <= 0:
        return 0.0
    time.sleep(f.delay_s)
    return f.delay_s


def maybe_drop(conn: Any, **ctx: Any) -> bool:
    """Hard-close a client connection mid-stream if ``drop_socket``
    fires; returns True when it did."""
    p = plan()
    if p is None:
        return False
    if p.check("drop_socket", **ctx) is None:
        return False
    try:
        conn.shutdown(2)  # socket.SHUT_RDWR without importing socket
    except OSError:
        pass
    try:
        conn.close()
    except OSError:
        pass
    return True


def maybe_corrupt(path: str, **ctx: Any) -> str | None:
    """Bit-flip (``corrupt_chunk``) or truncate (``truncate_chunk``) a
    just-written store record if a spec fires.  Returns the kind fired,
    else ``None``.  The damage is deliberately *silent* — detection is
    the store's job (checksums), not the injector's."""
    p = plan()
    if p is None:
        return None
    f = p.check("corrupt_chunk", **ctx)
    if f is not None:
        corrupt_file(path, seed=p.seed)
        return "corrupt_chunk"
    f = p.check("truncate_chunk", **ctx)
    if f is not None:
        truncate_file(path)
        return "truncate_chunk"
    return None


def corrupt_file(path: str, seed: int = 0, n_bytes: int = 8) -> None:
    """Flip bytes in the middle of ``path`` (payload region of an npz,
    past the zip local-file header) deterministically."""
    try:
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            for i in range(n_bytes):
                pos = (size // 3 + i * max(1, size // (3 * n_bytes))) \
                    % max(1, size)
                f.seek(pos)
                b = f.read(1)
                if not b:
                    break
                f.seek(pos)
                import hashlib
                x = hashlib.blake2b(f"{seed}:{i}".encode(),
                                    digest_size=1).digest()[0] | 1
                f.write(bytes([b[0] ^ x]))
    except OSError:
        pass


def truncate_file(path: str) -> None:
    """Cut ``path`` to half its size — a torn write / crashed writer."""
    try:
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.truncate(max(1, size // 2))
    except OSError:
        pass
