"""Fault tolerance: retrying step guard, straggler policy, elastic restore.

At thousands of nodes, the framework must assume: (a) steps fail
(preemption, ICI link flap, host OOM) — recover from the last checkpoint
without operator action; (b) data hosts straggle — never let one slow
producer stall the whole step (bounded staleness); (c) the incoming pod
count can change — restore onto a different mesh (the checkpointer re-shards).

The guards are deliberately framework-level (pure Python around the jitted
step): device-side failures surface as exceptions from the runtime, which is
exactly the boundary where recovery must happen.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Iterator

log = logging.getLogger("repro_torch.ft")


class StepFailure(RuntimeError):
    """Raised by failure-injection hooks in tests."""


@dataclasses.dataclass
class GuardConfig:
    max_retries: int = 3
    #: called as restore() -> (state, step) after a failure
    restore_fn: Callable | None = None
    #: test hook: fail_at(step) -> bool injects a failure before the step
    fail_at: Callable[[int], bool] | None = None


class StepGuard:
    """Runs the train step with retry-from-checkpoint semantics."""

    def __init__(self, step_fn: Callable, cfg: GuardConfig):
        self.step_fn = step_fn
        self.cfg = cfg
        self.failures = 0
        self.restores = 0

    def run(self, state: Any, batch: dict, step: int) -> tuple[Any, dict]:
        attempts = 0
        while True:
            try:
                if (self.cfg.fail_at is not None
                        and self.cfg.fail_at(step)
                        and attempts == 0):
                    raise StepFailure(f"injected failure at step {step}")
                return self.step_fn(state, batch)
            except (StepFailure, RuntimeError) as e:
                self.failures += 1
                attempts += 1
                if attempts > self.cfg.max_retries:
                    raise
                log.warning("step %d failed (%s); restoring (%d/%d)",
                            step, e, attempts, self.cfg.max_retries)
                if self.cfg.restore_fn is not None:
                    state, _ = self.cfg.restore_fn()
                    self.restores += 1


@dataclasses.dataclass
class StragglerPolicy:
    """Bounded-staleness batch fetch: if the producer exceeds the deadline,
    reuse the previous batch rather than stalling the step (the template's
    backpressure rule applied to the host boundary).  Reuse is counted —
    a persistently slow producer shows up in metrics, not in step time."""

    deadline_s: float = 5.0
    max_consecutive_reuse: int = 3

    def __post_init__(self):
        self.reused = 0
        self._consecutive = 0
        self._last: dict | None = None

    def next_batch(self, source: Iterator[dict]) -> dict:
        t0 = time.monotonic()
        try:
            batch = self._fetch(source, self.deadline_s)
            self._last = batch
            self._consecutive = 0
            return batch
        except TimeoutError:
            if (self._last is None
                    or self._consecutive >= self.max_consecutive_reuse):
                # stalling is now unavoidable — block for real
                batch = next(source)
                self._last = batch
                self._consecutive = 0
                return batch
            self.reused += 1
            self._consecutive += 1
            log.warning("data straggler (> %.1fs); reusing last batch "
                        "(%d consecutive)", time.monotonic() - t0,
                        self._consecutive)
            return self._last

    @staticmethod
    def _fetch(source: Iterator[dict], deadline: float) -> dict:
        """Fetch with a deadline.  HostFIFO exposes occupancy; for plain
        iterators we just call next() (cannot time out portably) unless the
        source provides a non-blocking path."""
        q = getattr(source, "_q", None)
        if q is None:
            return next(source)
        import queue as _queue

        try:
            item = q.get(timeout=deadline)
        except _queue.Empty as e:
            raise TimeoutError from e
        if item is getattr(source, "_SENTINEL", object()):
            raise StopIteration
        return item


@dataclasses.dataclass
class SpeculationPolicy:
    """When to speculatively re-dispatch a straggling chunk — the
    :class:`StragglerPolicy` bounded-staleness rule applied to chunk
    *dispatch* instead of batch *fetch*: rather than reusing stale
    data, a chunk whose wall exceeds ``latency_factor ×`` the observed
    median (floored at ``min_wait_s``) earns a duplicate dispatch on
    another worker.  Resolution is deterministic, so both copies
    produce the same bits; the first commit wins and the loser's
    result is discarded by the master's ordinary duplicate guards —
    speculation can only ever cost wasted work, never correctness.

    ``max_inflight`` bounds concurrent speculative copies (a cluster of
    stragglers must not double the cluster).  ``observe`` feeds
    completed chunk walls; with no samples yet nothing is overdue
    (there is no baseline to call anything slow against)."""

    min_wait_s: float = 5.0
    latency_factor: float = 4.0
    max_inflight: int = 2

    def __post_init__(self):
        self._walls: list[float] = []
        self.issued = 0
        self.wins = 0

    def observe(self, wall_s: float) -> None:
        self._walls.append(float(wall_s))
        del self._walls[:-64]

    def median_wall(self) -> float | None:
        if not self._walls:
            return None
        s = sorted(self._walls)
        return s[len(s) // 2]

    def overdue(self, elapsed_s: float) -> bool:
        med = self.median_wall()
        if med is None:
            return False
        return elapsed_s > max(self.min_wait_s,
                               self.latency_factor * med)

    def snapshot(self) -> dict:
        return {"issued": self.issued, "wins": self.wins,
                "min_wait_s": self.min_wait_s,
                "latency_factor": self.latency_factor,
                "median_wall_s": self.median_wall()}
