"""Discrete-event model of the dataflow architectural template (§II, Fig. 2).

The container has no FPGA (and no TPU), and the paper's results are about
*latency tolerance*, not FLOPs — so the quantitative reproduction of Fig. 5
runs the template in a cycle-level simulator driven by (a) the stage
decompositions produced by the real partitioner and (b) memory address
traces generated by the real kernels.

Three machine models, matching the paper's three bars:

* :func:`simulate_dataflow`     — the template: per-stage initiation
  intervals, bounded FIFOs with backpressure, memory stages that pipeline
  outstanding requests (latency hidden; bandwidth/II bound).
* :func:`simulate_conventional` — conventional HLS accelerator: one static
  schedule; every cache miss stalls the whole engine (§II ¶1).
* :func:`simulate_processor`    — the ARM-core software baseline (dual-issue
  OoO model with its own cache hierarchy).

Memory subsystem models mirror the Zynq options of §V: ``ACP`` (through the
PS cache/SCU), ``HP`` (direct to memory controller, higher latency), each
optionally fronted by a 64 KB 2-way on-PL cache (Xilinx System Cache IP in
the paper).

Addressing convention: **all addresses are byte addresses** (the kernels
touch 32-bit words, so consecutive words are 4 bytes apart); cache lines
and burst thresholds are derived from ``CacheConfig.line_bytes`` /
``MemoryModel.line_bytes``.

Execution model (the vectorized core)
-------------------------------------

The simulator runs in two phases, both array-at-a-time:

1. **Resolution** — every memory access in the trace is resolved to a
   latency up front: the whole interleaved address stream (iteration-major,
   stage/access-minor — the same order the scalar loop visits accesses)
   goes through :class:`BatchedCacheSim` (an exact vectorized
   set-associative LRU: a closed form for 2-way, the segmented
   distinct-line-distance scan for any other associativity) and the
   backing-store hit draw, yielding per-iteration latency arrays with no
   per-access Python calls.  :class:`_SharedResolver` resolves several
   memory models in one pass (shared windows/burst masks, one cache
   replay per distinct geometry, per-model draws), and
   :mod:`repro_torch.core.rescache` memoizes the resolved product — keyed on
   (trace fingerprints, memory model, seed) — across calls, chunk
   sizes, and processes.
2. **Wavefront solve** — the start/finish recurrence

   ``start[s,i] = max(start[s,i-1] + c[s,i], finish[s-1,i],
   start[s+1,i-fifo_depth])``

   is solved with per-stage array scans in chunk-relative int32
   coordinates: the self-recurrence with varying increment ``c`` is a
   running max over ``b - cumsum(c)``; a no-backpressure forward sweep
   plus a vectorized feasibility check is exact whenever the FIFOs are
   deep enough (the common case under the §III-B2 sizing rule), with
   alternating Gauss–Seidel sweeps — and an exact block-mode fallback —
   when backpressure binds.

Per-iteration increments ``c[s,i]`` encode the stage's initiation
interval, the memory-level-parallelism bound of the port (a stage whose
limiting access takes ``al`` cycles with ``max_outstanding`` in-flight
requests cannot issue faster than one iteration per ``ceil(al /
max_outstanding)`` cycles), burst bandwidth (``words_per_cycle``), and —
for ``mem_in_scc`` stages — the fully serialized access latencies.
Posted stores (``MemoryModel.posted_writes``) contribute to the
throughput terms but never to the data-path latency ``lat_add``;
``CacheConfig.write_allocate=False`` makes stores bypass the cache
(write-around).

``reference=True`` runs the same semantics as a scalar nested loop over
the same resolved latencies; tests assert cycle-exact agreement.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Mapping, Sequence

import numpy as np

from . import engine as _engine

#: Default cache-line / burst granularity in bytes (Zynq System Cache).
DEFAULT_LINE_BYTES = 32

#: Chunk size (iterations) for the streaming vectorized simulators: large
#: traces are resolved and solved window-by-window with carried state, so
#: full Table-I iteration counts run in bounded memory.
DEFAULT_CHUNK_ITERS = 1 << 20

_malloc_tuned = False
_malloc_tuning_wanted = True


def set_malloc_tuning(enabled: bool) -> None:
    """Host-application control over :func:`_tune_malloc`: call
    ``set_malloc_tuning(False)`` before the first simulation to keep the
    process's glibc allocator defaults (equivalent to setting
    ``REPRO_NO_MALLOC_TUNE=1``)."""
    global _malloc_tuning_wanted
    _malloc_tuning_wanted = enabled


def _tune_malloc() -> None:
    """Keep multi-MB numpy temporaries on the glibc heap.

    By default glibc serves >128 KB allocations with ``mmap`` and returns
    them to the OS on free, so every chunk-sized temporary the vectorized
    engines allocate is faulted in page by page — measured at ~10x the
    cost of the arithmetic itself.  Raising ``M_MMAP_THRESHOLD`` (and the
    trim threshold) lets freed chunk buffers be reused instantly.  Called
    once per process on first engine use; opt out with
    :func:`set_malloc_tuning` or ``REPRO_NO_MALLOC_TUNE=1``; silently
    does nothing off glibc."""
    global _malloc_tuned
    if _malloc_tuned:
        return
    _malloc_tuned = True
    import os
    if not _malloc_tuning_wanted or os.environ.get("REPRO_NO_MALLOC_TUNE"):
        return
    try:
        import ctypes
        libc = ctypes.CDLL("libc.so.6")
        libc.mallopt(-3, 32 << 20)    # M_MMAP_THRESHOLD: glibc's max
        libc.mallopt(-1, 256 << 20)   # M_TRIM_THRESHOLD
    except Exception:
        pass


# ---------------------------------------------------------------------------
# Memory subsystem
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CacheConfig:
    size_bytes: int = 64 * 1024
    line_bytes: int = DEFAULT_LINE_BYTES
    ways: int = 2
    hit_cycles: int = 4
    #: Write-allocate (the System Cache default): store misses insert the
    #: line like loads.  ``False`` models write-around: stores bypass the
    #: cache entirely (no allocation, no LRU refresh, no hit) and always
    #: pay the backing-store trip.
    write_allocate: bool = True


class CacheSim:
    """Set-associative LRU cache over **byte** addresses (scalar reference).

    One `access` call per address; :class:`BatchedCacheSim` is the
    vectorized equivalent (exact same hits/misses/replacement decisions).
    """

    def __init__(self, cfg: CacheConfig):
        self.cfg = cfg
        n_lines = cfg.size_bytes // cfg.line_bytes
        self.n_sets = max(1, n_lines // cfg.ways)
        self.tags = np.full((self.n_sets, cfg.ways), -1, dtype=np.int64)
        self.lru = np.zeros((self.n_sets, cfg.ways), dtype=np.int64)
        self.tick = 0
        self.hits = 0
        self.misses = 0

    def access(self, addr: int) -> bool:
        """Returns True on hit; inserts line on miss."""
        line = addr // self.cfg.line_bytes
        s = line % self.n_sets
        tag = line // self.n_sets
        self.tick += 1
        row = self.tags[s]
        hit = np.nonzero(row == tag)[0]
        if hit.size:
            self.lru[s, hit[0]] = self.tick
            self.hits += 1
            return True
        victim = int(np.argmin(self.lru[s]))
        self.tags[s, victim] = tag
        self.lru[s, victim] = self.tick
        self.misses += 1
        return False


class BatchedCacheSim:
    """Vectorized set-associative LRU: resolves a whole address trace to
    per-access hit flags in one call, with hit/miss decisions identical
    to :class:`CacheSim` (LRU ties broken by lowest way index).

    State persists across `lookup` calls, so a long trace can be resolved
    chunk-by-chunk and still see a warm cache.

    Strategy: accesses are grouped by set (sets are independent) and runs
    of consecutive accesses to the *same line within a set* are collapsed
    (guaranteed hits that only refresh the MRU way).  For 2-way caches the
    remaining sequence has a closed form: after collapsing, a set holds
    exactly its last two distinct lines, so an access hits iff it matches
    the line two kept-accesses back — no serial replay at all.  Other
    associativities use the exact segmented distinct-line-distance scan of
    :meth:`_lookup_nway`: an access hits iff fewer than ``ways`` distinct
    lines touched its set since the previous access to the same line, so
    per-set sequences are cut into bounded segments, each segment's
    last-``ways``-distinct stack is built with ``O(segment)`` vectorized
    rounds, incoming stacks are composed with a segmented log-depth scan
    (the "last N distinct" monoid is associative), and a second bounded
    replay records the hits — no data-dependent serial loop remains, no
    matter how skewed the per-set access counts are.
    """

    #: Segment width of the N-way scan (a power of two): bounds the
    #: vectorized replay at ``2 * _SEG_W`` rounds per lookup regardless
    #: of per-set skew.
    _SEG_W = 32

    def __init__(self, cfg: CacheConfig):
        self.cfg = cfg
        n_lines = cfg.size_bytes // cfg.line_bytes
        self.n_sets = max(1, n_lines // cfg.ways)
        self.tags = np.full((self.n_sets, cfg.ways), -1, dtype=np.int64)
        self.lru = np.zeros((self.n_sets, cfg.ways), dtype=np.int64)
        # per-set tick counters: only the relative recency order within a
        # set matters, so per-set counters reproduce the scalar behaviour.
        self.ticks = np.zeros(self.n_sets, dtype=np.int64)
        self.hits = 0
        self.misses = 0
        #: largest tag ever observed — *carried* tags must fit the narrow
        #: dtype too, not just the current call's
        self._max_tag = -1

    def lookup(self, addrs: np.ndarray) -> np.ndarray:
        """Byte addresses (int64, all valid) -> bool hit flags, in order."""
        n = len(addrs)
        if n == 0:
            return np.zeros(0, dtype=bool)
        lb, ns = self.cfg.line_bytes, self.n_sets
        if lb & (lb - 1) == 0 and ns & (ns - 1) == 0:
            # power-of-two geometry (the normal case): shifts and masks,
            # in int32 when the line numbers fit
            line = addrs >> lb.bit_length() - 1
            if n and int(line[-1] | line[0]) < (1 << 31) - 1 \
                    and int(line.max()) < (1 << 31) - 1:
                line = line.astype(np.int32)
            sset = line & (ns - 1)
            tag = line >> ns.bit_length() - 1
        else:
            line = addrs // lb
            sset = line % ns
            tag = line // ns
        # radix-sorts on narrow ints are ~5x faster than int64 merge sorts
        skey = sset.astype(np.int16) if self.n_sets <= (1 << 15) else sset
        order = np.argsort(skey, kind="stable")
        s_s = sset[order]
        t_s = tag[order]
        if self.cfg.ways == 2:
            hit_sorted = self._lookup2(s_s, t_s)
        else:
            hit_sorted = self._lookup_nway(s_s, t_s)
        out = np.empty(n, dtype=bool)
        out[order] = hit_sorted
        nh = int(hit_sorted.sum())
        self.hits += nh
        self.misses += n - nh
        return out

    def _lookup2(self, s_s: np.ndarray, t_s: np.ndarray) -> np.ndarray:
        """Closed form for 2-way LRU.  With duplicate runs collapsed, the
        per-set kept sequence is adjacent-distinct, so before kept access
        *i* the set contains exactly {kept[i-1], kept[i-2]} (carried as
        the per-set MRU/LRU tags across calls): a hit iff
        ``kept[i] == kept[i-2]``."""
        n = len(s_s)
        set_start = np.empty(n, dtype=bool)
        set_start[0] = True
        set_start[1:] = s_s[1:] != s_s[:-1]
        mru = self.tags[:, 1]
        lru2 = self.tags[:, 0]
        # collapse: duplicates of the previous access to the same set —
        # carried MRU at set boundaries
        prev1 = np.empty(n, dtype=np.int64)
        prev1[1:] = t_s[:-1]
        prev1[0] = -2
        prev1[set_start] = mru[s_s[set_start]]
        keep = t_s != prev1
        sk = s_s[keep]
        tk = t_s[keep]
        m = len(sk)
        if m == 0:
            # every access continues its set's MRU line: all hits
            return np.ones(n, dtype=bool)
        hit_k = np.zeros(m, dtype=bool)
        if m:
            kstart = np.empty(m, dtype=bool)
            kstart[0] = True
            kstart[1:] = sk[1:] != sk[:-1]
            ksecond = np.zeros(m, dtype=bool)
            ksecond[1:] = kstart[:-1] & ~kstart[1:]
            # two kept-accesses back, crossing into the carried state
            lag2 = np.empty(m, dtype=np.int64)
            lag2[2:] = tk[:-2]
            lag2[:2] = -2
            lag2[kstart] = lru2[sk[kstart]]
            lag2[ksecond] = mru[sk[ksecond]]
            hit_k = tk == lag2
            # update carried per-set state: last and second-to-last kept
            kend = np.empty(m, dtype=bool)
            kend[:-1] = kstart[1:]
            kend[-1] = True
            last_sets = sk[kend]
            only_one = kstart & kend
            prev_tag = np.empty(m, dtype=np.int64)
            prev_tag[1:] = tk[:-1]
            prev_tag[0] = -2
            new_lru2 = np.where(only_one[kend], mru[last_sets],
                                prev_tag[kend])
            self.tags[last_sets, 1] = tk[kend]
            self.tags[last_sets, 0] = new_lru2
            # keep the lru matrix consistent for mixed-path use: way 1 MRU
            self.lru[last_sets, 1] = 2
            self.lru[last_sets, 0] = 1
            self.ticks[last_sets] = 2
        idx_k = np.cumsum(keep) - 1
        return np.where(keep, hit_k[idx_k], True)

    # the recency-stack monoid lives in :mod:`repro_torch.core.engine` (shared
    # with the jitted backends); kept as methods for compatibility
    _lru_insert = staticmethod(_engine.lru_insert)
    _stack_compose = staticmethod(_engine.stack_compose)

    def _lookup_nway(self, s_s: np.ndarray, t_s: np.ndarray) -> np.ndarray:
        """Exact closed form for arbitrary associativity: the segmented
        distinct-line-distance scan (an access hits iff its LRU stack
        distance — the number of distinct lines in its set since the
        previous access to the same line — is below ``ways``).

        Per-set sequences are cut into segments of ``_SEG_W`` kept
        accesses.  Pass A replays every segment from an empty stack (a
        bounded ``_SEG_W``-round vectorized loop over *all* segments at
        once) to get each segment's own last-N-distinct stack; a segmented
        Hillis–Steele scan composes them (seeded with the carried cache
        state) into each segment's incoming stack; pass B replays again
        from the incoming stacks and records the hits.  Work is
        ``O(n · ways)`` with a Python loop bounded by ``2·_SEG_W + log``
        — independent of how accesses distribute over sets.
        """
        ways = self.cfg.ways
        W = self._SEG_W
        n = len(s_s)
        # narrow dtype when tags allow: the stack machinery is elementwise.
        # The carried tags from earlier lookups take part in the compares,
        # so the bound covers the whole history, not just this call.
        if len(t_s):
            self._max_tag = max(self._max_tag, int(t_s.max()))
        dtype = np.int32 if self._max_tag < (1 << 31) - 1 else np.int64
        # collapse runs of the same line within a set: all but the first
        # are hits on the MRU way and do not change the replacement order.
        keep = np.empty(n, dtype=bool)
        keep[0] = True
        keep[1:] = (s_s[1:] != s_s[:-1]) | (t_s[1:] != t_s[:-1])
        sk = s_s[keep]
        tk = t_s[keep].astype(dtype)
        m = len(sk)
        set_start = np.empty(m, dtype=bool)
        set_start[0] = True
        set_start[1:] = sk[1:] != sk[:-1]
        start_idx = np.nonzero(set_start)[0].astype(np.int64)
        grp = np.cumsum(set_start, dtype=np.int32) - 1
        pos = np.arange(m, dtype=np.int64) - start_idx[grp]
        touched = sk[set_start]
        # segments: every set boundary and every _SEG_W kept accesses
        seg_start = set_start | (pos & (W - 1) == 0)
        seg_id = np.cumsum(seg_start, dtype=np.int32) - 1
        G = int(seg_id[-1]) + 1
        pos_in_seg = (pos & (W - 1)).astype(np.int32)
        seg_grp = grp[seg_start]          # touched-set index per segment
        seg_first = set_start[seg_start]  # first segment of its set?
        T = np.full((W, G), -2, dtype=dtype)
        T[pos_in_seg, seg_id] = tk
        # carried cache state as recency stacks (MRU first, empties last;
        # per-set ticks are distinct for valid ways, 0 for empty ones)
        order = np.argsort(-self.lru[touched], axis=1, kind="stable")
        carried = np.take_along_axis(self.tags[touched], order, axis=1)
        carried = carried.astype(dtype)
        seg_len = np.diff(np.append(np.nonzero(seg_first)[0], G))
        max_run = int(seg_len.max(initial=1))
        # pass A (own stacks from empty), the segmented compose scan and
        # pass B (hit replay) run on the selected engine — numpy or the
        # torch core, bit-identical by construction
        HIT, stk = _engine.nway_core(T, seg_grp, seg_first, carried,
                                     max_run)
        # write back carried state from each set's last segment: slot k of
        # the stack goes to way k with lru ways−k (MRU way has the highest
        # tick; empty slots get tag −1 / lru 0, matching the scalar init)
        last_seg = np.empty(G, dtype=bool)
        last_seg[:-1] = seg_grp[1:] != seg_grp[:-1]
        last_seg[-1] = True
        final = stk[last_seg].astype(np.int64)
        valid = final >= 0
        self.tags[touched] = np.where(valid, final, -1)
        self.lru[touched] = np.where(valid, ways - np.arange(ways), 0)
        self.ticks[touched] = ways
        hit_k = HIT[pos_in_seg, seg_id]
        idx_k = np.cumsum(keep, dtype=np.int32) - 1
        return np.where(keep, hit_k[idx_k], True)

    # -- state transport (chunk-graph executor / rescache resume) ---------

    def export_stacks(self) -> tuple[np.ndarray, int]:
        """Canonical snapshot of the replacement state: per-set recency
        stacks (``(n_sets, ways)`` int64, MRU first, −1 empty) plus the
        largest tag ever observed.  ``import_stacks`` on a fresh sim of
        the same geometry restores behaviour exactly — the pair is the
        state-handoff payload of the sharded resolver and the resume
        record of the rescache."""
        order = np.argsort(-self.lru, axis=1, kind="stable")
        stk = np.take_along_axis(self.tags, order, axis=1)
        return np.ascontiguousarray(stk), self._max_tag

    def import_stacks(self, stacks: np.ndarray, max_tag: int) -> None:
        """Install a snapshot produced by :meth:`export_stacks` (layout
        follows the per-associativity closed forms: 2-way keeps the MRU
        tag in way 1, the N-way scan in way 0)."""
        ways = self.cfg.ways
        stacks = np.asarray(stacks, dtype=np.int64)
        valid = stacks >= 0
        if ways == 2:
            self.tags[:, 1] = stacks[:, 0]
            self.tags[:, 0] = stacks[:, 1]
            self.lru[:, 1] = np.where(valid[:, 0], 2, 0)
            self.lru[:, 0] = np.where(valid[:, 1], 1, 0)
        else:
            self.tags[:] = np.where(valid, stacks, -1)
            self.lru[:] = np.where(valid, ways - np.arange(ways), 0)
        self.ticks[:] = ways
        self._max_tag = max(self._max_tag, int(max_tag))

    # -- fused effect + replay (the chunk-graph's single-pass phase) ------

    def fused_lookup(self, addrs: np.ndarray,
                     ) -> tuple[np.ndarray, "_FusedAmb"]:
        """From-empty lookup that additionally captures the *boundary
        ambiguity table* — everything needed to finalize the exact hit
        flags later against ANY incoming cache state without replaying.

        The insight: in a from-empty replay, an access's verdict can
        only depend on state older than the chunk if it is a **first
        touch** (first in-chunk access to its line) whose in-chunk
        distinct-line prefix is still shorter than the associativity.
        While a set has seen fewer than ``ways`` misses no eviction has
        happened, so every miss *is* such a first touch and its miss
        rank *is* its distinct-prefix length — the table is just the
        first ``ways`` misses per set, ≤ ``n_sets × ways`` entries.
        Every other access's verdict is already exact
        (:func:`_resolve_fused` proves the patch rule).

        Must be called on a fresh sim; returns ``(hit_flags, amb)``
        where ``hit_flags`` is exact for an empty incoming state and
        ``amb`` feeds :func:`_resolve_fused`.  The sim itself ends in
        the chunk's *own-effect* state (``export_stacks`` gives the
        monoid payload), which is what fuses phase A into this pass.
        """
        n = len(addrs)
        ways = self.cfg.ways
        if n == 0:
            return np.zeros(0, dtype=bool), _EMPTY_AMB
        lb, ns = self.cfg.line_bytes, self.n_sets
        if lb & (lb - 1) == 0 and ns & (ns - 1) == 0:
            line = addrs >> lb.bit_length() - 1
            if n and int(line[-1] | line[0]) < (1 << 31) - 1 \
                    and int(line.max()) < (1 << 31) - 1:
                line = line.astype(np.int32)
            sset = line & (ns - 1)
            tag = line >> ns.bit_length() - 1
        else:
            line = addrs // lb
            sset = line % ns
            tag = line // ns
        skey = sset.astype(np.int16) if ns <= (1 << 15) else sset
        order = np.argsort(skey, kind="stable")
        s_s = sset[order]
        t_s = tag[order]
        if ways == 2:
            hit_sorted = self._lookup2(s_s, t_s)
        else:
            hit_sorted = self._lookup_nway(s_s, t_s)
        # per-set miss ranks (segmented cumsum over the sorted stream)
        m = len(s_s)
        set_start = np.empty(m, dtype=bool)
        set_start[0] = True
        set_start[1:] = s_s[1:] != s_s[:-1]
        miss = ~hit_sorted
        cs = np.cumsum(miss)
        start_idx = np.nonzero(set_start)[0]
        grp = np.cumsum(set_start) - 1
        before = (cs[start_idx] - miss[start_idx])[grp]
        j = cs - 1 - before
        amb_m = miss & (j < ways)
        a_pos = np.nonzero(amb_m)[0]
        a_set = s_s[a_pos].astype(np.int64)
        a_tag = t_s[a_pos].astype(np.int64)
        a_j = j[a_pos].astype(np.int64)
        sets_u, row = np.unique(a_set, return_inverse=True)
        F = np.full((len(sets_u), ways), -1, dtype=np.int64)
        F[row, a_j] = a_tag
        amb = _FusedAmb(order[a_pos], a_set, a_tag, a_j, row, F)
        out = np.empty(n, dtype=bool)
        out[order] = hit_sorted
        nh = int(hit_sorted.sum())
        self.hits += nh
        self.misses += n - nh
        return out, amb


class _FusedAmb:
    """The boundary-ambiguity table of :meth:`BatchedCacheSim.
    fused_lookup`: per entry the original stream position, set, tag,
    in-chunk distinct-prefix length ``j``, and a row into ``F`` — the
    per-ambiguous-set matrix whose row holds that set's first-touch
    tags in first-touch order (−1 padded)."""

    __slots__ = ("idx", "sets", "tag", "j", "row", "F")

    def __init__(self, idx, sets, tag, j, row, F):
        self.idx = idx
        self.sets = sets
        self.tag = tag
        self.j = j
        self.row = row
        self.F = F


_EMPTY_AMB = _FusedAmb(*(np.zeros(0, dtype=np.int64),) * 5,
                       np.zeros((0, 1), dtype=np.int64))


def _resolve_fused(amb: _FusedAmb, stacks: np.ndarray,
                   ways: int) -> np.ndarray:
    """Exact hit verdicts for the ambiguity table under an incoming
    state (an ``export_stacks`` snapshot).

    For an entry (set s, tag x, prefix length j): the distinct lines
    between the chunk start and this access are exactly the set's first
    ``j`` first-touch tags ``S``; x's LRU stack distance is then
    ``j + p − |incoming[:p] ∩ S|`` where ``p`` is x's slot in the
    incoming stack (absent ⇒ distance ≥ ways either way, a miss) —
    duplicated lines are counted once, everything else is disjoint by
    first-touch-ness.  Hit iff the distance is below ``ways``.
    """
    if len(amb.idx) == 0:
        return np.zeros(0, dtype=bool)
    inc = np.asarray(stacks, dtype=np.int64)[amb.sets]
    eq = inc == amb.tag[:, None]
    found = eq.any(axis=1)
    p = np.argmax(eq, axis=1)
    FS = amb.F[amb.row]
    w = np.arange(ways)
    memb = (inc[:, :, None] == FS[:, None, :]) \
        & (w[None, None, :] < amb.j[:, None, None])
    overlap = (memb.any(axis=2) & (w[None, :] < p[:, None])).sum(axis=1)
    dist = amb.j + p - overlap
    return found & (dist < ways)


def compose_stacks(older: np.ndarray, newer: np.ndarray) -> np.ndarray:
    """Compose two :meth:`BatchedCacheSim.export_stacks` snapshots: the
    state after running the accesses summarized by ``older`` and then
    those summarized by ``newer``.  The per-set "last N distinct lines"
    monoid is associative, so a chunk's *own* effect (its snapshot when
    replayed from an empty cache) composes onto any incoming state —
    this is how the sharded resolver derives every chunk's incoming
    cache state from per-chunk effects computed in parallel."""
    return BatchedCacheSim._stack_compose(older, newer)


@dataclasses.dataclass
class MemoryModel:
    """Port + optional cache.  Latencies in accelerator clock cycles.

    Defaults follow the Zynq-7000 numbers used in §V discussion: ACP hits
    the PS L2 (~25 cycles at ~150 MHz), HP goes straight to the DDR
    controller (~40 cycles); a miss that must go to DRAM costs ~65 cycles.
    """

    name: str = "ACP"
    port_latency: int = 25          # cycles to backing store on cache miss
    dram_latency: int = 65          # cycles when backing store misses too
    backing_hit_rate: float = 0.35  # chance the PS-side cache holds the line
    words_per_cycle: float = 1.0    # port bandwidth (32-bit words / cycle)
    max_outstanding: int = 8        # in-flight requests (decoupled mode)
    #: Posted writes (the AXI default): a store's latency never sits on
    #: the pipeline's data path — it still occupies an outstanding-request
    #: slot (throughput) and, in the conventional engine, never stalls the
    #: static schedule.  ``False`` restores the old stores-share-the-load-
    #: path behaviour.
    posted_writes: bool = True
    #: Finite posted-write buffer depth.  ``None`` keeps the historical
    #: model: an infinite write buffer, so posted stores are only bounded
    #: by ``max_outstanding`` like loads.  A finite depth ``B`` means at
    #: most ``B`` posted stores can be in flight: a full buffer pushes
    #: back through the outstanding-request cap — the effective in-flight
    #: limit for posted stores becomes ``min(max_outstanding, B)``, so a
    #: stage whose slowest posted store takes ``al`` cycles sustains at
    #: most one iteration per ``ceil(al / min(max_outstanding, B))``
    #: cycles.  Fold-only: never part of the resolution-cache key, and
    #: irrelevant when ``posted_writes=False`` (blocking stores behave
    #: like loads — there is no write buffer to fill).
    store_buffer_depth: int | None = None
    cache: CacheConfig | None = None

    @property
    def line_bytes(self) -> int:
        """Burst granularity: the on-PL cache line if present, else the
        port's native burst length."""
        return self.cache.line_bytes if self.cache else DEFAULT_LINE_BYTES

    def make_state(self) -> "MemoryState":
        return MemoryState(self, CacheSim(self.cache) if self.cache else None,
                           np.random.default_rng(0))


@dataclasses.dataclass
class MemoryState:
    """Scalar per-access view of the memory subsystem (the scalar
    *reference* paths' memory system; the vectorized engines — and the
    Fig. 2 Gantt/schedule capture too — resolve whole
    traces at once through the resolution layer instead)."""

    model: MemoryModel
    cache: CacheSim | None
    rng: np.random.Generator

    def access_latency(self, addr: int, *, is_store: bool = False) -> int:
        m = self.model
        if self.cache is not None and (
                not is_store or self.cache.cfg.write_allocate):
            if self.cache.access(addr):
                return self.cache.cfg.hit_cycles
        # write-around stores (write_allocate=False) bypass the cache and
        # always pay the backing trip; loads pay it on a miss
        if m.backing_hit_rate <= 0.0:
            return m.dram_latency  # deterministic: no draw consumed
        if self.rng.random() < m.backing_hit_rate:
            return m.port_latency
        return m.dram_latency


#: §V memory configurations
def acp() -> MemoryModel:
    return MemoryModel(name="ACP", port_latency=25, dram_latency=65,
                       backing_hit_rate=0.35)


def hp() -> MemoryModel:
    # HP bypasses the PS cache: every access pays the controller trip.
    return MemoryModel(name="HP", port_latency=40, dram_latency=70,
                       backing_hit_rate=0.0)


def acp_cache(size_kb: int = 64) -> MemoryModel:
    m = acp()
    m.name = f"ACP+{size_kb}KB"
    m.cache = CacheConfig(size_bytes=size_kb * 1024)
    return m


def hp_cache(size_kb: int = 64) -> MemoryModel:
    m = hp()
    m.name = f"HP+{size_kb}KB"
    m.cache = CacheConfig(size_bytes=size_kb * 1024)
    return m


def standard_memory_models() -> dict[str, Callable[[], MemoryModel]]:
    """The four §V memory configurations, by name (fresh model per call)."""
    return {"ACP": acp, "ACP+64KB": acp_cache, "HP": hp, "HP+64KB": hp_cache}


# ---------------------------------------------------------------------------
# Workload description
# ---------------------------------------------------------------------------

def _burst_mask(a: np.ndarray, prev: np.ndarray,
                line_bytes: int) -> np.ndarray:
    """§III-B2 burst continuation: an access stays within one line of its
    predecessor (ascending or descending sweeps both stream).  The single
    definition shared by :meth:`MemAccess.window` (the scalar reference's
    view) and :class:`_SharedResolver` (the vectorized engines')."""
    return (a >= 0) & (prev >= 0) & (np.abs(a - prev) <= line_bytes)


@dataclasses.dataclass
class MemAccess:
    """One memory access per iteration: ``addrs[i]`` is the **byte** address
    the stage touches at iteration ``i`` (−1 = no access this iteration).

    Long traces can be supplied as a window generator instead of a
    materialized array: ``gen(lo, hi)`` must return ``addrs[lo:hi]`` for
    any ``0 <= lo <= hi <= length`` (pure in its arguments), which lets
    full Table-I iteration counts stream through the simulator in chunks.

    §III-B2: consecutive accesses are converted to bursts.  An access is a
    *burst continuation* when it stays within one line of its predecessor
    (``|addr[i] - addr[i-1]| <= line_bytes``, ascending or descending
    sweeps both stream) — the dataflow engine streams these at port
    bandwidth instead of paying per-access latency.  The threshold is the
    memory model's line size (the old hard-coded 64 matched neither the
    32-byte lines nor the word unit), so the mask is computed per model
    via :meth:`window`.
    """

    region: str
    addrs: np.ndarray | None = None
    is_store: bool = False
    gen: Callable[[int, int], np.ndarray] | None = None
    length: int | None = None
    #: burst words transferred per access (>1 for a coalesced access —
    #: the transform catalog merges U adjacent unrolled sub-accesses
    #: into one ``width=U`` op).  Fold-only under the rescache v3 key
    #: contract: latency draws are per *request* and identical addresses
    #: draw identical latencies regardless of width, so ``width`` scales
    #: bandwidth in the fold (like ``words_per_cycle``) and never keys.
    width: int = 1

    def __post_init__(self):
        if self.addrs is not None:
            # canonicalize once: int64 byte addresses, assigned back so all
            # consumers (and __len__/window) see the same array.
            self.addrs = np.ascontiguousarray(
                np.asarray(self.addrs, dtype=np.int64))
            if self.addrs.ndim != 1:
                raise ValueError("MemAccess.addrs must be 1-D")
            self.length = len(self.addrs)
        elif self.gen is None or self.length is None:
            raise ValueError("MemAccess needs either addrs or (gen, length)")

    def __len__(self) -> int:
        return int(self.length)

    def _raw_window(self, lo: int, hi: int) -> np.ndarray:
        """addrs[lo:hi], padded with −1 past the end of the trace."""
        n = hi - lo
        valid_hi = min(hi, self.length)
        if lo >= valid_hi:
            return np.full(n, -1, dtype=np.int64)
        if self.addrs is not None:
            body = self.addrs[lo:valid_hi]
        else:
            body = np.asarray(self.gen(lo, valid_hi), dtype=np.int64)
        if valid_hi < hi:
            body = np.concatenate(
                [body, np.full(hi - valid_hi, -1, dtype=np.int64)])
        return body

    def window(self, lo: int, hi: int,
               line_bytes: int = DEFAULT_LINE_BYTES,
               ) -> tuple[np.ndarray, np.ndarray]:
        """(byte addresses, burst-continuation mask) for iterations
        [lo, hi); the mask for the window's first element looks back at
        ``addrs[lo-1]`` so chunking does not split bursts."""
        a = self._raw_window(lo, hi)
        prev = np.empty_like(a)
        prev[1:] = a[:-1]
        prev[0] = self._raw_window(lo - 1, lo)[0] if lo > 0 else -1
        return a, _burst_mask(a, prev, line_bytes)

    @property
    def sequential(self) -> np.ndarray:
        """Burst mask for the whole (materialized) trace at the default
        line size — retained for ad-hoc consumers."""
        if self.addrs is None:
            raise ValueError("sequential mask of a generated trace: use "
                             "window(lo, hi, line_bytes) instead")
        return self.window(0, self.length)[1]


@dataclasses.dataclass
class SimStage:
    """A pipeline stage, as produced by the partitioner.

    ``ii``: initiation interval from in-stage dependence cycles (SCC latency).
    ``latency``: input→output latency of the stage body.
    ``accesses``: memory traffic issued by this stage each iteration.
    ``mem_in_scc``: the DFS pathology — the access sits on the loop-carried
    cycle, so its full latency serializes into the II (no decoupling).
    """

    name: str
    ii: int
    latency: int
    accesses: list[MemAccess] = dataclasses.field(default_factory=list)
    mem_in_scc: bool = False


STALL_BUCKETS = ("ii", "upstream", "fifo", "memory")


@dataclasses.dataclass
class SimResult:
    """One machine-model run.

    ``stage_stall_cycles[stage][bucket]`` attributes every cycle a stage
    spends not firing to exactly one cause:

    * ``ii``       — the stage's own initiation interval (``ii - 1`` per
      steady iteration);
    * ``memory``   — memory throughput beyond the II: the in-flight cap
      (``ceil(latency / max_outstanding)``), burst bandwidth, and — for
      ``mem_in_scc`` stages — serialized access latency;
    * ``upstream`` — waiting for the producer stage's value (FIFO empty);
    * ``fifo``     — backpressure from a full downstream FIFO.

    The buckets partition each stage's idle time, so per stage
    ``sum(buckets) <= cycles`` (the old accounting summed producer waits
    into every downstream stage and double-counted the ``mem_in_scc``
    path, adding up to a multiple of total cycles).
    """

    name: str
    cycles: int
    iters: int
    freq_mhz: float
    stage_stall_cycles: dict[str, dict[str, int]]
    cache_hits: int = 0
    cache_misses: int = 0

    @property
    def cycles_per_iter(self) -> float:
        return self.cycles / max(1, self.iters)

    @property
    def runtime_s(self) -> float:
        return self.cycles / (self.freq_mhz * 1e6)

    def scaled_runtime(self, total_iters: int) -> float:
        """Steady-state extrapolation to ``total_iters`` (the pre-sweep
        harness used this; the Fig. 5 runs now simulate full sizes)."""
        return self.cycles_per_iter * total_iters / (self.freq_mhz * 1e6)

    def total_stalls(self) -> dict[str, int]:
        """Bucket totals summed over stages."""
        out = dict.fromkeys(STALL_BUCKETS, 0)
        for buckets in self.stage_stall_cycles.values():
            for k, v in buckets.items():
                out[k] = out.get(k, 0) + v
        return out


# ---------------------------------------------------------------------------
# Trace resolution (shared by the vectorized and reference paths)
# ---------------------------------------------------------------------------

def _ceil_div(a: np.ndarray | int, b: int) -> np.ndarray | int:
    if isinstance(a, np.ndarray) and b & (b - 1) == 0:
        return (a + (b - 1)) >> (b.bit_length() - 1)  # 5x over int //
    return (a + b - 1) // b


@dataclasses.dataclass
class _ResolvedChunk:
    """Per-stage arrays for iterations [lo, hi): everything the recurrence
    needs, with no memory-system state left."""

    lo: int
    hi: int
    c: list[np.ndarray]        # per-stage iteration increment (int32[n])
    lat_add: list[np.ndarray]  # per-stage extra finish latency (int32[n])


def _backing_latencies(mem: MemoryModel, rng: np.random.Generator,
                       count: int) -> np.ndarray:
    """One backing-store draw per access reaching past the on-PL cache
    (none consumed when the backing hit rate is 0, matching the scalar
    path draw-for-draw)."""
    if mem.backing_hit_rate <= 0.0:
        return np.full(count, mem.dram_latency, dtype=np.int32)
    u = rng.random(count)
    return np.where(u < mem.backing_hit_rate,
                    np.int32(mem.port_latency),
                    np.int32(mem.dram_latency))


def _stall_from_latencies(mem: MemoryModel, lat: np.ndarray,
                          counted: np.ndarray | None,
                          static_overlap: int) -> int:
    """Static-engine stall cycles from resolved per-access latencies:
    every counted access stalls ``max(latency − assumed, 0) //
    static_overlap`` cycles, where the schedule's assumed latency is the
    cache hit time (or 1 without a cache) — exactly the scalar
    conventional reference's accounting.  This is the single fold the
    live capture path and the chunk-record serve path share, so serving
    a stored conventional artifact is bit-identical to resolving it."""
    v = lat if counted is None else lat[counted]
    if not len(v):
        return 0
    assumed = mem.cache.hit_cycles if mem.cache else 1
    s = np.maximum(v.astype(np.int64) - assumed, 0) // static_overlap
    return int(s.sum())


def _lat_itemsize(mem: MemoryModel) -> int:
    """Bytes per stored latency after :func:`rescache.shrink_ops`
    (resolved latencies are bounded by the model's worst trip) — sizes
    the chunk writer's stored-prefix budget."""
    ml = max(mem.port_latency, mem.dram_latency,
             mem.cache.hit_cycles if mem.cache else 0)
    return 1 if ml < 128 else (2 if ml < (1 << 15) else 4)


def _cache_group_key(mem: MemoryModel) -> tuple | None:
    """Memory models with identical on-PL cache geometry (and the same
    burst granularity, which decides which accesses reach the cache) see
    the *same* hit/miss stream — one :class:`BatchedCacheSim` serves all
    of them."""
    if mem.cache is None:
        return None
    c = mem.cache
    return (c.size_bytes, c.line_bytes, c.ways, c.hit_cycles,
            c.write_allocate, mem.line_bytes)


def _fold_stage(mem: MemoryModel, ii: int, mem_in_scc: bool,
                cols: Sequence[int], col: Callable[[int], np.ndarray],
                bw: np.ndarray | None, is_store: np.ndarray,
                n: int, zero: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """One stage's ``(c, lat_add)`` arrays from per-op latency columns
    (``col(k)`` returns op ``k``'s contiguous latency column).  Pure in
    its arguments, so DSE candidate evaluation caches the result per
    distinct ``(op set, ii, serialized)`` stage across candidates."""
    if not cols:
        return np.full(n, ii, dtype=np.int32), zero
    if mem_in_scc:
        # DFS pathology: every access's latency serializes into
        # the II (posted or not — it sits on the dependence cycle)
        c = col(cols[0]).copy()
        for c_ in cols[1:]:
            c += col(c_)
        c += np.int32(ii)
        return c, zero
    def _colmax(cs: Sequence[int]) -> np.ndarray:
        if len(cs) == 1:
            return col(cs[0])
        m = np.maximum(col(cs[0]), col(cs[1]))
        for c_ in cs[2:]:
            np.maximum(m, col(c_), out=m)
        return m

    # in-flight caps: loads (and blocking stores) pipeline up to
    # max_outstanding requests; posted stores additionally queue in the
    # write buffer, so a finite store_buffer_depth tightens their cap to
    # min(max_outstanding, depth) — a full buffer pushes back.
    store_cap = mem.max_outstanding
    if mem.posted_writes and mem.store_buffer_depth is not None:
        store_cap = max(1, min(mem.max_outstanding,
                               mem.store_buffer_depth))
    split = store_cap != mem.max_outstanding \
        and any(is_store[c_] for c_ in cols)
    load_cols = [c_ for c_ in cols
                 if not is_store[c_] or not mem.posted_writes]
    if split:
        st_cols = [c_ for c_ in cols if is_store[c_]]
        ld_cols = [c_ for c_ in cols if not is_store[c_]]
        c = _ceil_div(_colmax(st_cols), store_cap)
        if ld_cols:
            np.maximum(c, _ceil_div(_colmax(ld_cols),
                                    mem.max_outstanding), out=c)
        al_sp = None
    else:
        # one cap for everything: a stage whose limiting access takes
        # al cycles sustains one iteration per ceil(al / cap) cycles
        al_sp = _colmax(cols)
        c = _ceil_div(al_sp, mem.max_outstanding)
    if len(load_cols) == len(cols) and al_sp is not None:
        al_lat = al_sp
    elif not load_cols:
        al_lat = zero
    else:
        al_lat = _colmax(load_cols)
    burst_word_cycles = int(np.ceil(1.0 / mem.words_per_cycle))
    if burst_word_cycles != 1:
        bw = bw * np.int32(burst_word_cycles)
    np.maximum(c, bw, out=c)
    np.maximum(c, np.int32(ii), out=c)
    return (c.astype(np.int32, copy=False),
            al_lat.astype(np.int32, copy=False))


class _OpFolder:
    """Stage-independent access layout plus the per-op → per-stage fold.

    Resolution products are keyed and stored **per memory op** (the
    iteration-major stream of per-access latencies; see
    :func:`repro_torch.core.rescache.resolution_key`), not per stage: the fold
    from per-op latencies into per-stage ``(c, lat_add)`` arrays — II,
    in-flight cap, burst bandwidth, posted stores — is cheap and purely
    local, so candidate partitions of one kernel that merely regroup the
    same memory ops (the DSE explorer) share one resolved artifact.  The
    folder recomputes address windows and burst masks per chunk (cheap,
    no memory-system state) and performs that fold; the live resolver
    (:class:`_SharedResolver`) subclasses it, so a mixed served/live grid
    shares the per-chunk windows too.
    """

    def __init__(self, stages: Sequence[SimStage]):
        _tune_malloc()
        self.stages = list(stages)
        self.accs = [(s, acc) for s, st in enumerate(self.stages)
                     for acc in st.accesses]
        self.K = len(self.accs)
        self.is_store = np.array([acc.is_store for _, acc in self.accs],
                                 dtype=bool)
        self.stage_cols: list[list[int]] = [[] for _ in self.stages]
        for col, (s, _) in enumerate(self.accs):
            self.stage_cols[s].append(col)
        #: single-slot memos: the grid loop visits chunks in order, and all
        #: lanes of one chunk share the windows / burst masks
        self._chunk_key: tuple | None = None
        self._chunk_val: tuple | None = None
        self._bw_key: tuple | None = None
        self._bw_val: list | None = None

    def _windows(self, lo: int, hi: int) -> dict:
        """Raw address windows for [lo−1, hi), memoized per trace source
        so accesses sharing an array/generator (e.g. a load and a store
        of the same region) are windowed once.  A single-slot memo on
        the :class:`MemAccess` object itself carries the window *across*
        folder instances: consecutive candidate evaluations of a DSE run
        (one folder each, identical chunk boundaries) regenerate nothing
        — only the memory-system replay is per-configuration work."""
        memo: dict[tuple, np.ndarray] = {}
        out = {}
        for idx, (_, acc) in enumerate(self.accs):
            src = id(acc.addrs) if acc.addrs is not None else id(acc.gen)
            key = (src, len(acc))
            if key not in memo:
                slot = acc.__dict__.get("_win_memo")
                if slot is not None and slot[0] == (lo, hi):
                    memo[key] = slot[1]
                else:
                    if lo > 0:
                        ext = acc._raw_window(lo - 1, hi)
                    else:
                        ext = np.empty(hi - lo + 1, dtype=np.int64)
                        ext[1:] = acc._raw_window(lo, hi)
                        ext[0] = -1
                    acc.__dict__["_win_memo"] = ((lo, hi), ext)
                    memo[key] = ext
            out[idx] = memo[key]
        return out

    def _burst_col(self, col: int, ext: dict, lo: int, hi: int,
                   line_bytes: int) -> np.ndarray:
        """One op's burst-continuation mask — pure in (trace, window,
        line size), memoized on the MemAccess like the window itself so
        sibling folders (DSE candidates, the schedule path) share it."""
        acc = self.accs[col][1]
        slot = acc.__dict__.get("_burst_memo")
        if slot is not None and slot[0] == (lo, hi, line_bytes):
            return slot[1]
        e = ext[col]
        m = _burst_mask(e[1:], e[:-1], line_bytes)
        acc.__dict__["_burst_memo"] = ((lo, hi, line_bytes), m)
        return m

    def burst_words(self, lo: int, hi: int,
                    line_bytes: int) -> list[np.ndarray | None]:
        """Lane-independent per-stage burst word counts for [lo, hi) —
        the only chunk product the serve-path fold needs (no address
        matrix, no participation mask)."""
        ck = (lo, hi, line_bytes)
        if self._bw_key == ck:
            return self._bw_val
        ext = self._windows(lo, hi)
        out: list[np.ndarray | None] = [None] * len(self.stages)
        for s, cols in enumerate(self.stage_cols):
            if not cols or self.stages[s].mem_in_scc:
                continue
            bw: np.ndarray | None = None
            for c_ in cols:
                m = self._burst_col(c_, ext, lo, hi, line_bytes)
                w = int(getattr(self.accs[c_][1], "width", 1) or 1)
                if w == 1:
                    contrib = m.astype(np.int32)
                else:
                    # a width-w (coalesced) access moves w words: burst
                    # continuations stream all w, while a leading access
                    # pays latency for its first word and streams w−1
                    valid = ext[c_][1:] >= 0
                    contrib = m.astype(np.int32) * np.int32(w) \
                        + (valid & ~m).astype(np.int32) * np.int32(w - 1)
                bw = contrib if bw is None else bw + contrib
            out[s] = bw
        self._bw_key = ck
        self._bw_val = out
        return out

    def chunk_arrays(self, lo: int, hi: int, line_bytes: int,
                     conventional: bool = False) -> tuple:
        """``(A, burst, participates, burst_words)`` for iterations
        [lo, hi): the address matrix, the burst-continuation mask (None
        for the conventional engine, which resolves every access), the
        participation mask, and the lane-independent per-stage burst word
        counts.  Memoized for the current chunk."""
        ck = (lo, hi, line_bytes, conventional)
        if self._chunk_key == ck:
            return self._chunk_val
        n = hi - lo
        K = self.K
        ext = self._windows(lo, hi)
        A = np.empty((n, max(K, 1)), dtype=np.int64)
        if K == 0:
            A[:] = -1
        burst = None if conventional \
            else np.zeros((n, max(K, 1)), dtype=bool)
        for col, (s, _) in enumerate(self.accs):
            e = ext[col]
            A[:, col] = e[1:]
            if burst is not None and not self.stages[s].mem_in_scc:
                burst[:, col] = self._burst_col(col, ext, lo, hi,
                                                line_bytes)

        if burst is None:
            participates = (A >= 0)
        else:
            participates = (A >= 0) & ~burst

        bw = None if burst is None else self.burst_words(lo, hi,
                                                         line_bytes)
        self._chunk_key = ck
        self._chunk_val = (A, burst, participates, bw)
        return self._chunk_val

    def fold(self, mem: MemoryModel, lo: int, hi: int,
             L: np.ndarray) -> _ResolvedChunk:
        """Fold a per-op latency matrix ``L`` (``(hi-lo, K)`` int32, zero
        where an op does not participate — the rescache artifact layout)
        into the per-stage :class:`_ResolvedChunk` for ``mem``."""
        with _engine.phase("fold"):
            return self._fold(mem, lo, hi, L,
                              self.burst_words(lo, hi, mem.line_bytes))

    def _fold(self, mem: MemoryModel, lo: int, hi: int,
              L: np.ndarray,
              burst_words: list[np.ndarray | None]) -> _ResolvedChunk:
        """Fold per-access latencies into per-stage (c, lat_add):
        ``c`` bounds the stage's issue rate (II, the in-flight cap
        ``ceil(al / max_outstanding)``, burst bandwidth, serialized SCC
        latency); ``lat_add`` is the data-path latency added to the
        stage's finish (posted stores never contribute here)."""
        n = hi - lo
        # contiguous per-column views: the fold's elementwise ops are ~2x
        # faster on contiguous data than on strided column slices
        cols_cache: dict[int, np.ndarray] = {}

        def col(c_: int) -> np.ndarray:
            a = cols_cache.get(c_)
            if a is None:
                a = cols_cache[c_] = np.ascontiguousarray(L[:, c_])
            return a

        c_list: list[np.ndarray] = []
        lat_list: list[np.ndarray] = []
        zero = np.zeros(n, dtype=np.int32)
        for s, (st, cols) in enumerate(zip(self.stages, self.stage_cols)):
            c, lat = _fold_stage(mem, st.ii, st.mem_in_scc, cols, col,
                                 burst_words[s], self.is_store, n, zero)
            c_list.append(c)
            lat_list.append(lat)
        return _ResolvedChunk(lo, hi, c_list, lat_list)


class _SharedResolver(_OpFolder):
    """The shared per-chunk resolution pipeline of the multi-lane engine.

    One instance resolves the address traces of ``stages`` for *several*
    memory models at once, visiting each memory system in the canonical
    interleaved order (iteration-major, then stage, then access — the
    order a scalar per-cycle loop issues them).  Work is layered so
    everything that does not depend on the full memory model is computed
    once per chunk and shared:

    * address windows + burst masks — per distinct ``line_bytes``
      (traces that share a generator/array are windowed once);
    * the participation mask (valid, non-burst accesses) — per
      ``line_bytes``;
    * the on-PL cache simulation — per distinct cache geometry
      (:func:`_cache_group_key`), so e.g. ACP+64KB and HP+64KB replay
      the cache once;
    * the backing-store draws and the fold into per-stage ``(c,
      lat_add)`` arrays — per memory model (each model keeps its own
      seeded RNG, so results are draw-for-draw identical to a
      stand-alone run).

    Burst continuations of non-``mem_in_scc`` stages stream at port
    bandwidth — they never reach the cache or backing store (§III-B2);
    the conventional engine resolves every access instead
    (``conventional=True``).

    After each :meth:`resolve` the per-op latency matrices are kept in
    ``last_ops`` (one ``(n, K)`` int32 matrix per model) — the rescache
    artifact payload.
    """

    def __init__(self, stages: Sequence[SimStage],
                 mems: Mapping[str, MemoryModel], seed: int,
                 *, conventional: bool = False, capture: bool = False):
        super().__init__(stages)
        self.mems = dict(mems)
        self.conventional = conventional
        #: build the per-op hit/visit planes (and, for the conventional
        #: engine, the per-op latency matrices) the rescache chunk
        #: records store — off for cache-less throwaway runs
        self.capture = capture
        self.seed = seed
        self.rngs = {name: np.random.default_rng(seed) for name in mems}
        #: RNG doubles consumed so far per model — with the draw stream
        #: being position-exact, this *is* the RNG resume state (PCG64
        #: ``advance`` restores it without replaying draws)
        self.draws = {name: 0 for name in mems}
        self.caches: dict[tuple, BatchedCacheSim] = {}
        self.cache_keys: dict[str, tuple | None] = {}
        for name, mem in mems.items():
            key = _cache_group_key(mem)
            self.cache_keys[name] = key
            if key is not None and key not in self.caches:
                self.caches[key] = BatchedCacheSim(mem.cache)
        self.last_ops: dict[str, np.ndarray] = {}
        self.last_hits: dict[str, np.ndarray | None] = {}
        self.last_visits: dict[str, np.ndarray | None] = {}
        self._lat_flat: dict[str, np.ndarray] = {}

    # -- resume-state transport ------------------------------------------

    def export_resume(self, name: str) -> tuple[dict[str, np.ndarray],
                                                dict[str, int]]:
        """``(states, cum)`` for one model at the current stream
        position — the payload of a rescache resume record and of the
        sharded executor's state handoff."""
        states: dict[str, np.ndarray] = {}
        cum: dict[str, int] = {"draws": self.draws[name]}
        key = self.cache_keys[name]
        if key is not None:
            sim = self.caches[key]
            stk, mt = sim.export_stacks()
            states["cache"] = stk
            cum.update(hits=sim.hits, misses=sim.misses, max_tag=mt)
        return states, cum

    def import_resume(self, name: str, states: Mapping[str, np.ndarray],
                      cum: Mapping[str, int]) -> None:
        """Fast-forward one model's lane to a stored stream position:
        cache stacks installed, RNG advanced draw-for-draw."""
        key = self.cache_keys[name]
        if key is not None and "cache" in states:
            sim = self.caches[key]
            sim.import_stacks(states["cache"],
                              int(cum.get("max_tag", -1)))
            sim.hits = int(cum.get("hits", 0))
            sim.misses = int(cum.get("misses", 0))
        d = int(cum.get("draws", 0))
        delta = d - self.draws[name]
        if delta < 0:  # rewind: rebuild from the seed
            self.rngs[name] = np.random.default_rng(self.seed)
            delta = d
        if delta:
            self.rngs[name].bit_generator.advance(delta)
        self.draws[name] = d

    def cache_stats(self, name: str) -> tuple[int, int]:
        key = self.cache_keys[name]
        if key is None:
            return 0, 0
        sim = self.caches[key]
        return sim.hits, sim.misses

    def _flat_chunk(self, lo: int, hi: int) -> tuple:
        """``(addrs, store_flat, flat_p, burst_words)`` for one chunk —
        the flattened participating-access stream every phase (effect,
        replay, finish) visits in the same canonical order."""
        n = hi - lo
        K = self.K
        # burst masks per distinct line_bytes (normally just one value)
        line_sizes = sorted({m.line_bytes for m in self.mems.values()})
        if len(line_sizes) > 1:
            raise ValueError(
                "shared resolution requires a single burst granularity; "
                f"got line_bytes {line_sizes} — run the models separately")
        lb = line_sizes[0] if line_sizes else DEFAULT_LINE_BYTES
        A, _, participates, burst_words = self.chunk_arrays(
            lo, hi, lb, self.conventional)
        flat_p = participates.ravel()
        addrs = A.ravel()[flat_p]
        store_flat = np.broadcast_to(self.is_store,
                                     (n, max(K, 1))).ravel()[flat_p] \
            if K else np.zeros(0, dtype=bool)
        return addrs, store_flat, flat_p, burst_words

    def _geo_lookup(self, sim: BatchedCacheSim, key: tuple,
                    addrs: np.ndarray,
                    store_flat: np.ndarray) -> np.ndarray:
        """One geometry's hit flags for a chunk; write-around stores
        bypass the cache (never hit, never allocate)."""
        write_allocate = key[4]
        if write_allocate or not store_flat.any():
            return sim.lookup(addrs)
        cached = ~store_flat
        h = np.zeros(len(addrs), dtype=bool)
        h[cached] = sim.lookup(addrs[cached])
        return h

    def chunk_effects(self, lo: int, hi: int) -> tuple[dict, int]:
        """Phase A of the sharded executor: every geometry's *own*
        cache effect for this chunk — its recency-stack snapshot when
        replayed from an empty cache — plus the participating-access
        count.  Pure in (traces, chunk): needs no incoming state, so
        all chunks' effects compute in parallel and compose."""
        with _engine.phase("effect"):
            addrs, store_flat, _, _ = self._flat_chunk(lo, hi)
            effects = {}
            geo_cfg = {}
            for name, mem in self.mems.items():
                key = self.cache_keys[name]
                if key is not None:
                    geo_cfg.setdefault(key, mem.cache)
            for key, cfg in geo_cfg.items():
                sim = BatchedCacheSim(cfg)
                self._geo_lookup(sim, key, addrs, store_flat)
                effects[key] = sim.export_stacks()
            return effects, len(addrs)

    def chunk_effects_fused(self, lo: int, hi: int) -> tuple[dict, int]:
        """Phases A **and** B in one replay: each geometry replays the
        chunk once from an empty cache via
        :meth:`BatchedCacheSim.fused_lookup`, which yields the chunk's
        own effect (phase A's output) *and* hit flags plus a boundary
        ambiguity table that :meth:`finalize_replay` later patches
        against the composed incoming state — exact, with no second
        replay.  This is what makes 2-core sharding break even: the
        unfused executor paid two full cache replays per chunk."""
        with _engine.phase("replay"):
            addrs, store_flat, flat_p, burst_words = \
                self._flat_chunk(lo, hi)
            effects: dict = {}
            fused: dict = {}
            geo_cfg = {}
            for name, mem in self.mems.items():
                key = self.cache_keys[name]
                if key is not None:
                    geo_cfg.setdefault(key, mem.cache)
            for key, cfg in geo_cfg.items():
                sim = BatchedCacheSim(cfg)
                write_allocate = key[4]
                if write_allocate or not store_flat.any():
                    h, amb = sim.fused_lookup(addrs)
                    cached = None
                else:
                    cached = ~store_flat
                    h = np.zeros(len(addrs), dtype=bool)
                    h[cached], amb = sim.fused_lookup(addrs[cached])
                effects[key] = sim.export_stacks()
                fused[key] = (h, amb, cached)
            self._fused = (fused, effects)
            self._store_flat = store_flat
            self._flat_p = flat_p
            self._burst_words = burst_words
            self._n_addrs = len(addrs)
            return effects, len(addrs)

    def finalize_replay(self, state_map: Mapping | None,
                        ) -> dict[tuple, tuple[int, int, int]]:
        """Phase B after :meth:`chunk_effects_fused`: patch the fused
        pass's boundary-ambiguous verdicts against the incoming stacks
        (``state_map``: geometry key -> ``(stacks, max_tag)``, ``None``
        entries = empty cache), install each geometry's *outgoing*
        state (incoming ∘ own effect), and return the same per-geometry
        ``(hits, misses, backing_trips)`` deltas :meth:`replay`
        returns — bit-identical, without the second replay."""
        with _engine.phase("replay"):
            fused, effects = self._fused
            n_all = self._n_addrs
            hits_by_key: dict[tuple, np.ndarray] = {}
            deltas: dict[tuple, tuple[int, int, int]] = {}
            for key, sim in self.caches.items():
                h, amb, cached = fused[key]
                ways = sim.cfg.ways
                st = state_map.get(key) if state_map else None
                if st is not None and len(amb.idx):
                    fix = _resolve_fused(amb, st[0], ways)
                    if cached is None:
                        h[amb.idx] = fix
                    else:
                        idx_c = np.nonzero(cached)[0]
                        h[idx_c[amb.idx]] = fix
                own_stk, own_mt = effects[key]
                if st is None:
                    out_stk, out_mt = own_stk, own_mt
                else:
                    out_stk = compose_stacks(np.asarray(st[0],
                                                        dtype=np.int64),
                                             own_stk)
                    out_mt = max(int(st[1]), own_mt)
                sim.import_stacks(out_stk, out_mt)
                nh = int(h.sum())
                ncached = n_all if cached is None else int(cached.sum())
                deltas[key] = (nh, ncached - nh, n_all - nh)
                hits_by_key[key] = h
            self._hits_by_key = hits_by_key
            self._fused = None
            return deltas

    def replay(self, lo: int, hi: int) -> dict[tuple,
                                               tuple[int, int, int]]:
        """Cache replay for one chunk against the carried (or imported)
        state: stores the per-geometry hit flags for :meth:`finish` and
        returns each geometry's chunk-local ``(hits, misses,
        backing_trips)`` deltas.  ``backing_trips`` counts every access
        that reaches the backing store — cache misses *plus*
        write-around stores (which never enter the lookup but still
        draw) — i.e. exactly the RNG doubles :meth:`finish` will
        consume, which is what the sharded master's draw-offset scan
        must sum."""
        with _engine.phase("replay"):
            addrs, store_flat, flat_p, burst_words = \
                self._flat_chunk(lo, hi)
            hits_by_key: dict[tuple, np.ndarray] = {}
            deltas: dict[tuple, tuple[int, int, int]] = {}
            for key, sim in self.caches.items():
                h0, m0 = sim.hits, sim.misses
                h = self._geo_lookup(sim, key, addrs, store_flat)
                hits_by_key[key] = h
                deltas[key] = (sim.hits - h0, sim.misses - m0,
                               int(len(h) - h.sum()))
            self._store_flat = store_flat
            self._hits_by_key = hits_by_key
            self._n_addrs = len(addrs)
            self._flat_p = flat_p
            self._burst_words = burst_words
            return deltas

    def resolve(self, lo: int, hi: int) -> dict[str, _ResolvedChunk]:
        """Resolved per-stage ``(c, lat_add)`` arrays for every lane (or,
        for ``conventional=True``, per-lane stall totals via
        :meth:`conventional_stalls`)."""
        self.replay(lo, hi)
        return self.finish(lo, hi)

    def finish(self, lo: int, hi: int,
               fold: bool = True) -> dict[str, _ResolvedChunk]:
        """Consume the backing-store draws for the chunk last replayed
        and build the per-op latency matrices (plus the capture planes);
        ``fold=False`` skips the per-stage fold (the sharded executor's
        workers hand the raw matrices to the master, which folds)."""
        with _engine.phase("fold"):
            return self._finish(lo, hi, fold)

    def _finish(self, lo: int, hi: int,
                fold: bool = True) -> dict[str, _ResolvedChunk]:
        n = hi - lo
        K = self.K
        addrs_n = self._n_addrs
        flat_p = self._flat_p
        store_flat = self._store_flat
        hits_by_key = self._hits_by_key
        burst_words = self._burst_words

        def _lat_for(name: str, mem: MemoryModel) -> np.ndarray:
            """Per-participating-access latencies, consuming this
            model's draw stream position-for-position like the scalar
            reference (and counting the doubles consumed)."""
            key = self.cache_keys[name]
            if key is None:
                lat_flat = _backing_latencies(
                    mem, self.rngs[name], addrs_n).astype(np.int32)
                if mem.backing_hit_rate > 0.0:
                    self.draws[name] += addrs_n
            else:
                hit = hits_by_key[key]
                lat_flat = np.full(addrs_n, mem.cache.hit_cycles,
                                   dtype=np.int32)
                miss = ~hit
                nm = int(miss.sum())
                lat_flat[miss] = _backing_latencies(
                    mem, self.rngs[name], nm)
                if mem.backing_hit_rate > 0.0:
                    self.draws[name] += nm
            return lat_flat

        def _planes(key: tuple | None) -> tuple[np.ndarray | None,
                                                np.ndarray | None]:
            """(hit, visit) flag matrices for the chunk-record writer:
            True where an access went through the on-PL cache (visit)
            and hit.  Write-around stores never visit."""
            if not self.capture or key is None:
                return None, None
            H = np.zeros(n * max(K, 1), dtype=bool)
            V = np.zeros(n * max(K, 1), dtype=bool)
            H[flat_p] = hits_by_key[key]
            write_allocate = key[4]
            if write_allocate or not store_flat.any():
                V[flat_p] = True
            else:
                idx = np.nonzero(flat_p)[0]
                V[idx[~store_flat]] = True
            return (H.reshape(n, -1)[:, :K], V.reshape(n, -1)[:, :K])

        self.last_ops = {}
        self.last_hits = {}
        self.last_visits = {}
        self._lat_flat = {}
        if self.conventional:
            # the conventional engine only needs stall *sums*; without a
            # writer the draws are consumed per lane inside
            # conventional_stalls (exact counts — the same stream
            # positions the scalar loop uses).  With capture on, the
            # latencies are materialized here instead (identical draw
            # stream) so the chunk records can store them.
            if self.capture:
                for name, mem in self.mems.items():
                    lat_flat = _lat_for(name, mem)
                    self._lat_flat[name] = lat_flat
                    L = np.zeros(n * max(K, 1), dtype=np.int32)
                    L[flat_p] = lat_flat
                    self.last_ops[name] = L.reshape(n, -1)[:, :K]
                    h, v = _planes(self.cache_keys[name])
                    self.last_hits[name] = h
                    self.last_visits[name] = v
            return {}
        out: dict[str, _ResolvedChunk] = {}
        for name, mem in self.mems.items():
            lat_flat = _lat_for(name, mem)
            L = np.zeros(n * max(K, 1), dtype=np.int32)
            L[flat_p] = lat_flat
            L = L.reshape(n, max(K, 1))
            self.last_ops[name] = L[:, :K]
            if self.capture:
                h, v = _planes(self.cache_keys[name])
                self.last_hits[name] = h
                self.last_visits[name] = v
            if fold:
                out[name] = self._fold(mem, lo, hi, L, burst_words)
        return out

    def conventional_stalls(self, static_overlap: int) -> dict[str, int]:
        """Stall cycles the static schedule pays for the chunk resolved by
        the last :meth:`resolve` call: every access is charged against the
        schedule's assumed latency — except posted stores, which retire
        through the write buffer without halting the engine.

        A backing draw only ever contributes one of two per-access stall
        values (port or DRAM, clamped against the assumed latency), so
        the sum collapses to counting how many draws land under the
        backing hit rate — no per-access latency array is materialized.
        The draw *stream* consumed per lane is position-for-position the
        one the scalar reference consumes."""
        out = {}
        store = self._store_flat
        for name, mem in self.mems.items():
            counted = None
            if mem.posted_writes and len(store) and store.any():
                counted = ~store
            lat = self._lat_flat.get(name)
            if lat is not None:
                # capture mode materialized the latencies (same draw
                # stream): fold the stall sum from them — the single
                # definition the chunk-record serve path uses too
                out[name] = _stall_from_latencies(mem, lat, counted,
                                                  static_overlap)
                continue
            rate = mem.backing_hit_rate
            so = static_overlap
            key = self.cache_keys[name]
            if key is None:
                # every valid access pays a backing trip
                n = self._n_addrs
                a = (mem.port_latency - 1) // so
                b = (mem.dram_latency - 1) // so
                if rate <= 0.0:
                    cnt = n if counted is None else int(counted.sum())
                    out[name] = b * cnt
                    continue
                u = self.rngs[name].random(n)
                self.draws[name] += n
                fast = u < rate
                if counted is None:
                    c1, cnt = int(fast.sum()), n
                else:
                    c1 = int(fast[counted].sum())
                    cnt = int(counted.sum())
                out[name] = a * c1 + b * (cnt - c1)
                continue
            # cache hits meet the assumed (hit) latency: zero stall; a
            # backing trip faster than the assumed latency stalls nothing
            # (clamp, not credit)
            hit = self._hits_by_key[key]
            hc = mem.cache.hit_cycles
            a = max(mem.port_latency - hc, 0) // so
            b = max(mem.dram_latency - hc, 0) // so
            miss = ~hit
            nm = int(miss.sum())
            if rate <= 0.0:
                cnt = nm if counted is None else int((miss
                                                      & counted).sum())
                out[name] = b * cnt
                continue
            u = self.rngs[name].random(nm)
            self.draws[name] += nm
            fast = u < rate
            if counted is None:
                c1, cnt = int(fast.sum()), nm
            else:
                sel = counted[miss]
                c1 = int(fast[sel].sum())
                cnt = int(sel.sum())
            out[name] = a * c1 + b * (cnt - c1)
        return out


# ---------------------------------------------------------------------------
# The dataflow machine (vectorized wavefront + scalar reference)
# ---------------------------------------------------------------------------

def _ii_scan(b: np.ndarray, c: np.ndarray, prev: int | None) -> np.ndarray:
    """Solve start[i] = max(b[i], start[i-1] + c[i]) with start[-1]=prev.

    start[i] = max_{j<=i} (b[j] + sum(c[j+1..i])), a running max over
    ``b - cumsum(c)`` shifted back — one pass, no Python loop.
    """
    D = np.cumsum(c)
    e = b - D
    if prev is not None:
        e[0] = max(e[0], prev)  # prev + D[i] is the start[-1] chain
    _engine.running_max(e)
    return e + D


class _StageTail:
    """Carried solver state for one stage across chunks: the last
    ``keep`` start values (enough for FIFO lookback) and the global index
    of the first kept value."""

    def __init__(self, keep: int):
        self.keep = max(1, keep)
        self.starts = np.zeros(0, dtype=np.int64)
        self.base = 0  # global iteration index of starts[0]

    @property
    def last(self) -> int | None:
        return int(self.starts[-1]) if len(self.starts) else None

    def lookup(self, g: np.ndarray) -> np.ndarray:
        """Start values for global indices g (must be < base+len, >= 0 ->
        within the kept window; g < 0 returns 0)."""
        out = np.zeros(len(g), dtype=np.int64)
        m = g >= 0
        if m.any():
            out[m] = self.starts[g[m] - self.base]
        return out

    def push(self, starts: np.ndarray, lo: int) -> None:
        if len(starts) >= self.keep:
            self.starts = starts[-self.keep:].copy()
            self.base = lo + len(starts) - len(self.starts)
        else:
            self.starts = np.concatenate([self.starts, starts])[-self.keep:]
            self.base = lo + len(starts) - len(self.starts)


class _LaneSolver:
    """Carried wavefront-solver state for one (memory model × FIFO depth)
    simulation cell: stage tails, stall buckets, and the last finish time.

    The per-chunk solve works in *chunk-relative* coordinates (global
    cycle counts minus a per-chunk base) so the scans run in int32
    whenever the chunk's dynamic range allows — the running-max scan is
    ~5× faster in int32 than int64 — with an automatic int64 fallback.

    Solve order:

    1. **Fast path** — one exact forward sweep ignoring FIFO
       backpressure, then a vectorized check of every backpressure
       constraint.  When no constraint is violated the sweep *is* the
       exact minimal solution (the recurrence's dependence order is
       acyclic), and generously sized FIFOs — the template's §III-B2
       sizing rule — hit this path on almost every chunk.
    2. **Alternating Gauss–Seidel** — backward sweeps propagate fresh
       backpressure, forward sweeps propagate fresh producer terms; all
       iterates grow monotonically from below, so the first forward
       sweep whose values violate no FIFO constraint is exact.
    3. **Block mode** — the exact ``fifo_depth``-block fallback when the
       iteration does not converge (steadily binding backpressure).
    """

    def __init__(self, stages: Sequence[SimStage], fifo_depth: int,
                 collect_stalls: bool = True):
        self.stages = list(stages)
        self.fifo_depth = fifo_depth
        self.collect_stalls = collect_stalls
        self.tails = [_StageTail(fifo_depth) for _ in stages]
        self.stall: dict[str, dict[str, int]] = {
            st.name: dict.fromkeys(STALL_BUCKETS, 0) for st in stages}
        self.last_finish = 0

    # -- solve ---------------------------------------------------------------

    def _bp_head(self, s: int, lo: int, n: int, base: int) -> np.ndarray:
        """Backpressure for the first min(depth, n) iterations, read from
        the downstream tail (relative to ``base``)."""
        head = min(self.fifo_depth, n)
        g = np.arange(lo - self.fifo_depth, lo - self.fifo_depth + head)
        return self.tails[s + 1].lookup(g) - base

    def _bp_ok(self, starts: list[np.ndarray], lo: int, n: int,
               base: int) -> bool:
        S = len(self.stages)
        D = self.fifo_depth
        for s in range(S - 1):
            head = min(D, n)
            if np.any(starts[s][:head] < self._bp_head(s, lo, n, base)):
                return False
            if n > head and np.any(starts[s][head:]
                                   < starts[s + 1][:n - head]):
                return False
        return True

    def _up_ok(self, starts: list[np.ndarray], res: _ResolvedChunk,
               dtype) -> bool:
        """Producer constraints ``start[s] >= finish[s-1]`` on the current
        iterate — one vectorized compare per stage, no scans."""
        for s in range(1, len(self.stages)):
            lat = self.stages[s - 1].latency
            if self._lat_zero[s - 1]:
                fin = starts[s - 1] + dtype(lat) if lat else starts[s - 1]
            else:
                fin = starts[s - 1] + res.lat_add[s - 1].astype(dtype,
                                                                copy=False)
                if lat:
                    fin += dtype(lat)
            if np.any(starts[s] < fin):
                return False
        return True

    def _build_b(self, s: int, starts: list, res: _ResolvedChunk,
                 base: int, dtype, floor, with_bp: bool,
                 out: np.ndarray | None = None) -> np.ndarray:
        n = res.hi - res.lo
        st = self.stages
        if s > 0:
            lat = dtype(st[s - 1].latency)
            if self._lat_zero[s - 1]:
                if out is None:
                    b = starts[s - 1] + lat
                else:
                    np.add(starts[s - 1], lat, out=out)
                    b = out
            else:
                la = res.lat_add[s - 1].astype(dtype, copy=False)
                if out is None:
                    b = starts[s - 1] + la
                else:
                    np.add(starts[s - 1], la, out=out)
                    b = out
                if st[s - 1].latency:
                    b += lat
        elif out is None:
            b = np.full(n, floor, dtype=dtype)
        else:
            out.fill(floor)
            b = out
        if with_bp and s + 1 < len(st):
            head = min(self.fifo_depth, n)
            np.maximum(b[:head],
                       self._bp_head(s, res.lo, n, base).astype(dtype),
                       out=b[:head])
            if n > head:
                np.maximum(b[head:], starts[s + 1][:n - head],
                           out=b[head:])
        return b

    def _warm_exact(self, w: list[np.ndarray], res: _ResolvedChunk,
                    lo: int, n: int, base: int) -> bool:
        """Is a warm-start iterate already this lane's exact solution?

        ``w`` (chunk-relative to ``base``, int64) must satisfy every
        constraint family: the self-recurrence, the producer bounds, and
        this lane's FIFO backpressure.  A feasible point that is also a
        *lower* bound on the least fixed point (e.g. an adjacent deeper
        FIFO depth's exact solution — weaker constraints, hence earlier
        starts) must equal it, so feasibility alone certifies exactness
        and the whole chunk solve collapses to three vectorized checks.
        """
        for s in range(len(self.stages)):
            ws = w[s]
            c = res.c[s]
            if n > 1 and np.any(ws[1:] < ws[:-1] + c[1:]):
                return False
            last = self.tails[s].last
            if last is not None:
                if ws[0] < last - base + int(c[0]):
                    return False
            elif s == 0 and lo == 0 and ws[0] < 0:
                return False  # iteration 0 floors at cycle 0
        if not self._up_ok(w, res, np.int64):
            return False
        return self._bp_ok(w, lo, n, base)

    def solve_chunk(self, res: _ResolvedChunk,
                    warm: tuple[list[np.ndarray], int] | None = None,
                    ) -> tuple[list[np.ndarray], int]:
        """Solve one chunk; returns ``(starts, base)`` — the exact
        chunk-relative start arrays — so an adjacent (deeper-depth) lane
        solved first can seed a shallower lane's solve (``warm``): when
        the deeper solution already satisfies the shallower FIFO
        constraints it is adopted outright (no scans), otherwise it
        seeds the Gauss–Seidel iterate from below.  Results are
        bit-identical to a cold solve either way."""
        with _engine.phase("solve"):
            return self._solve_chunk(res, warm)

    def _solve_chunk(self, res: _ResolvedChunk,
                     warm: tuple[list[np.ndarray], int] | None = None,
                     ) -> tuple[list[np.ndarray], int]:
        stages = self.stages
        S = len(stages)
        lo, n = res.lo, res.hi - res.lo
        lasts = [t.last for t in self.tails]
        base = min((int(t.starts[0]) for t in self.tails
                    if len(t.starts)), default=0)
        spread = max((x for x in lasts if x is not None), default=0) - base
        cmax = max(int(c.max()) for c in res.c)
        latmx = max((int(la.max()) for la in res.lat_add
                     if la.size), default=0)
        lat_tot = sum(st.latency for st in stages)
        bound = 2 * (spread + n * cmax + (S + 1) * (lat_tot + latmx)) + 1024
        if lo < self.fifo_depth:
            # backpressure lookbacks before iteration 0 resolve to global
            # cycle 0, i.e. −base in relative coordinates
            bound += 2 * base
        dtype = np.int32 if bound < (1 << 31) - (1 << 26) else np.int64
        first = lasts[0] is None  # no carried state: the first chunk
        floor = dtype(0) if first else np.iinfo(dtype).min // 4
        # per-chunk structure flags: constant-c stages (no memory traffic)
        # skip the cumsum, zero lat_add skips the upstream add
        self._lat_zero = [la.size == 0 or (la[0] == 0 and la[-1] == 0
                          and not la.any()) for la in res.lat_add]
        # depth-incremental warm start: adopt an adjacent deeper depth's
        # exact solution when it is feasible here too (three vectorized
        # checks instead of any scan — the common case when both depths
        # sit past the §III-B2 spike threshold)
        w64: list[np.ndarray] | None = None
        if warm is not None:
            shift = warm[1] - base
            w64 = [ws.astype(np.int64) + shift for ws in warm[0]]
            if self._warm_exact(w64, res, lo, n, base):
                if self.collect_stalls:
                    self._accumulate_stalls(res, w64, base)
                for s in range(S):
                    k = min(n, self.tails[s].keep)
                    self.tails[s].push(w64[s][n - k:] + base, lo + n - k)
                self.last_finish = int(w64[S - 1][-1]) + base \
                    + stages[S - 1].latency + int(res.lat_add[S - 1][-1])
                return w64, base
        rng_n = np.arange(n, dtype=dtype)
        D = []
        for c in res.c:
            c0 = int(c[0])
            if c[-1] == c0 and (c == c0).all():
                D.append(rng_n + dtype(c0) if c0 == 1
                         else (rng_n + 1) * dtype(c0))
            else:
                D.append(np.cumsum(c, dtype=dtype))
        prev_rel = [None if x is None else dtype(x - base) for x in lasts]

        def scan(b: np.ndarray, s: int) -> np.ndarray:
            # start[i] = max(b[i], start[i-1] + c[i]) as a running max
            # over b - cumsum(c), in place on b (the engine skips
            # carry-dominated blocks; torch runs the CUDA scan kernel)
            b -= D[s]
            p = prev_rel[s]
            if p is not None and b[0] < p:
                b[0] = p
            _engine.running_max(b)
            b += D[s]
            return b

        # 1. fast path: forward sweep without backpressure.  Producer and
        # self constraints hold by construction, so the sweep is exact
        # unless some FIFO constraint is violated.
        starts: list[np.ndarray] = []
        for s in range(S):
            starts.append(scan(self._build_b(
                s, starts, res, base, dtype, floor, with_bp=False), s))
        solved = self._bp_ok(starts, lo, n, base)

        # an infeasible warm start is still a valid lower bound on the
        # least fixed point: seed the Gauss–Seidel iterate with it
        if not solved and w64 is not None:
            for s in range(S):
                np.maximum(starts[s], w64[s].astype(dtype),
                           out=starts[s])

        # 2. alternating Gauss–Seidel (monotone from below).  After a
        # *backward* sweep the FIFO constraints hold by construction
        # (stage s is computed after s+1), so only the cheap producer
        # check remains; after a *forward* sweep it is the reverse.
        # One rolling spare buffer avoids reallocating per stage-solve.
        # Sweeps skip a stage whose rebuilt bound is already dominated:
        # iterates grow monotonically from below, so starts[s] is the
        # scan of some b_old <= b_new; when additionally b_new <=
        # starts[s] pointwise, monotonicity gives scan(b_new) ==
        # starts[s] exactly (starts is a fixed point of its own scan) —
        # the serial running-max pass for that stage is free.  Under
        # steady backpressure only the stages upstream of the bottleneck
        # change, so this halves a typical Gauss–Seidel sweep.
        if not solved:
            spare = np.empty(n, dtype=dtype)
            for _ in range(2 * S + 8):
                for s in range(S - 1, -1, -1):  # backward: fresh bp
                    b = self._build_b(s, starts, res, base, dtype,
                                      floor, True, out=spare)
                    if not np.any(b > starts[s]):
                        continue  # exact fixed point: scan unchanged
                    b = scan(b, s)
                    spare, starts[s] = starts[s], b
                if self._up_ok(starts, res, dtype):
                    solved = True
                    break
                for s in range(S):              # forward: fresh producers
                    b = self._build_b(s, starts, res, base, dtype,
                                      floor, True, out=spare)
                    if not np.any(b > starts[s]):
                        continue
                    b = scan(b, s)
                    spare, starts[s] = starts[s], b
                if self._bp_ok(starts, lo, n, base):
                    solved = True
                    break

        # 3. exact block-mode fallback (global coordinates)
        if not solved:
            g = _solve_chunk_blocks(stages, res, self.tails,
                                    self.fifo_depth)
            starts = [a - base for a in g]

        if self.collect_stalls:
            self._accumulate_stalls(res, starts, base)
        for s in range(S):
            k = min(n, self.tails[s].keep)
            self.tails[s].push(
                starts[s][n - k:].astype(np.int64) + base, lo + n - k)
        self.last_finish = int(starts[S - 1][-1]) + base \
            + stages[S - 1].latency + int(res.lat_add[S - 1][-1])
        return starts, base

    # -- stall attribution ---------------------------------------------------

    def _accumulate_stalls(self, res: _ResolvedChunk,
                           starts: list[np.ndarray], base: int) -> None:
        """Bucketed stall attribution for one solved chunk.  Per iteration
        the idle time start[i] - start[i-1] - 1 partitions exactly into
        (ii-1) + (c-ii) + gap, the gap going to whichever of producer/FIFO
        was binding — each wait is counted once, at the stage that
        waited."""
        stages = self.stages
        S = len(stages)
        lo, n = res.lo, res.hi - res.lo
        fifo_depth = self.fifo_depth
        for s, st in enumerate(stages):
            buckets = self.stall[st.name]
            c = res.c[s]
            prev = np.empty(n, dtype=np.int64)
            prev[1:] = starts[s][:-1]
            first_global = lo == 0
            last = self.tails[s].last
            prev[0] = last - base if last is not None else 0
            b2 = prev + c
            if first_global:
                b2[0] = 0  # iteration 0 has no self-recurrence
            gap = starts[s] - b2
            if s > 0:
                up = starts[s - 1] + (stages[s - 1].latency
                                      + res.lat_add[s - 1].astype(np.int64))
            else:
                up = np.zeros(n, dtype=np.int64)
            bp = np.full(n, np.iinfo(np.int64).min // 4, dtype=np.int64)
            if s + 1 < S:
                head = min(fifo_depth, n)
                bp[:head] = self._bp_head(s, lo, n, base)
                if n > head:
                    bp[head:] = starts[s + 1][:n - head]
            fifo_binding = bp > up
            gap_pos = np.maximum(gap, 0)
            buckets["upstream"] += int(gap_pos[~fifo_binding].sum())
            buckets["fifo"] += int(gap_pos[fifo_binding].sum())
            steady = n - 1 if first_global else n
            buckets["ii"] += steady * (st.ii - 1)
            mem_extra = (c - st.ii).astype(np.int64)
            if first_global:
                mem_extra = mem_extra[1:]
            buckets["memory"] += int(mem_extra.sum())


def _solve_chunk_blocks(
    stages: Sequence[SimStage], res: _ResolvedChunk,
    tails: list[_StageTail], fifo_depth: int,
) -> list[np.ndarray]:
    """Exact fallback: blocks of ``fifo_depth`` iterations — within a
    block every FIFO lookback lands in an earlier block, so one forward
    stage sweep per block is exact."""
    S = len(stages)
    lo, n = res.lo, res.hi - res.lo
    out = [np.empty(n, dtype=np.int64) for _ in range(S)]
    block_tails = [_StageTail(t.keep) for t in tails]
    for s in range(S):
        block_tails[s].starts = tails[s].starts.copy()
        block_tails[s].base = tails[s].base
    for b0 in range(0, n, fifo_depth):
        b1 = min(n, b0 + fifo_depth)
        nb = b1 - b0
        for s in range(S):
            b = np.zeros(nb, dtype=np.int64)
            if s > 0:
                np.maximum(b, out[s - 1][b0:b1] + stages[s - 1].latency
                           + res.lat_add[s - 1][b0:b1], out=b)
            if s + 1 < S:
                g = np.arange(lo + b0 - fifo_depth, lo + b1 - fifo_depth)
                np.maximum(b, block_tails[s + 1].lookup(g), out=b)
            out[s][b0:b1] = _ii_scan(b, res.c[s][b0:b1],
                                     block_tails[s].last)
        for s in range(S):
            block_tails[s].push(out[s][b0:b1], lo + b0)
    return out


class _ServeLost(RuntimeError):
    """A stored chunk record vanished mid-serve (concurrent eviction);
    callers retry the run without the cache."""


class _ServedOps:
    """Assembled read view over one artifact's stored chunk records:
    ``chunk(lo, hi)`` splices the per-op latency matrix out of the
    canonical-grid records, ``stats_upto(m)`` rebuilds the exact cache
    hit/miss counters for *any* prefix from the records' cumulative
    counters plus the packed hit/visit planes of the partial tail —
    that is what makes an N-iteration artifact serve any M ≤ N run
    bit-identically."""

    def __init__(self, key: str, n_iters: int, widen: bool = True):
        from . import rescache as _rc
        self._rc = _rc
        self.key = key
        self.n_iters = n_iters
        self.C = _rc.CHUNK_ITERS
        #: widen shrunk (int8/int16) latency records back to int32 — the
        #: fold sums serialized latencies; level-matrix consumers (the
        #: processor model) keep the narrow dtype
        self.widen = widen

    def _record(self, idx: int):
        rec = self._rc.get_chunk(self.key, idx)
        if rec is None:
            raise _ServeLost(f"rescache chunk {self.key}.c{idx} vanished")
        return rec

    def chunk(self, lo: int, hi: int) -> np.ndarray:
        C = self.C
        parts = []
        idx = lo // C
        pos = lo
        while pos < hi:
            rec = self._record(idx)
            r0 = pos - idx * C
            r1 = min(hi - idx * C, rec.n)
            if r1 <= r0:
                raise _ServeLost(
                    f"rescache chunk {self.key}.c{idx} shorter than "
                    f"requested range")
            parts.append(rec.ops[r0:r1])
            pos = idx * C + r1
            idx += 1
        out = parts[0] if len(parts) == 1 \
            else np.concatenate(parts, axis=0)
        if self.widen and out.dtype != np.int32:
            # records store shrunk latencies; the fold sums serialized
            # latencies, so widen before handing them out
            return out.astype(np.int32)
        return out

    def stats_upto(self, m: int) -> tuple[int, int]:
        """Exact (cache_hits, cache_misses) after ``m`` iterations."""
        if m <= 0:
            return 0, 0
        C = self.C
        last = (m - 1) // C
        rec = self._record(last)
        hits = misses = 0
        if last > 0:
            prev = self._record(last - 1)
            hits = int(prev.cum.get("hits", 0))
            misses = int(prev.cum.get("misses", 0))
        tail = m - last * C
        if tail == rec.n:  # exact chunk boundary: cumulative counters
            return (int(rec.cum.get("hits", 0)),
                    int(rec.cum.get("misses", 0)))
        h = rec.hit_flags(1)
        v = rec.hit_flags(2)
        if h is None or v is None:  # cache-less model: no planes stored
            return hits, misses
        th = int(h[:tail].sum())
        tv = int(v[:tail].sum())
        return hits + th, misses + (tv - th)


def _chunk_bounds(n: int, chunk_iters: int,
                  align: int | None = None) -> list[tuple[int, int]]:
    """Streaming chunk boundaries over [0, n): the caller's
    ``chunk_iters`` grid, additionally split at every multiple of
    ``align`` (the canonical artifact grid) so chunk records and resume
    states land exactly on storable boundaries.  Resolution and the
    wavefront solve are chunking-invariant, so splitting finer never
    changes results."""
    bounds = set(range(0, n, chunk_iters))
    if align:
        bounds.update(range(0, n, align))
    bs = sorted(bounds) + [n]
    return [(bs[i], bs[i + 1]) for i in range(len(bs) - 1)]


class _ResolutionPlan:
    """Per-model serve / resume / write bookkeeping for one resolution
    run — the chunk-graph schedule both the streaming engines and the
    sharded executor follow.

    For every model: compute the v3 key, probe the store's contiguous
    prefix, and classify the model as **served** (stored prefix covers
    the whole run) or **live**.  Live models share one
    :class:`_SharedResolver`; when every live model has the same stored
    full-chunk prefix ``resume`` > 0, the chunks below it are served
    from the records and the resolver fast-forwards to ``resume`` via
    the stored resume states (cache stacks + RNG draw positions) —
    interrupted runs continue from their last completed chunk instead
    of starting over.  Live models with a key get a
    :class:`~repro_torch.core.rescache.ChunkWriter`; records are emitted the
    moment each canonical chunk completes."""

    def __init__(self, kind: str, stages: Sequence[SimStage],
                 mems: Mapping[str, MemoryModel], seed: int,
                 n_iters: int, use_rescache: bool | None):
        from . import rescache as _rc
        self._rc = _rc
        self.kind = kind
        self.stages = list(stages)
        self.mems = dict(mems)
        self.seed = seed
        self.n = n_iters
        self.C = _rc.CHUNK_ITERS
        self.keys: dict[str, str | None] = {}
        self.served: dict[str, _ServedOps] = {}
        self.live: dict[str, MemoryModel] = {}
        self._live_view: dict[str, _ServedOps] = {}
        resume_chunks: list[int] = []
        for mn, mem in self.mems.items():
            key = _rc.resolution_key(kind, stages, mem, seed) \
                if _rc.enabled(use_rescache) else None
            self.keys[mn] = key
            full, avail = _rc.prefix(key, self.C) \
                if key is not None else (0, 0)
            if key is not None and avail >= n_iters:
                self.served[mn] = _ServedOps(key, n_iters)
            else:
                self.live[mn] = mem
                resume_chunks.append(full if key is not None else 0)
        self.resume = min(resume_chunks, default=0) * self.C
        self.resume = min(self.resume, n_iters)
        self.resolver: _SharedResolver | None = None
        self.writers: dict[str, Any] = {}
        if self.live:
            n_ops = sum(len(st.accesses) for st in stages)
            writers = {mn: _rc.ChunkWriter(
                self.keys[mn], n_ops, n_iters,
                itemsize=_lat_itemsize(self.live[mn]))
                for mn in self.live if self.keys[mn] is not None}
            self.writers = {mn: w for mn, w in writers.items()
                            if not w.dead}
            self.resolver = _SharedResolver(
                stages, self.live, seed,
                conventional=(kind == "conventional"),
                capture=bool(self.writers))
            if self.resume > 0:
                recs = {mn: _rc.get_chunk(self.keys[mn],
                                          self.resume // self.C - 1)
                        for mn in self.live}
                if any(r is None for r in recs.values()):
                    self.resume = 0  # raced away: restart cold
                else:
                    for mn, rec in recs.items():
                        self.resolver.import_resume(mn, rec.states,
                                                    rec.cum)
                    self._live_view = {
                        mn: _ServedOps(self.keys[mn], self.resume)
                        for mn in self.live}
        #: canonical-chunk write buffers: model -> list of piece tuples
        self._pieces: dict[str, list] = {mn: [] for mn in self.writers}

    # -- streaming ----------------------------------------------------------

    def bounds(self, chunk_iters: int) -> list[tuple[int, int]]:
        align = self.C if (self.writers or self.served
                           or self.resume) else None
        return _chunk_bounds(self.n, chunk_iters, align)

    def live_chunk_is_served(self, lo: int) -> bool:
        """Chunks below the resume point serve live models too."""
        return lo < self.resume

    def live_ops(self, mn: str, lo: int, hi: int) -> np.ndarray:
        """Per-op latency matrix for a live model's chunk — from the
        resolver after :meth:`advance`, or from the stored prefix below
        the resume point."""
        if lo < self.resume:
            return self._live_view[mn].chunk(lo, hi)
        return self.resolver.last_ops[mn]

    def advance(self, lo: int, hi: int) -> dict[str, _ResolvedChunk]:
        """Run live resolution for [lo, hi) (a no-op below the resume
        point) and stream completed canonical records to the store.
        Returns the resolver's folded chunks (dataflow kind only)."""
        if self.resolver is None or lo < self.resume:
            if self.live:
                self._rc.note_chunks(served=len(self.live))
            return {}
        out = self.resolver.resolve(lo, hi)
        self._rc.note_chunks(cold=1)
        for mn, w in self.writers.items():
            if (hi - 1) // self.C >= w.max_chunks:
                continue  # past this artifact's stored-prefix budget
            self._pieces[mn].append((
                self.resolver.last_ops[mn],
                self.resolver.last_hits.get(mn),
                self.resolver.last_visits.get(mn)))
            if hi % self.C == 0 or hi == self.n:
                self._emit(mn, w, hi)
        # once every writer is past its budget, stop building the
        # capture planes too (a billion-iteration run should not pack
        # hit bits it will never store)
        if self.resolver.capture and self.writers and all(
                w.max_chunks <= hi // self.C
                for w in self.writers.values()):
            self.resolver.capture = False
        return out

    def _emit(self, mn: str, writer: Any, hi: int) -> None:
        pieces = self._pieces[mn]
        ops = np.concatenate([p[0] for p in pieces], axis=0) \
            if len(pieces) > 1 else pieces[0][0]
        idx = (hi - 1) // self.C
        n_rec = hi - idx * self.C
        hitbits = visbits = None
        if pieces[0][1] is not None:
            h = np.concatenate([p[1] for p in pieces], axis=0) \
                if len(pieces) > 1 else pieces[0][1]
            v = np.concatenate([p[2] for p in pieces], axis=0) \
                if len(pieces) > 1 else pieces[0][2]
            hitbits = self._rc.pack_flags(h)
            visbits = self._rc.pack_flags(v)
        states, cum = self.resolver.export_resume(mn)
        writer.add(idx, n_rec, np.ascontiguousarray(ops),
                   hitbits, visbits, states, cum)
        self._pieces[mn] = []

    def cache_stats(self, mn: str) -> tuple[int, int]:
        if mn in self.served:
            return self.served[mn].stats_upto(self.n)
        return self.resolver.cache_stats(mn)


def simulate_dataflow_many(
    stages: Sequence[SimStage],
    mems: Mapping[str, MemoryModel],
    n_iters: int,
    *,
    fifo_depths: Sequence[int] = (8,),
    freq_mhz: float = 150.0,
    seed: int = 0,
    chunk_iters: int = DEFAULT_CHUNK_ITERS,
    collect_stalls: bool = True,
    use_rescache: bool | None = None,
    workers: int | None = None,
    depth_incremental: bool = True,
    server: str | None = None,
    engine: str | None = None,
) -> dict[tuple[str, int], SimResult]:
    """Simulate the decoupled pipeline on a *grid* of memory models ×
    FIFO depths in one streaming pass, sharing all resolution work the
    cells have in common (see :class:`_SharedResolver`): windows and
    burst masks are computed once per chunk, the on-PL cache replays once
    per distinct cache geometry, and each FIFO depth re-runs only the
    cheap wavefront solve.  Results are bit-identical to running
    :func:`simulate_dataflow` per cell.

    Resolved per-op latency matrices are memoized through
    :mod:`repro_torch.core.rescache` at chunk granularity (keyed on trace
    fingerprints, the memory model, and the seed — *not* the iteration
    count), so repeated sweeps — across grid cells, chunk sizes,
    iteration counts (prefix serving), and processes — skip the
    memory-system replay, and interrupted runs resume from their last
    completed chunk; ``use_rescache=False`` bypasses the cache
    (``None`` = global default).

    ``workers > 1`` shards the resolution across a process pool — the
    chunk-graph executor of :mod:`repro_torch.core.chunkgraph` — with
    bit-identical results; ``depth_incremental`` (default) solves the
    FIFO-depth lanes deepest-first and warm-starts each shallower lane
    from the adjacent deeper fixed point.

    ``server`` delegates resolution to a running resolution daemon
    (:mod:`repro_torch.serve`) instead: ``"auto"`` targets the store's
    canonical socket, anything else is an explicit address.  The daemon
    is a scheduling layer only — results stay bit-identical — and when
    serving is impossible (no daemon, unpicklable traces, rescache
    disabled) the call silently falls back to the local engines.

    ``engine`` overrides the resolution-engine backend for this call
    (``"numpy"`` / ``"torch"`` / ``"auto"``; default: ``$REPRO_TORCH_ENGINE``,
    see :mod:`repro_torch.core.engine`) — results are engine-independent.
    """
    if engine is not None:
        with _engine.use(engine):
            return simulate_dataflow_many(
                stages, mems, n_iters, fifo_depths=fifo_depths,
                freq_mhz=freq_mhz, seed=seed, chunk_iters=chunk_iters,
                collect_stalls=collect_stalls,
                use_rescache=use_rescache, workers=workers,
                depth_incremental=depth_incremental, server=server)
    for d in fifo_depths:
        if d < 1:
            raise ValueError("fifo_depth must be >= 1")
    S = len(stages)
    mems = dict(mems)
    if n_iters <= 0 or S == 0:
        return {(mn, d): SimResult(
            "dataflow", 0, n_iters, freq_mhz,
            {st.name: dict.fromkeys(STALL_BUCKETS, 0) for st in stages})
            for mn in mems for d in fifo_depths}
    if server:
        from ..serve.client import ServeUnavailable, \
            simulate_dataflow_served
        try:
            return simulate_dataflow_served(
                stages, mems, n_iters, fifo_depths=fifo_depths,
                freq_mhz=freq_mhz, seed=seed,
                collect_stalls=collect_stalls,
                depth_incremental=depth_incremental,
                address=None if server == "auto" else server)
        except ServeUnavailable:
            pass  # no daemon / unservable request: resolve locally
    if workers is not None and workers > 1:
        from .chunkgraph import simulate_dataflow_sharded
        return simulate_dataflow_sharded(
            stages, mems, n_iters, fifo_depths=fifo_depths,
            freq_mhz=freq_mhz, seed=seed, workers=workers,
            collect_stalls=collect_stalls, use_rescache=use_rescache,
            depth_incremental=depth_incremental)
    try:
        return _dataflow_many_stream(
            stages, mems, n_iters, fifo_depths=fifo_depths,
            freq_mhz=freq_mhz, seed=seed, chunk_iters=chunk_iters,
            collect_stalls=collect_stalls, use_rescache=use_rescache,
            depth_incremental=depth_incremental)
    except _ServeLost:
        try:
            # a quarantined record is gone from disk, so this pass
            # serves the surviving prefix and re-resolves + re-commits
            # the gap — the store heals instead of staying damaged
            return _dataflow_many_stream(
                stages, mems, n_iters, fifo_depths=fifo_depths,
                freq_mhz=freq_mhz, seed=seed, chunk_iters=chunk_iters,
                collect_stalls=collect_stalls,
                use_rescache=use_rescache,
                depth_incremental=depth_incremental)
        except _ServeLost:
            return _dataflow_many_stream(
                stages, mems, n_iters, fifo_depths=fifo_depths,
                freq_mhz=freq_mhz, seed=seed, chunk_iters=chunk_iters,
                collect_stalls=collect_stalls, use_rescache=False,
                depth_incremental=depth_incremental)


def _dataflow_many_stream(
    stages: Sequence[SimStage],
    mems: dict[str, MemoryModel],
    n_iters: int,
    *,
    fifo_depths: Sequence[int],
    freq_mhz: float,
    seed: int,
    chunk_iters: int,
    collect_stalls: bool,
    use_rescache: bool | None,
    depth_incremental: bool,
) -> dict[tuple[str, int], SimResult]:
    plan = _ResolutionPlan("dataflow", stages, mems, seed, n_iters,
                           use_rescache)
    # served models fold per-op artifacts back into per-stage arrays; the
    # live resolver doubles as the folder so windows are shared
    folder: _OpFolder = plan.resolver if plan.resolver is not None \
        else _OpFolder(stages)
    solvers = {(mn, d): _LaneSolver(stages, d, collect_stalls)
               for mn in mems for d in fifo_depths}
    depth_order = sorted(set(fifo_depths), reverse=True)
    for lo, hi in plan.bounds(chunk_iters):
        chunks = plan.advance(lo, hi)
        for mn in plan.live:
            if plan.live_chunk_is_served(lo):
                chunks[mn] = folder.fold(mems[mn], lo, hi,
                                         plan.live_ops(mn, lo, hi))
        for mn, so in plan.served.items():
            chunks[mn] = folder.fold(mems[mn], lo, hi, so.chunk(lo, hi))
            plan._rc.note_chunks(served=1)
        for mn in mems:
            warm = None
            for d in depth_order:
                warm = solvers[(mn, d)].solve_chunk(
                    chunks[mn], warm=warm if depth_incremental else None)
    out: dict[tuple[str, int], SimResult] = {}
    for (mn, d), solver in solvers.items():
        ch, cm = plan.cache_stats(mn)
        out[(mn, d)] = SimResult("dataflow", solver.last_finish, n_iters,
                                 freq_mhz, solver.stall, ch, cm)
    return out


def simulate_dataflow(
    stages: Sequence[SimStage],
    mem: MemoryModel,
    n_iters: int,
    *,
    fifo_depth: int = 8,
    freq_mhz: float = 150.0,
    seed: int = 0,
    reference: bool = False,
    chunk_iters: int = DEFAULT_CHUNK_ITERS,
    return_schedule: bool = False,
    collect_stalls: bool = True,
    use_rescache: bool | None = None,
    engine: str | None = None,
) -> SimResult | tuple[SimResult, np.ndarray, np.ndarray]:
    """Iteration-accurate simulation of the decoupled pipeline.

    Stage *s* iteration *i* starts when: (a) its own previous iteration
    cleared the per-iteration increment ``c[s,i]`` (II, memory-port
    throughput, burst bandwidth, serialized SCC latency), (b) its producer
    finished iteration *i* (FIFO pop), (c) the downstream FIFO has a free
    slot (backpressure, bounded channel).  A *memory stage* issues
    requests back-to-back and only the *data* arrival is delayed by the
    access latency — outstanding requests pipeline into the subsystem
    (§III-B2), bounded by ``mem.max_outstanding``.  Unless ``mem_in_scc``:
    then every access latency is serialized into the II (the paper's DFS
    case).  Posted stores (``mem.posted_writes``) bound throughput but
    never delay the data path; ``mem.cache.write_allocate=False`` makes
    stores bypass the on-PL cache entirely.

    ``reference=True`` runs the scalar nested loop (same semantics, same
    resolved latencies — cycle-exact agreement with the vectorized path);
    ``return_schedule=True`` additionally returns the (S, n_iters)
    start/finish matrices (small runs only).  Without ``reference`` the
    schedule capture resolves traces through the resolution layer and
    the rescache (sharing artifacts with the sweep/Fig. 5 harnesses)
    instead of the scalar ``MemoryState`` replay; both produce identical
    schedules.
    """
    if engine is not None:
        with _engine.use(engine):
            return simulate_dataflow(
                stages, mem, n_iters, fifo_depth=fifo_depth,
                freq_mhz=freq_mhz, seed=seed, reference=reference,
                chunk_iters=chunk_iters,
                return_schedule=return_schedule,
                collect_stalls=collect_stalls,
                use_rescache=use_rescache)
    if fifo_depth < 1:
        raise ValueError("fifo_depth must be >= 1")
    S = len(stages)
    stall: dict[str, dict[str, int]] = {
        st.name: dict.fromkeys(STALL_BUCKETS, 0) for st in stages}
    if n_iters <= 0 or S == 0:
        r = SimResult("dataflow", 0, n_iters, freq_mhz, stall)
        if return_schedule:
            return r, np.zeros((S, 0), np.int64), np.zeros((S, 0), np.int64)
        return r

    def scalar_step(start, finish, s, st, i, c_i, lat_i):
        """One (stage, iteration) of the scalar recurrence — the single
        definition both scalar paths (MemoryState reference and the
        resolution-layer schedule capture) step through, so their
        triple-max semantics and stall-bucket attribution cannot
        drift apart."""
        t_self = start[s, i - 1] + c_i if i > 0 else 0
        t_up = int(finish[s - 1, i]) if s > 0 else 0
        t_bp = (int(start[s + 1, i - fifo_depth])
                if s + 1 < S and i >= fifo_depth else 0)
        t = max(t_self, t_up, t_bp)
        buckets = stall[st.name]
        if i > 0:
            buckets["ii"] += st.ii - 1
            buckets["memory"] += c_i - st.ii
        gap = t - t_self
        if gap > 0:
            buckets["fifo" if t_bp > t_up else "upstream"] += gap
        start[s, i] = t
        finish[s, i] = t + lat_i

    if reference:
        # The scalar reference: one Python step per access / per iteration,
        # drawing from the memory system in the same canonical order as
        # the batched resolver (cycle-exact agreement is asserted in
        # tests).  O(stages * iters * accesses) — small runs only.
        state = mem.make_state()
        state.rng = np.random.default_rng(seed)
        burst_word_cycles = int(np.ceil(1.0 / mem.words_per_cycle))
        store_cap = mem.max_outstanding
        if mem.posted_writes and mem.store_buffer_depth is not None:
            store_cap = max(1, min(mem.max_outstanding,
                                   mem.store_buffer_depth))
        addr_full = [[acc._raw_window(0, n_iters) for acc in st.accesses]
                     for st in stages]
        seq_full = [[acc.window(0, n_iters, mem.line_bytes)[1]
                     for acc in st.accesses] for st in stages]
        start = np.zeros((S, n_iters), dtype=np.int64)
        finish = np.zeros((S, n_iters), dtype=np.int64)
        for i in range(n_iters):
            for s, st in enumerate(stages):
                al_lat = 0   # data-path latency (posted stores excluded)
                al_sp = 0    # throughput latency of loads/blocking stores
                al_post = 0  # throughput latency of posted stores
                al_sum = 0
                burst_words = 0
                for k in range(len(st.accesses)):
                    a = int(addr_full[s][k][i])
                    if a < 0:
                        continue
                    w = int(getattr(st.accesses[k], "width", 1) or 1)
                    if seq_full[s][k][i] and not st.mem_in_scc:
                        burst_words += w  # streams; no new request issued
                        continue
                    is_store = st.accesses[k].is_store
                    al = state.access_latency(a, is_store=is_store)
                    al_sum += al
                    if not st.mem_in_scc:
                        # a coalesced access pays one request latency for
                        # its first word; the other w−1 stream as bursts
                        burst_words += w - 1
                    if is_store and mem.posted_writes:
                        al_post = max(al_post, al)
                    else:
                        al_sp = max(al_sp, al)
                        al_lat = max(al_lat, al)
                if st.mem_in_scc:
                    c_i = st.ii + al_sum
                    lat_i = st.latency
                else:
                    c_i = max(st.ii,
                              _ceil_div(al_sp, mem.max_outstanding),
                              _ceil_div(al_post, store_cap),
                              burst_words * burst_word_cycles)
                    lat_i = st.latency + al_lat
                scalar_step(start, finish, s, st, i, c_i, lat_i)
        cycles = int(finish[S - 1, n_iters - 1])
        cs = state.cache
        r = SimResult("dataflow", cycles, n_iters, freq_mhz, stall,
                      cs.hits if cs else 0, cs.misses if cs else 0)
        if return_schedule:
            return r, start, finish
        return r

    if return_schedule:
        # Schedule capture on the *resolution layer* (the Fig. 2 Gantt
        # path): traces resolve through _SharedResolver and the rescache
        # — no scalar MemoryState replay — and the start/finish
        # recurrence runs over the resolved (c, lat_add) arrays.  Cycle
        # counts, stall buckets, and cache statistics are identical to
        # both the vectorized solve and the scalar reference (asserted
        # in tests); the O(stages × iters) Python recurrence still makes
        # this a small-run path.
        from . import rescache as _rc
        try:
            plan = _ResolutionPlan("dataflow", stages, {mem.name: mem},
                                   seed, n_iters, use_rescache)
            folder: _OpFolder = plan.resolver \
                if plan.resolver is not None else _OpFolder(stages)
            start = np.zeros((S, n_iters), dtype=np.int64)
            finish = np.zeros((S, n_iters), dtype=np.int64)
            for lo, hi in plan.bounds(chunk_iters):
                chunks = plan.advance(lo, hi)
                if mem.name in plan.served:
                    res = folder.fold(
                        mem, lo, hi, plan.served[mem.name].chunk(lo, hi))
                    _rc.note_chunks(served=1)
                elif plan.live_chunk_is_served(lo):
                    res = folder.fold(mem, lo, hi,
                                      plan.live_ops(mem.name, lo, hi))
                else:
                    res = chunks[mem.name]
                for i in range(lo, hi):
                    for s, st in enumerate(stages):
                        scalar_step(start, finish, s, st, i,
                                    int(res.c[s][i - lo]),
                                    st.latency
                                    + int(res.lat_add[s][i - lo]))
            ch, cm = plan.cache_stats(mem.name)
        except _ServeLost:  # raced eviction: redo the whole pass cold
            return simulate_dataflow(
                stages, mem, n_iters, fifo_depth=fifo_depth,
                freq_mhz=freq_mhz, seed=seed, chunk_iters=chunk_iters,
                return_schedule=True, collect_stalls=collect_stalls,
                use_rescache=False)
        cycles = int(finish[S - 1, n_iters - 1])
        return SimResult("dataflow", cycles, n_iters, freq_mhz, stall,
                         ch, cm), start, finish

    return simulate_dataflow_many(
        stages, {mem.name: mem}, n_iters, fifo_depths=(fifo_depth,),
        freq_mhz=freq_mhz, seed=seed, chunk_iters=chunk_iters,
        collect_stalls=collect_stalls, use_rescache=use_rescache,
    )[(mem.name, fifo_depth)]


# ---------------------------------------------------------------------------
# The conventional machine
# ---------------------------------------------------------------------------

#: §II static-schedule overlap credit (dual memory ports in the RTL).
_STATIC_OVERLAP = 2


def _conv_chunk_stall(mem: MemoryModel, folder: _OpFolder,
                      L: np.ndarray, lo: int, hi: int) -> int:
    """Static-engine stall sum for one *stored* chunk: re-derive the
    participation and store masks from the traces (cheap, stateless)
    and fold the stored per-access latencies — the same
    :func:`_stall_from_latencies` the live capture path uses, so served
    and resolved stall totals are bit-identical."""
    if folder.K == 0:
        return 0
    _, _, participates, _ = folder.chunk_arrays(lo, hi, mem.line_bytes,
                                                True)
    flat_p = participates.ravel()
    lat = np.ascontiguousarray(L).reshape(-1)[flat_p]
    store_flat = np.broadcast_to(
        folder.is_store, participates.shape).ravel()[flat_p]
    counted = ~store_flat if (mem.posted_writes
                              and store_flat.any()) else None
    return _stall_from_latencies(mem, lat, counted, _STATIC_OVERLAP)


def simulate_conventional_many(
    stages: Sequence[SimStage],
    mems: Mapping[str, MemoryModel],
    n_iters: int,
    *,
    freq_mhz: float = 150.0,
    seed: int = 0,
    chunk_iters: int = DEFAULT_CHUNK_ITERS,
    use_rescache: bool | None = None,
    engine: str | None = None,
) -> dict[str, SimResult]:
    """Conventional engine over several memory models in one streaming
    pass (windows and the cache replay shared, per-model draws — see
    :class:`_SharedResolver`).  Per-access latencies are memoized as
    chunk records through :mod:`repro_torch.core.rescache` (the stall fold —
    including the posted-write filter and the static-overlap credit —
    happens at serve time, so one artifact covers every
    ``posted_writes`` variant and any iteration-count prefix)."""
    if engine is not None:
        with _engine.use(engine):
            return simulate_conventional_many(
                stages, mems, n_iters, freq_mhz=freq_mhz, seed=seed,
                chunk_iters=chunk_iters, use_rescache=use_rescache)
    from . import rescache as _rc
    mems = dict(mems)
    ii = max([1] + [st.ii for st in stages])
    body_latency = sum(st.latency for st in stages)

    def result(stalled: int, ch: int, cm: int) -> SimResult:
        stall = {"engine": dict.fromkeys(STALL_BUCKETS, 0)}
        stall["engine"]["memory"] = stalled
        stall["engine"]["ii"] = n_iters * (ii - 1)
        cycles = n_iters * ii + stalled + body_latency
        return SimResult("conventional", int(cycles), n_iters, freq_mhz,
                         stall, ch, cm)

    if n_iters <= 0:
        return {mn: SimResult(
            "conventional", 0, n_iters, freq_mhz,
            {"engine": dict.fromkeys(STALL_BUCKETS, 0)}) for mn in mems}

    for attempt_rescache in (use_rescache, False):
        try:
            plan = _ResolutionPlan("conventional", stages, mems, seed,
                                   n_iters, attempt_rescache)
            folder: _OpFolder = plan.resolver \
                if plan.resolver is not None else _OpFolder(stages)
            totals = dict.fromkeys(mems, 0)
            for lo, hi in plan.bounds(chunk_iters):
                plan.advance(lo, hi)
                if plan.resolver is not None \
                        and not plan.live_chunk_is_served(lo):
                    for mn, v in plan.resolver.conventional_stalls(
                            _STATIC_OVERLAP).items():
                        totals[mn] += v
                elif plan.live:
                    for mn in plan.live:
                        totals[mn] += _conv_chunk_stall(
                            mems[mn], folder,
                            plan.live_ops(mn, lo, hi), lo, hi)
                for mn, so in plan.served.items():
                    totals[mn] += _conv_chunk_stall(
                        mems[mn], folder, so.chunk(lo, hi), lo, hi)
                    _rc.note_chunks(served=1)
            return {mn: result(totals[mn], *plan.cache_stats(mn))
                    for mn in mems}
        except _ServeLost:
            continue
    raise AssertionError("unreachable: cache-less run cannot lose chunks")


def simulate_conventional(
    stages: Sequence[SimStage],
    mem: MemoryModel,
    n_iters: int,
    *,
    freq_mhz: float = 150.0,
    seed: int = 0,
    reference: bool = False,
    chunk_iters: int = DEFAULT_CHUNK_ITERS,
    use_rescache: bool | None = None,
    engine: str | None = None,
) -> SimResult:
    """Conventional HLS accelerator: the same ops in ONE static schedule.

    The controller assumes best-case access latency; any access that takes
    longer stalls the entire engine for the difference (§II ¶1: "the entire
    compute engine is halted") — except posted stores, which retire
    through the write buffer without halting.  ``_STATIC_OVERLAP`` credits
    the schedule with a little instruction-level overlap between
    independent outstanding accesses (dual memory ports in the RTL).
    """
    if not reference:
        return simulate_conventional_many(
            stages, {mem.name: mem}, n_iters, freq_mhz=freq_mhz,
            seed=seed, chunk_iters=chunk_iters,
            use_rescache=use_rescache, engine=engine)[mem.name]
    static_overlap = _STATIC_OVERLAP
    ii = max([1] + [st.ii for st in stages])
    body_latency = sum(st.latency for st in stages)
    stall_key = "engine"
    stall: dict[str, dict[str, int]] = {
        stall_key: dict.fromkeys(STALL_BUCKETS, 0)}
    if n_iters <= 0:
        return SimResult("conventional", 0, n_iters, freq_mhz, stall)
    stalled = 0
    # scalar reference: one access_latency call per access, in order
    state = mem.make_state()
    state.rng = np.random.default_rng(seed)
    assumed = mem.cache.hit_cycles if mem.cache else None
    addr_full = [(acc._raw_window(0, n_iters), acc.is_store)
                 for st in stages for acc in st.accesses]
    for i in range(n_iters):
        for addrs, is_store in addr_full:
            a = int(addrs[i])
            if a < 0:
                continue
            al = state.access_latency(a, is_store=is_store)
            if is_store and mem.posted_writes:
                continue  # posted: the write buffer absorbs it
            if assumed is None:
                stalled += (al - 1) // static_overlap
            elif al > assumed:
                stalled += (al - assumed) // static_overlap
    cs = state.cache
    cycles = n_iters * ii + stalled + body_latency
    stall[stall_key]["memory"] = stalled
    stall[stall_key]["ii"] = n_iters * (ii - 1)
    return SimResult("conventional", int(cycles), n_iters, freq_mhz, stall,
                     cs.hits if cs else 0, cs.misses if cs else 0)


# ---------------------------------------------------------------------------
# The processor baseline
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ProcessorModel:
    """The §V baseline: out-of-order dual-issue ARM Cortex-A9 at 667 MHz."""

    freq_mhz: float = 667.0
    ipc: float = 1.6
    l1_kb: int = 32
    l2_kb: int = 512
    l1_hit: int = 1
    l2_hit: int = 8
    dram: int = 60  # in CPU cycles


def simulate_processor(
    instrs_per_iter: float,
    accesses: Sequence[MemAccess],
    n_iters: int,
    model: ProcessorModel | None = None,
    *,
    chunk_iters: int = DEFAULT_CHUNK_ITERS,
    use_rescache: bool | None = None,
) -> SimResult:
    """Vectorized OoO-core model: IPC-limited issue plus an L1/L2/DRAM
    hierarchy resolved trace-at-a-time (L1 hits fold into the IPC term;
    the OoO window overlaps half of DRAM latency).  The hierarchy is
    memoized through :mod:`repro_torch.core.rescache` as chunk records whose
    per-op *hit-level* matrices (int8) rebuild the exact hit counts for
    any iteration-count prefix; hit latencies and ``instrs_per_iter``
    are fold-only, so one artifact serves every :class:`ProcessorModel`
    timing variant."""
    from . import rescache as _rc
    m = model or ProcessorModel()

    def result(n_l2_hits, n_dram, hits, l2_misses):
        cycles = (n_iters * instrs_per_iter / m.ipc
                  + n_l2_hits * m.l2_hit + n_dram * m.dram * 0.5)
        mem_stall = int(n_l2_hits * m.l2_hit + n_dram * m.dram * 0.5)
        stall = {"core": dict.fromkeys(STALL_BUCKETS, 0)}
        stall["core"]["memory"] = mem_stall
        return SimResult("processor", int(cycles), n_iters, m.freq_mhz,
                         stall, hits, l2_misses)

    _tune_malloc()
    if n_iters <= 0:
        return result(0, 0, 0, 0)
    key = _rc.processor_key(accesses, m) \
        if _rc.enabled(use_rescache) else None
    C = _rc.CHUNK_ITERS
    full, avail = _rc.prefix(key, C) if key is not None else (0, 0)
    K = max(1, len(accesses))

    if key is not None and avail >= n_iters:
        try:  # fully served: count hit levels over the stored prefix
            so = _ServedOps(key, n_iters, widen=False)
            l1h = l2h = dram = 0
            pos = 0
            while pos < n_iters:
                hi = min(pos + C - pos % C, n_iters)
                lv = so.chunk(pos, hi)
                l1h += int((lv == 1).sum())
                l2h += int((lv == 2).sum())
                dram += int((lv == 3).sum())
                _rc.note_chunks(served=1)
                pos = hi
            return result(l2h, dram, l1h + l2h, dram)
        except _ServeLost:
            pass

    l1 = BatchedCacheSim(CacheConfig(size_bytes=m.l1_kb * 1024, ways=4,
                                     hit_cycles=m.l1_hit))
    l2 = BatchedCacheSim(CacheConfig(size_bytes=m.l2_kb * 1024, ways=8,
                                     hit_cycles=m.l2_hit))
    n_l2_hits = 0
    n_dram = 0
    # resume must land on the canonical grid: after a served-path
    # _ServeLost fallthrough, full*C can exceed n_iters — clamping to
    # the floor keeps the tail chunk live instead of silently skipped
    resume = min(full, n_iters // C) * C if key is not None else 0
    if resume > 0:
        rec = _rc.get_chunk(key, resume // C - 1)
        if rec is None:
            resume = 0
        else:
            l1.import_stacks(rec.states["l1"],
                             int(rec.cum.get("max_tag1", -1)))
            l2.import_stacks(rec.states["l2"],
                             int(rec.cum.get("max_tag2", -1)))
            l1.hits = int(rec.cum.get("l1hits", 0))
            l1.misses = int(rec.cum.get("l1miss", 0))
            l2.hits = int(rec.cum.get("l2hits", 0))
            l2.misses = int(rec.cum.get("l2miss", 0))
            n_l2_hits = l2.hits
            n_dram = l2.misses
            _rc.note_chunks(served=resume // C)
    writer = _rc.ChunkWriter(key, K, n_iters, itemsize=1)
    pieces: list[np.ndarray] = []
    for lo, hi in _chunk_bounds(n_iters, chunk_iters,
                                C if key is not None else None):
        if hi <= resume:
            continue
        n = hi - lo
        A = np.full((n, K), -1, dtype=np.int64)
        for k, acc in enumerate(accesses):
            A[:, k] = acc._raw_window(lo, hi)
        flat = A.ravel()
        valid = flat >= 0
        addrs = flat[valid]
        l1_hit = l1.lookup(addrs)
        to_l2 = addrs[~l1_hit]
        l2_hit = l2.lookup(to_l2)
        n_l2_hits += int(l2_hit.sum())
        n_dram += int((~l2_hit).sum())
        if not writer.dead:
            _rc.note_chunks(cold=1)
            lvl = np.zeros(n * K, dtype=np.int8)
            vidx = np.nonzero(valid)[0]
            lvl[vidx[l1_hit]] = 1
            l2idx = vidx[~l1_hit]
            lvl[l2idx[l2_hit]] = 2
            lvl[l2idx[~l2_hit]] = 3
            pieces.append(lvl.reshape(n, K))
            if hi % C == 0 or hi == n_iters:
                s1, mt1 = l1.export_stacks()
                s2, mt2 = l2.export_stacks()
                ops = np.concatenate(pieces, axis=0) \
                    if len(pieces) > 1 else pieces[0]
                writer.add((hi - 1) // C, hi - ((hi - 1) // C) * C,
                           np.ascontiguousarray(ops),
                           states={"l1": s1, "l2": s2},
                           cum={"l1hits": l1.hits, "l1miss": l1.misses,
                                "l2hits": l2.hits, "l2miss": l2.misses,
                                "max_tag1": mt1, "max_tag2": mt2})
                pieces = []
    return result(n_l2_hits, n_dram, l1.hits + l2.hits, l2.misses)


# ---------------------------------------------------------------------------
# Bridging: partitioner output -> simulator stages
# ---------------------------------------------------------------------------

def stages_from_partition(partition: Any,
                          traces: dict[str, MemAccess | list[MemAccess]],
                          *, mem_in_scc_regions: Iterable[str] = ()) -> list[SimStage]:
    """Build :class:`SimStage` specs from a real :class:`Partition` plus the
    per-region **byte**-address traces of the actual kernel."""
    mem_in_scc_regions = set(mem_in_scc_regions)
    out: list[SimStage] = []
    for st in partition.stages:
        accs: list[MemAccess] = []
        for region in st.regions:
            tr = traces.get(region)
            if tr is None:
                continue
            if isinstance(tr, MemAccess):
                accs.append(tr)
            else:
                accs.extend(tr)
        out.append(SimStage(
            name=f"stage{st.id}",
            ii=st.ii,
            latency=max(1, st.latency),
            accesses=accs,
            mem_in_scc=bool(mem_in_scc_regions & set(st.regions)),
        ))
    return out
