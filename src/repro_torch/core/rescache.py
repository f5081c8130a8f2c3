"""Memoized trace resolution: the chunk-granular, prefix-serving store.

Resolving an address trace against a memory model — cache replay,
backing-store draws, folding into per-stage ``(c, lat_add)`` arrays — is
the expensive half of the cycle simulator, and it is *identical* across
every sweep cell that shares a ``(trace, memory model, seed)`` triple:
FIFO depths, chunk sizes, and host processes only change the cheap
wavefront solve.  This module caches that resolution product:

* **in process** — a byte-capped LRU of per-chunk records, shared by
  every simulation in the interpreter (``paper_fig5``, ``sweep``,
  ``Compiled.sweep`` cells alike);
* **on disk** — an atomic store under ``experiments/.rescache_torch/`` (or
  ``$REPRO_RESCACHE_DIR``) so spawn-based process pools and repeated
  benchmark runs share work; corrupt or concurrent writes degrade to a
  cache miss, never an error.

The cache key (**v3**) is a blake2b digest of

* the **trace fingerprints** — full content for materialized arrays up
  to :data:`FULL_HASH_MAX` addresses, and a deterministic sample of
  windows plus the length for window-generated traces (``gen`` must be
  pure in ``(lo, hi)``, which the :class:`~repro_torch.core.simulator.MemAccess`
  contract already requires);
* the **op signature** — the iteration-major stream of per-op
  ``(fingerprint, is_store, serialized?)`` triples, with *no stage
  grouping*: two partitions of one kernel that merely regroup the same
  memory ops (the DSE explorer's merge/split candidates) produce the
  same key and share one artifact.  Stage *latency* and *II* are
  deliberately excluded: they shift the solver, never the resolved
  per-access latencies;
* the **memory model**, restricted to the fields that reach the
  resolved latencies: port/DRAM latencies, backing hit rate, cache
  geometry including ``write_allocate``, and — through the burst
  masks — ``line_bytes``.  Fold-only fields (``words_per_cycle``,
  ``max_outstanding``, ``store_buffer_depth``, and ``posted_writes``)
  are excluded: sweep lanes that only vary the port knobs share one
  artifact.  Since v3 the conventional engine's ``posted_writes`` and
  static-overlap credit are fold-only too (its artifact stores raw
  per-access latencies, not pre-folded stall sums).  The model's *name*
  is excluded;
* the **seed**.  Unlike v2, the **iteration count is NOT part of the
  key**: resolution is forward-causal (the latency of access *i*
  depends only on accesses before it), so an artifact resolved for N
  iterations is byte-identical on its first M rows to one resolved for
  M < N.  The chunk size is likewise excluded — resolution is
  chunk-invariant (asserted by the streaming tests).

The stored artifact is a **sequence of chunk records** at the canonical
granularity :data:`CHUNK_ITERS`, one ``<key>.c<idx>.npz`` file each:

* ``ops`` — the chunk's per-op resolved latency matrix
  (``(n, K)`` int32; zero where an op issued no request — invalid or
  burst-continuation slots).  The processor artifact stores a per-op
  *hit-level* matrix instead (int8: 0 none, 1 L1, 2 L2, 3 DRAM).
* ``hitbits`` — the packed on-PL-cache hit flags (models with a cache),
  so cache statistics for *any* prefix are exact without re-deriving
  them from latencies.
* the **resume state** at the chunk's end — the cache's per-set recency
  stacks and the cumulative RNG draw count — so an interrupted run
  resumes from its last completed chunk, bit-identically.
* cumulative hit/miss counters at the chunk boundary.

This layout is what makes v3 **prefix-serving**: a run of M iterations
reads chunk records ``0 .. ceil(M/CHUNK_ITERS)-1`` and trims the last,
regardless of the N the artifact was originally resolved for; a run of
N' > N serves the stored prefix and resolves only the missing chunks,
seeded from the last record's resume state.

**v2→v3 invalidation:** v2 stored one whole-run ``<key>.npz`` per
``(…, n_iters)`` key plus ``<key>.json`` stall/hit summaries for the
conventional/processor engines.  v3 keys do not collide with v2 keys
(the version string is part of the digest) and v2 payloads do not parse
as v3 chunk records (a failed load degrades to a cache miss), so v2
files are simply dead weight: run :func:`gc` — or let the byte-cap
evictor age them out — to reclaim the space.  The first post-upgrade
run of each configuration resolves cold and stores v3 chunks.

Results served from the cache are bit-identical to a fresh resolution;
disable with ``REPRO_RESCACHE=0``, ``configure(enabled=False)``, or the
benchmarks' ``--no-rescache`` flag.  An artifact whose full size would
exceed :func:`configure`'s ``artifact_mb`` (Floyd–Warshall's
10⁹-iteration grid) stores only its first ``artifact_mb``-worth of
chunks: short reruns still prefix-serve and long reruns resume from the
stored prefix's end, while the tail beyond it shares resolution
*within* a run through
:func:`~repro_torch.core.simulator.simulate_dataflow_many`'s lanes and
across cores through the chunk-graph executor.
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import hashlib
import os
import re
import tempfile
from collections import OrderedDict
from typing import Any, Sequence
from zipfile import BadZipFile as _BadZipFile

import numpy as np

from .simulator import MemAccess, MemoryModel, SimStage

#: Materialized traces up to this many addresses are fingerprinted by
#: full content; longer or generated traces by deterministic sampling.
FULL_HASH_MAX = 1 << 22

#: Number × size of sampled windows for long/generated traces.
SAMPLE_WINDOWS = 16
SAMPLE_LEN = 4096

#: Canonical chunk granularity of stored artifacts (iterations).  Every
#: producer emits records on these boundaries no matter how the run
#: itself was chunked, so artifacts written at any ``chunk_iters`` (and
#: by any worker of the sharded executor) tile identically.  The env
#: override exists for cross-process harnesses (the serving smoke test
#: shrinks the grid so a 20k-iteration run spans many chunks); every
#: process sharing one store must agree on the value.
CHUNK_ITERS = int(os.environ.get("REPRO_CHUNK_ITERS", str(1 << 20)))

_KEY_VERSION = "rescache-v3"

#: v3 chunk-record file names; anything else in the store directory is
#: an orphan from an earlier key version (see :func:`gc`).
_CHUNK_RE = re.compile(r"^[0-9a-f]{32}\.c\d{5,}\.npz$")

#: v3 effect-record file names — one chunk's cache-effect monoid (the
#: per-set recency stacks from an empty-cache replay, see
#: ``BatchedCacheSim.export_stacks``) keyed alongside the artifact's
#: chunk records.  A sharded master composes stored effects instead of
#: waiting for phase-A messages, so a re-shard (or daemon respawn)
#: skips the effect chain entirely (see ``docs/engine.md``).
_EFFECT_RE = re.compile(r"^[0-9a-f]{32}\.e\d{5,}\.npz$")


@dataclasses.dataclass
class _Config:
    enabled: bool = os.environ.get("REPRO_RESCACHE", "1") != "0"
    directory: str | None = os.environ.get("REPRO_RESCACHE_DIR")
    memory_mb: int = int(os.environ.get("REPRO_RESCACHE_MEM_MB", "256"))
    artifact_mb: int = int(os.environ.get("REPRO_RESCACHE_ART_MB", "256"))
    # sized so one full Fig. 5 regeneration (all kernels × engines ×
    # memory models, Floyd–Warshall capped to its stored prefix) fits
    # without the evictor cannibalizing earlier kernels' records
    disk_mb: int = int(os.environ.get("REPRO_RESCACHE_DISK_MB", "4096"))
    #: hard byte cap on the on-disk store; overrides ``disk_mb`` when set
    max_bytes: int | None = (
        int(os.environ["REPRO_RESCACHE_MAX_BYTES"])
        if os.environ.get("REPRO_RESCACHE_MAX_BYTES") else None)


_cfg = _Config()
_mem: "OrderedDict[tuple[str, int], ChunkRecord]" = OrderedDict()
_mem_bytes = 0
_evict_accum = 0  # bytes stored since the last disk-evictor sweep
_stats = {"mem_hits": 0, "disk_hits": 0, "misses": 0, "stores": 0,
          "too_large": 0, "disk_errors": 0,
          #: chunks resolved live (cold) vs served from the store —
          #: the store census the benchmarks and acceptance tests read
          "cold_chunks": 0, "served_chunks": 0,
          #: chunk re-dispatches after a pool worker died mid-chunk
          #: (the chunk-graph executor and the resolution daemon both
          #: respawn and retry under a bounded budget)
          "worker_retries": 0,
          #: records failing their blake2b checksum or unreadable as a
          #: zip — moved aside (``.quarantine``) and re-resolved, never
          #: served (see ``get_chunk``)
          "quarantined": 0,
          #: served runs that lost their daemon mid-stream and fell
          #: back to library mode, resuming from the committed prefix
          "serve_failovers": 0,
          #: speculative duplicate dispatches of straggling chunks
          #: (first commit wins; the loser is discarded by the
          #: executors' duplicate guards)
          "speculated": 0,
          #: cache-effect monoid records written / served (the sharded
          #: master composes served effects instead of waiting for
          #: phase-A worker messages — see ``put_effect``)
          "effect_stores": 0, "effect_hits": 0}


def configure(*, enabled: bool | None = None, directory: str | None = None,
              memory_mb: int | None = None, artifact_mb: int | None = None,
              disk_mb: int | None = None,
              max_bytes: int | None = None) -> None:
    """Adjust the cache at runtime (tests, benchmark flags)."""
    if enabled is not None:
        _cfg.enabled = enabled
    if directory is not None:
        _cfg.directory = directory
    if memory_mb is not None:
        _cfg.memory_mb = memory_mb
    if artifact_mb is not None:
        _cfg.artifact_mb = artifact_mb
    if disk_mb is not None:
        _cfg.disk_mb = disk_mb
    if max_bytes is not None:
        _cfg.max_bytes = max_bytes


def enabled(override: bool | None = None) -> bool:
    return _cfg.enabled if override is None else override


def stats() -> dict[str, int]:
    return dict(_stats, memory_bytes=_mem_bytes, entries=len(_mem))


def note_chunks(*, cold: int = 0, served: int = 0) -> None:
    """Census hook: producers report live-resolved vs store-served
    chunks (a prefix-served run must report ``cold == 0``)."""
    _stats["cold_chunks"] += cold
    _stats["served_chunks"] += served


def note_worker_retries(n: int = 1) -> None:
    """Census hook: a pool master re-dispatched ``n`` chunks after a
    worker died (respawn-and-retry; see the chunk-graph executor and
    the serving tier).  Surfaced by :func:`census` and the daemon's
    ``stats`` endpoint so silent worker churn is visible."""
    _stats["worker_retries"] += n


def note_speculation(n: int = 1) -> None:
    """Census hook: a pool master issued ``n`` speculative duplicate
    dispatches for straggling chunks (see
    the reference package's ``runtime.fault_tolerance.SpeculationPolicy``)."""
    _stats["speculated"] += n


def note_failover(n: int = 1) -> None:
    """Census hook: a served run lost its daemon (death, socket drop,
    deadline) mid-stream and completed in library mode from the
    committed store prefix.  Failovers are part of the contract — the
    counter keeps them from being *silently* part of it."""
    _stats["serve_failovers"] += n


def _faults():
    """The armed fault-injection plan's module, or ``None`` — a cheap
    check (module import is cached; ``active()`` reads one env var
    once) so production writes pay nothing."""
    try:
        from ..serve import faults as _f
    except ImportError:  # pragma: no cover - serve is part of the tree
        return None
    return _f if _f.active() else None


def _disk_cap_bytes() -> int:
    return _cfg.max_bytes if _cfg.max_bytes is not None \
        else _cfg.disk_mb * (1 << 20)


def clear(*, disk: bool = False) -> None:
    """Drop the in-process cache (and optionally the disk store)."""
    global _mem_bytes
    _mem.clear()
    _mem_bytes = 0
    for k in _stats:
        _stats[k] = 0
    if disk:
        d = _dir()
        if d and os.path.isdir(d):
            for f in os.listdir(d):
                if f.endswith((".npz", ".json", ".quarantine")):
                    try:
                        os.unlink(os.path.join(d, f))
                    except OSError:
                        pass


def evict(key: str) -> None:
    """Drop every chunk of one artifact from the in-process LRU and the
    disk store.  Benchmark meters use this to keep cold-timing probes
    cold across runs; missing keys are a no-op."""
    global _mem_bytes
    for k in [k for k in _mem if k[0] == key]:
        _mem_bytes -= _mem[k].nbytes
        del _mem[k]
    d = _dir()
    if d:
        for pat in (key + ".c*.npz", key + ".e*.npz"):
            for path in _glob.glob(os.path.join(d, pat)):
                try:
                    os.unlink(path)
                except OSError:
                    pass


def _dir() -> str | None:
    if _cfg.directory:
        return _cfg.directory
    # default: next to the benchmark artifacts when run from a repo,
    # else a per-user cache directory
    if os.path.isdir("experiments"):
        return os.path.join("experiments", ".rescache_torch")
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "repro-torch-rescache")


# ---------------------------------------------------------------------------
# Fingerprints
# ---------------------------------------------------------------------------

def trace_fingerprint(acc: MemAccess) -> str:
    """Content digest of one address trace (cached on the object).

    Materialized traces up to :data:`FULL_HASH_MAX` addresses hash their
    full contents; longer or window-generated traces hash a deterministic
    spread of :data:`SAMPLE_WINDOWS` windows plus the length (``gen``
    must be pure in its arguments — already part of the ``MemAccess``
    contract, since the simulators re-window traces freely)."""
    fp = acc.__dict__.get("_fingerprint")
    if fp is not None:
        return fp
    h = hashlib.blake2b(digest_size=16)
    n = len(acc)
    h.update(str(n).encode())
    if acc.addrs is not None and n <= FULL_HASH_MAX:
        h.update(b"full")
        h.update(np.ascontiguousarray(acc.addrs).tobytes())
    else:
        h.update(b"sampled")
        if acc.gen is not None:
            # fold in the generator itself — bytecode plus any scalar
            # closure parameters — so two generators that happen to agree
            # on the sampled windows still get distinct keys unless they
            # are literally the same code with the same parameters
            code = getattr(acc.gen, "__code__", None)
            if code is not None:
                h.update(code.co_code)
                h.update(repr(code.co_consts).encode())
            for cell in getattr(acc.gen, "__closure__", None) or ():
                try:
                    v = cell.cell_contents
                except ValueError:
                    continue
                if isinstance(v, (int, float, str, bytes, bool)):
                    h.update(repr(v).encode())
                elif isinstance(v, np.ndarray) and v.size <= 4096:
                    h.update(v.tobytes())
        step = max(1, (n - SAMPLE_LEN) // max(1, SAMPLE_WINDOWS - 1))
        for i in range(SAMPLE_WINDOWS):
            lo = min(i * step, max(0, n - SAMPLE_LEN))
            hi = min(n, lo + SAMPLE_LEN)
            if hi <= lo:
                break
            h.update(acc._raw_window(lo, hi).tobytes())
    fp = h.hexdigest()
    acc.__dict__["_fingerprint"] = fp
    return fp


def _cache_signature(mem: MemoryModel) -> tuple | None:
    if mem.cache is None:
        return None
    c = mem.cache
    return (c.size_bytes, c.line_bytes, c.ways, c.hit_cycles,
            c.write_allocate)


def resolution_key(kind: str, stages: Sequence[SimStage],
                   mem: MemoryModel, seed: int,
                   extra: Any = None) -> str:
    """Content-addressed key for one resolution product.

    The signature is **per-op**, not per-stage, and — new in v3 —
    **length-free**: neither the iteration count nor any fold-only
    model field participates (see the module docstring).  ``kind``
    selects which per-op and model fields matter:

    * ``"dataflow"`` — ops carry their serialized flag (a
      ``mem_in_scc`` stage's accesses never burst and serialize into
      the II); the model contributes ``line_bytes`` (burst masks).
    * ``"conventional"`` — no bursts and no serialization (every valid
      access resolves), so neither flag keys.  ``posted_writes`` no
      longer keys either: the v3 artifact stores raw per-access
      latencies, and posted stores are excluded at fold time.

    ``MemAccess.width`` (burst width of a coalesced vector access — see
    ``repro_torch.dataflow.transforms``) is **fold-only** under the v3
    contract: latency draws are per-*request* and identical addresses
    draw identical latencies, so a width-``w`` access resolves exactly
    like its width-1 head; only the burst-bandwidth fold reads ``w``.
    A *transformed* op stream, on the other hand, keys differently by
    construction — its closure cells (unroll factor, lane, base
    fingerprint) and sampled windows change the trace fingerprint — so
    transformed candidates are new cache entries, never invalidations
    of untransformed ones.
    """
    cache = _cache_signature(mem)
    if kind == "conventional":
        ops = tuple((trace_fingerprint(acc), acc.is_store)
                    for st in stages for acc in st.accesses)
        msig = (mem.port_latency, mem.dram_latency, mem.backing_hit_rate,
                cache)
    else:
        ops = tuple((trace_fingerprint(acc), acc.is_store, st.mem_in_scc)
                    for st in stages for acc in st.accesses)
        msig = (mem.port_latency, mem.dram_latency, mem.backing_hit_rate,
                mem.line_bytes, cache)
    payload = (_KEY_VERSION, kind, ops, msig, seed, extra)
    return hashlib.blake2b(repr(payload).encode(),
                           digest_size=16).hexdigest()


def processor_key(accesses: Sequence[MemAccess], model: Any) -> str:
    """Processor-hierarchy key: the cache *sizes* key the stored hit
    levels; hit latencies (``l1_hit``/``l2_hit``/``dram``) are fold-only
    — the cycle count is rebuilt from the level matrix."""
    payload = (_KEY_VERSION, "processor",
               tuple((trace_fingerprint(a), a.is_store) for a in accesses),
               (model.l1_kb, model.l2_kb))
    return hashlib.blake2b(repr(payload).encode(),
                           digest_size=16).hexdigest()


# ---------------------------------------------------------------------------
# Chunk records
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ChunkRecord:
    """One stored resolution chunk: iterations
    ``[idx*CHUNK_ITERS, idx*CHUNK_ITERS + n)`` of one base key.

    ``ops`` is the per-op latency matrix (int32) — or, for the
    processor artifact, the per-op hit-level matrix (int8).  ``hitbits``
    packs the on-PL-cache hit flags of the same ``(n, K)`` layout
    (``None`` for cache-less models); ``hitbits2`` is the processor's
    L2 plane.  ``states`` maps state names (``"cache"``, ``"l1"``,
    ``"l2"``) to per-set MRU-first recency-stack snapshots taken at the
    chunk's END; ``cum`` holds cumulative counters at the same point
    (``hits``/``misses``/``draws``/``max_tag`` and processor
    equivalents).  Together they are the resume point: a run needing
    more iterations seeds its resolver from the last stored record and
    continues bit-identically."""

    key: str
    idx: int
    n: int
    ops: np.ndarray
    hitbits: np.ndarray | None = None
    hitbits2: np.ndarray | None = None
    states: dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    cum: dict[str, int] = dataclasses.field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        b = self.ops.nbytes
        for a in (self.hitbits, self.hitbits2, *self.states.values()):
            if a is not None:
                b += a.nbytes
        return b

    def hit_flags(self, plane: int = 1) -> np.ndarray | None:
        bits = self.hitbits if plane == 1 else self.hitbits2
        if bits is None:
            return None
        K = self.ops.shape[1]
        return np.unpackbits(bits, count=self.n * K).reshape(
            self.n, K).astype(bool)


def pack_flags(flags: np.ndarray) -> np.ndarray:
    """Pack an ``(n, K)`` bool matrix for a :class:`ChunkRecord`."""
    return np.packbits(flags.reshape(-1))


def shrink_ops(ops: np.ndarray) -> np.ndarray:
    """Narrow a latency matrix to the smallest integer dtype that holds
    it (resolved latencies are bounded by the DRAM trip — typically
    < 128, so records shrink 4×).  Consumers widen back to int32 before
    folding; values are preserved exactly."""
    if ops.dtype == np.int8 or ops.size == 0:
        return ops
    mx = int(ops.max())
    if mx < 128:
        return ops.astype(np.int8)
    if mx < (1 << 15) and ops.dtype != np.int16:
        return ops.astype(np.int16)
    return ops


def _chunk_path(d: str, key: str, idx: int) -> str:
    return os.path.join(d, f"{key}.c{idx:05d}.npz")


def _record_digest(n: int, ops: np.ndarray,
                   hitbits: np.ndarray | None,
                   hitbits2: np.ndarray | None,
                   states: dict[str, np.ndarray],
                   cum: dict[str, int]) -> str:
    """Content digest of one chunk record — dtype, shape, and bytes of
    every array plus the counters, so any bit-flip or torn array is
    detected on read.  Stored inside the npz (``checksum``); records
    without one (older stores) load unverified."""
    h = hashlib.blake2b(digest_size=16)
    h.update(str(int(n)).encode())
    planes = [("ops", ops), ("hitbits", hitbits), ("hitbits2", hitbits2)]
    planes += [("st_" + k, states[k]) for k in sorted(states)]
    for name, arr in planes:
        if arr is None:
            continue
        h.update(name.encode())
        h.update(str(arr.dtype).encode())
        h.update(repr(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    h.update(repr(sorted(cum.items())).encode())
    return h.hexdigest()


def _quarantine(path: str) -> None:
    """Move a damaged record aside (``<name>.quarantine``) so the next
    prefix scan treats the chunk as absent and re-resolves it — the
    evidence survives for post-mortems, the serving path never sees it
    again.  :func:`gc` reclaims quarantined files."""
    _stats["quarantined"] += 1
    try:
        os.replace(path, path + ".quarantine")
    except OSError:
        try:
            os.unlink(path)
        except OSError:
            pass


def _touch_lru(k: tuple[str, int]) -> None:
    _mem.move_to_end(k)


def _insert_mem(rec: ChunkRecord) -> None:
    global _mem_bytes
    cap = _cfg.memory_mb * (1 << 20)
    if rec.nbytes > cap:
        return
    k = (rec.key, rec.idx)
    if k in _mem:
        _mem_bytes -= _mem[k].nbytes
        del _mem[k]
    _mem[k] = rec
    _mem_bytes += rec.nbytes
    while _mem_bytes > cap and _mem:
        _, old = _mem.popitem(last=False)
        _mem_bytes -= old.nbytes


def get_chunk(key: str, idx: int,
              refresh: bool = False) -> ChunkRecord | None:
    """Look one chunk record up in the in-process LRU, then disk.

    ``refresh=True`` skips the LRU and reloads from disk (still
    re-inserting the fresh copy): a partial tail record can be
    *overwritten* with a longer one by a resuming run or a pool worker,
    and a consumer that knows a rewrite just happened must not trust
    its cached copy."""
    k = (key, idx)
    if not refresh:
        rec = _mem.get(k)
        if rec is not None:
            _stats["mem_hits"] += 1
            _touch_lru(k)
            return rec
    d = _dir()
    path = _chunk_path(d, key, idx) if d else None
    if path and os.path.exists(path):
        try:
            with np.load(path) as z:
                cum_keys = [str(s) for s in z["cum_keys"]]
                cum_vals = z["cum_vals"]
                states = {name[3:]: z[name] for name in z.files
                          if name.startswith("st_")}
                rec = ChunkRecord(
                    key, idx, int(z["n"]), z["ops"],
                    z["hitbits"] if "hitbits" in z.files else None,
                    z["hitbits2"] if "hitbits2" in z.files else None,
                    states,
                    {kk: int(v) for kk, v in zip(cum_keys, cum_vals)})
                want = str(z["checksum"]) if "checksum" in z.files \
                    else None
            if want is not None and want != _record_digest(
                    rec.n, rec.ops, rec.hitbits, rec.hitbits2,
                    rec.states, rec.cum):
                # bit-rot / torn write: never serve it — quarantine and
                # miss, so the caller re-resolves the chunk cold
                _stats["disk_errors"] += 1
                _quarantine(path)
                _stats["misses"] += 1
                return None
            os.utime(path)  # LRU recency for the disk evictor
            _stats["disk_hits"] += 1
            _insert_mem(rec)
            return rec
        except (KeyError, ValueError, _BadZipFile):
            # structurally damaged (truncated zip, missing arrays):
            # same treatment as a checksum mismatch
            _stats["disk_errors"] += 1
            _quarantine(path)
        except OSError:
            _stats["disk_errors"] += 1
    _stats["misses"] += 1
    return None


def chunk_len(key: str, idx: int) -> int | None:
    """Length (iterations) of one stored chunk without loading its
    payload — ``None`` when the chunk is absent."""
    rec = _mem.get((key, idx))
    if rec is not None:
        return rec.n
    d = _dir()
    path = _chunk_path(d, key, idx) if d else None
    if path and os.path.exists(path):
        try:
            with np.load(path) as z:
                return int(z["n"])
        except (KeyError, ValueError, _BadZipFile):
            _stats["disk_errors"] += 1
            _quarantine(path)  # unreadable ⇒ the prefix ends here
        except OSError:
            _stats["disk_errors"] += 1
    return None


def put_chunk(rec: ChunkRecord) -> None:
    """Commit one chunk record to the in-process LRU and the disk
    store (atomic file replace; concurrent writers race benignly)."""
    _stats["stores"] += 1
    _insert_mem(rec)
    d = _dir()
    if not d:
        return
    try:
        os.makedirs(d, exist_ok=True)
        payload: dict[str, np.ndarray] = {
            "n": np.int64(rec.n), "ops": rec.ops,
            "cum_keys": np.array(sorted(rec.cum)),
            "cum_vals": np.array([rec.cum[k] for k in sorted(rec.cum)],
                                 dtype=np.int64),
            "checksum": np.array(_record_digest(
                rec.n, rec.ops, rec.hitbits, rec.hitbits2,
                rec.states, rec.cum))}
        if rec.hitbits is not None:
            payload["hitbits"] = rec.hitbits
        if rec.hitbits2 is not None:
            payload["hitbits2"] = rec.hitbits2
        for name, arr in rec.states.items():
            payload["st_" + name] = arr
        final = _chunk_path(d, rec.key, rec.idx)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **payload)
                # crash safety: the rename below must never publish a
                # record whose bytes are still in the page cache only —
                # a torn record after power loss would cost a checksum
                # quarantine + re-resolution on the next run
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        fi = _faults()
        if fi is not None:  # chaos harness: damage the published record
            fi.maybe_corrupt(final, key=rec.key, chunk=rec.idx)
        # amortized eviction: a full directory scan per stored chunk
        # would be O(chunks × files); sweep once per 1/16th of the cap
        global _evict_accum
        _evict_accum += rec.nbytes
        if _evict_accum >= _disk_cap_bytes() // 16:
            _evict_accum = 0
            _evict_disk(d)
    except OSError:
        _stats["disk_errors"] += 1


def prefix(key: str | None,
           chunk_iters: int | None = None) -> tuple[int, int]:
    """The stored contiguous prefix of one artifact:
    ``(full_chunks, avail_iters)``.

    ``full_chunks`` counts leading records of exactly ``chunk_iters``
    iterations — the resume point is ``full_chunks * chunk_iters``
    (a trailing partial record extends ``avail_iters`` for prefix
    *serving* but cannot seed a resume, because its resume state sits
    mid-chunk off the canonical grid; a longer run re-resolves it)."""
    if key is None:
        return 0, 0
    if chunk_iters is None:
        chunk_iters = CHUNK_ITERS
    full = 0
    avail = 0
    idx = 0
    while True:
        n = chunk_len(key, idx)
        if n is None:
            break
        avail += n
        if n < chunk_iters:
            break
        full += 1
        idx += 1
    return full, avail


# ---------------------------------------------------------------------------
# Cache-effect records (v3 ``<key>.eNNNNN.npz``)
# ---------------------------------------------------------------------------

def _effect_path(d: str, key: str, idx: int) -> str:
    return os.path.join(d, f"{key}.e{idx:05d}.npz")


def _effect_digest(stacks: np.ndarray, max_tag: int,
                   n_addrs: int) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(str(stacks.dtype).encode())
    h.update(repr(stacks.shape).encode())
    h.update(np.ascontiguousarray(stacks).tobytes())
    h.update(str(int(max_tag)).encode())
    h.update(str(int(n_addrs)).encode())
    return h.hexdigest()


def put_effect(key: str | None, idx: int,
               effect: tuple[np.ndarray, int], n_addrs: int) -> None:
    """Commit one chunk's cache-effect monoid — the ``(stacks,
    max_tag)`` snapshot of an empty-cache replay — plus the chunk's
    participating-access count.  The record is a pure function of
    (artifact key, chunk index), so an existing file is already correct
    and the write is skipped; damage is caught by the checksum on read.
    Effect records share the chunk store's byte cap and mtime-LRU
    eviction (they are tiny next to the per-op matrices)."""
    d = _dir()
    if key is None or not d or not _cfg.enabled:
        return
    final = _effect_path(d, key, idx)
    if os.path.exists(final):
        return
    stacks, max_tag = effect
    stacks = np.ascontiguousarray(stacks)
    if stacks.size and int(np.abs(stacks).max()) < (1 << 31):
        stacks = stacks.astype(np.int32)  # tags fit: halve the record
    try:
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, stacks=stacks,
                         max_tag=np.int64(max_tag),
                         n_addrs=np.int64(n_addrs),
                         checksum=np.array(_effect_digest(
                             stacks, max_tag, n_addrs)))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        _stats["effect_stores"] += 1
    except OSError:
        _stats["disk_errors"] += 1


def get_effect(key: str | None,
               idx: int) -> tuple[np.ndarray, int, int] | None:
    """Load one stored cache-effect record: ``(stacks, max_tag,
    n_addrs)`` with the stacks widened back to int64, or ``None`` when
    absent.  Damaged records are quarantined and reported as absent —
    the master then falls back to the worker's phase-A message, so a
    bad effect record can never change results."""
    d = _dir()
    if key is None or not d:
        return None
    path = _effect_path(d, key, idx)
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            stacks = z["stacks"]
            max_tag = int(z["max_tag"])
            n_addrs = int(z["n_addrs"])
            want = str(z["checksum"]) if "checksum" in z.files else None
        if want is not None and want != _effect_digest(
                stacks, max_tag, n_addrs):
            _stats["disk_errors"] += 1
            _quarantine(path)
            return None
        os.utime(path)  # LRU recency for the disk evictor
        _stats["effect_hits"] += 1
        return stacks.astype(np.int64), max_tag, n_addrs
    except (KeyError, ValueError, _BadZipFile):
        _stats["disk_errors"] += 1
        _quarantine(path)
    except OSError:
        _stats["disk_errors"] += 1
    return None


class ChunkWriter:
    """Commits canonical-grid chunk records as a live run streams.

    Unlike the v2 whole-run writer, records hit the store the moment
    their chunk completes — an interrupted run keeps every completed
    chunk, and a later run resumes from the last one.  An artifact
    whose full size would blow the ``artifact_mb`` cap (Floyd–
    Warshall's 10⁹-iteration grid) stores only its first
    ``artifact_mb``-worth of chunks: reduced-iteration reruns still
    prefix-serve (zero cold resolution for any run inside the stored
    prefix) and full reruns resume from its end, while the store stays
    bounded."""

    def __init__(self, key: str | None, n_ops: int, n_iters: int,
                 itemsize: int = 4):
        self.key = key
        cap = _cfg.artifact_mb * (1 << 20)
        per_chunk = max(1, n_ops * CHUNK_ITERS * itemsize)
        self.max_chunks = cap // per_chunk
        self.dead = key is None or self.max_chunks == 0
        if key is not None and n_ops * n_iters * itemsize > cap:
            _stats["too_large"] += 1  # truncated to a stored prefix

    def add(self, idx: int, n: int, ops: np.ndarray,
            hitbits: np.ndarray | None = None,
            hitbits2: np.ndarray | None = None,
            states: dict[str, np.ndarray] | None = None,
            cum: dict[str, int] | None = None) -> None:
        if self.dead or idx >= self.max_chunks:
            return
        put_chunk(ChunkRecord(self.key, idx, n, shrink_ops(ops),
                              hitbits, hitbits2,
                              dict(states or {}), dict(cum or {})))


def _scan_store(d: str, suffix: str = ".npz") -> dict[str, tuple]:
    """``path -> (size, mtime)`` for the store's files; entries that
    vanish mid-scan (concurrent evictors) are simply skipped."""
    out: dict[str, tuple] = {}
    for f in os.listdir(d):
        if not f.endswith(suffix):
            continue
        path = os.path.join(d, f)
        try:
            st = os.stat(path)
        except OSError:
            continue
        out[path] = (st.st_size, st.st_mtime)
    return out


def _evict_disk(d: str) -> None:
    """Keep the store under the byte cap, oldest access first."""
    cap = _disk_cap_bytes()
    try:
        stat = _scan_store(d)
        total = sum(sz for sz, _ in stat.values())
        if total <= cap:
            return
        for f in sorted(stat, key=lambda p: stat[p][1]):
            try:
                os.unlink(f)
                total -= stat[f][0]
            except OSError:
                pass
            if total <= cap:
                break
    except OSError:
        pass


def gc(max_bytes: int | None = None) -> dict[str, int]:
    """Garbage-collect the on-disk store.

    Removes **orphans** — files that are not v3 chunk records (v1
    whole-run and v2 per-op ``<key>.npz`` artifacts, v2 ``.json``
    summaries, stray ``.tmp`` files) and effect records whose artifact
    has no chunk records left — then enforces the byte cap
    (``max_bytes`` argument, else ``$REPRO_RESCACHE_MAX_BYTES``, else
    ``disk_mb``) by evicting the least-recently-used chunk files.
    Returns a small report; safe to call concurrently with readers
    (missing files degrade to cache misses)."""
    d = _dir()
    report = {"orphans_removed": 0, "orphan_bytes": 0,
              "evicted": 0, "evicted_bytes": 0, "remaining_bytes": 0}
    if not d or not os.path.isdir(d):
        return report
    cap = max_bytes if max_bytes is not None else _disk_cap_bytes()
    keep: list[str] = []
    effect_files: list[tuple[str, str]] = []  # (key, path)
    chunk_keys: set[str] = set()
    for f in os.listdir(d):
        path = os.path.join(d, f)
        if not os.path.isfile(path):
            continue
        if _CHUNK_RE.match(f):
            keep.append(path)
            chunk_keys.add(f.split(".")[0])
            continue
        if _EFFECT_RE.match(f):
            effect_files.append((f.split(".")[0], path))
            continue
        if f.endswith((".npz", ".json", ".tmp", ".quarantine")):
            try:
                sz = os.path.getsize(path)
                os.unlink(path)
                report["orphans_removed"] += 1
                report["orphan_bytes"] += sz
            except OSError:
                pass
    # effect records ride with their artifact's chunk records: once the
    # last chunk of a key is gone (evicted, cleared), its effects are
    # orphans
    for key, path in effect_files:
        if key in chunk_keys:
            keep.append(path)
            continue
        try:
            sz = os.path.getsize(path)
            os.unlink(path)
            report["orphans_removed"] += 1
            report["orphan_bytes"] += sz
        except OSError:
            pass
    stat = {}
    for path in keep:
        try:
            st = os.stat(path)
        except OSError:
            continue  # raced away: already gone
        stat[path] = (st.st_size, st.st_mtime)
    total = sum(sz for sz, _ in stat.values())
    for path in sorted(stat, key=lambda p: stat[p][1]):
        if total <= cap:
            break
        try:
            os.unlink(path)
            total -= stat[path][0]
            report["evicted"] += 1
            report["evicted_bytes"] += stat[path][0]
        except OSError:
            pass
    report["remaining_bytes"] = total
    return report


def census() -> dict[str, Any]:
    """Store census: artifact count, chunk count, bytes on disk, plus
    the live cold/served chunk counters — what the acceptance checks
    ("a prefix-served rerun performs zero cold resolutions") read."""
    d = _dir()
    keys: set[str] = set()
    chunks = 0
    quarantine_files = 0
    total = 0
    effect_count = 0
    effect_bytes = 0
    if d and os.path.isdir(d):
        for f in os.listdir(d):
            if _CHUNK_RE.match(f):
                keys.add(f.split(".")[0])
                chunks += 1
                try:
                    total += os.path.getsize(os.path.join(d, f))
                except OSError:
                    pass
            elif _EFFECT_RE.match(f):
                effect_count += 1
                try:
                    effect_bytes += os.path.getsize(
                        os.path.join(d, f))
                except OSError:
                    pass
            elif f.endswith(".quarantine"):
                quarantine_files += 1
    try:
        from ..serve import faults as _fa
        injected = _fa.stats()
    except ImportError:  # pragma: no cover
        injected = {}
    return {"dir": d, "artifacts": len(keys), "chunks": chunks,
            "bytes": total,
            "effects": {"count": effect_count, "bytes": effect_bytes,
                        "stores": _stats["effect_stores"],
                        "hits": _stats["effect_hits"]},
            "cold_chunks": _stats["cold_chunks"],
            "served_chunks": _stats["served_chunks"],
            "worker_retries": _stats["worker_retries"],
            "quarantined": _stats["quarantined"],
            "quarantine_files": quarantine_files,
            "serve_failovers": _stats["serve_failovers"],
            "speculated": _stats["speculated"],
            "faults_injected": injected}
