"""The backend-switchable resolution engine.

The simulator's hot loops — the "last N distinct lines" recency-stack
monoid, the segmented N-way LRU replay, and the wavefront solver's
running-max sweeps — are all scan-shaped.  This module holds one
implementation of each per backend and a tiny selection layer:

* ``REPRO_TORCH_ENGINE=auto|numpy|torch`` picks the backend process-wide
  (``auto`` is the default: ``torch`` when the port's device policy
  names a CUDA device and one is present, numpy otherwise);
* :func:`use` overrides it per call (the ``engine=`` keyword on the
  ``simulate_*`` entry points), :func:`select` process-wide;
* explicit ``torch`` runs on the port's device (:mod:`repro_torch._device`):
  the CUDA kernel on the card, the kernel's plain PyTorch version when the
  caller asked for the CPU, and an error when CUDA is asked for and absent.

Every kernel here is exact integer arithmetic; backends may only differ
in wall clock, never in results.  The running max and the N-way replay
core have torch forms.  Below ``JIT_MIN_ELEMS`` scan elements the running
max keeps the numpy form on every backend (the host↔device round trip
dominates tiny calls); below ``JIT_MIN_SEGMENTS`` segments the N-way core
does so when the engine was auto-selected, while a torch engine asked
for by name (:func:`use`, :func:`select`, ``$REPRO_TORCH_ENGINE``) takes
the torch core at every size.  ``lru_insert`` and ``stack_compose`` are
the numpy monoid the other simulator paths share.

The module also owns the per-phase wall-clock accounting
(:func:`phase` / :func:`walls`) that attributes time to the effect /
replay / fold / solve phases.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np

from .._device import default_device_type, get_device

__all__ = [
    "current", "select", "use",
    "phase", "walls", "reset_walls", "merge_walls",
    "running_max", "nway_core", "lru_insert", "stack_compose",
    "counts", "reset_counts",
]

_VALID = ("auto", "numpy", "torch")

#: per-call / process-wide override installed by :func:`use` /
#: :func:`select`; ``None`` defers to ``$REPRO_TORCH_ENGINE``
_forced: str | None = None

#: below this many scan elements the numpy running max is kept on every
#: backend (the host↔device round trip outweighs the kernel)
JIT_MIN_ELEMS = 1 << 15

#: below this many segments the numpy N-way core is kept likewise, unless
#: torch was asked for by name
JIT_MIN_SEGMENTS = 1 << 9

#: calls of each torch form since :func:`reset_counts` (the smoke reads
#: them to prove that a path went through the torch core)
_COUNTS: dict[str, int] = {"nway_core": 0}


def _env_choice() -> str:
    v = (os.environ.get("REPRO_TORCH_ENGINE") or "auto").strip().lower()
    return v if v in _VALID else "auto"


def current() -> str:
    """The engine this call site resolves to: ``"numpy"`` or ``"torch"``.

    Order: :func:`use`/:func:`select` override, then
    ``$REPRO_TORCH_ENGINE``, then ``auto`` — which picks torch only when
    the device policy names CUDA and a CUDA device is present.
    """
    choice = _forced or _env_choice()
    if choice == "auto":
        import torch
        if default_device_type() == "cuda" and torch.cuda.is_available():
            return "torch"
        return "numpy"
    return choice


def _explicit() -> bool:
    """True when torch was asked for by name (override or env) rather
    than auto-selected: explicit selections bypass the size thresholds
    of the N-way core."""
    return (_forced or _env_choice()) == "torch"


def counts() -> dict[str, int]:
    return dict(_COUNTS)


def reset_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def select(name: str | None) -> None:
    """Process-wide engine selection (``None`` reverts to the env)."""
    global _forced
    if name is not None and name not in _VALID:
        raise ValueError(f"unknown engine {name!r}; pick from {_VALID}")
    _forced = name


@contextlib.contextmanager
def use(name: str | None):
    """Scoped engine override — the ``engine=`` keyword of the
    ``simulate_*`` entry points.  ``None`` is a no-op."""
    if name is None:
        yield
        return
    if name not in _VALID:
        raise ValueError(f"unknown engine {name!r}; pick from {_VALID}")
    global _forced
    prev = _forced
    _forced = name
    try:
        yield
    finally:
        _forced = prev


# ---------------------------------------------------------------------------
# Per-phase wall-clock accounting
# ---------------------------------------------------------------------------

#: phase name -> accumulated seconds in this process
_WALLS: dict[str, float] = {}


@contextlib.contextmanager
def phase(name: str):
    """Accumulate the wall clock of the enclosed block under ``name``
    (effect / replay / fold / solve are the canonical phases)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _WALLS[name] = _WALLS.get(name, 0.0) \
            + time.perf_counter() - t0


def walls() -> dict[str, float]:
    return dict(_WALLS)


def reset_walls() -> None:
    _WALLS.clear()


def merge_walls(other: dict[str, float] | None) -> None:
    for k, v in (other or {}).items():
        _WALLS[k] = _WALLS.get(k, 0.0) + float(v)


# ---------------------------------------------------------------------------
# Running max (the wavefront solver's serial recurrence)
# ---------------------------------------------------------------------------

#: block width of the dominated-block numpy running max — big enough
#: that the per-block bookkeeping vanishes, small enough that one block
#: sits in L1
_RMAX_BLOCK = 4096


def _running_max_np(a: np.ndarray) -> np.ndarray:
    """In-place inclusive running max, skipping dominated blocks.

    ``np.maximum.accumulate`` is a serial scalar loop.  The solver's
    arrays are ``b - cumsum(c)`` shapes that trend *down* (the paper's
    pipelines are mostly self-recurrence-bound), so most blocks never
    beat the carry from the left: per-block maxima are computed
    vectorized, blocks whose max is dominated by the incoming carry are
    filled with the carry constant, and only the rest pay the scalar
    accumulate.
    """
    n = a.size
    B = _RMAX_BLOCK
    if n < 2 * B or not a.flags.c_contiguous:
        np.maximum.accumulate(a, out=a)
        return a
    nb = n // B
    m2 = a[:nb * B].reshape(nb, B)
    M = m2.max(axis=1)
    C = np.maximum.accumulate(M)
    np.maximum.accumulate(m2[0], out=m2[0])
    need = np.nonzero(M[1:] > C[:-1])[0] + 1
    for i in need:
        row = m2[i]
        np.maximum.accumulate(row, out=row)
        np.maximum(row, C[i - 1], out=row)
    dom = np.ones(nb, dtype=bool)
    dom[0] = False
    dom[need] = False
    if dom.any():
        m2[dom] = C[np.nonzero(dom)[0] - 1, None]
    tail = a[nb * B:]
    if tail.size:
        np.maximum.accumulate(tail, out=tail)
        np.maximum(tail, C[-1], out=tail)
    return a


def running_max(a: np.ndarray) -> np.ndarray:
    """In-place inclusive running maximum of a 1-D integer array.

    On the torch engine (at or above ``JIT_MIN_ELEMS``) the array makes
    the chunked round trip of :func:`~repro_torch.kernels.scan.running_max_host`
    to the port's device: pinned staging, uploads and downloads
    overlapped with the CUDA kernel's scans (on the CPU, the plain
    version's) — there is no fallback: a failed launch raises.  Otherwise
    the dominated-block numpy form runs; both are exact, so results never
    depend on the engine.
    """
    if a.size >= JIT_MIN_ELEMS and current() == "torch":
        from ..kernels.scan import running_max_host
        return running_max_host(a, get_device())
    return _running_max_np(a)


# ---------------------------------------------------------------------------
# The recency-stack monoid
# ---------------------------------------------------------------------------

def lru_insert(stk: np.ndarray, x: np.ndarray) -> np.ndarray:
    """One LRU step over per-row recency stacks.

    ``stk`` is ``(rows, ways)`` with slot 0 the MRU tag (−1 = empty);
    ``x`` is one tag per row (−2 = inactive row this round).  Returns
    the updated stacks: a present tag rotates to the front, an absent
    one shifts the whole stack (evicting the last slot).
    """
    ways = stk.shape[1]
    cmp = stk == x[:, None]
    found = cmp.any(axis=1)
    # rotate depth: the hit way, or the whole stack on a miss
    j = np.where(found, np.argmax(cmp, axis=1), ways - 1)
    j[x == -2] = -1  # inactive rows rotate nothing
    shifted = np.empty_like(stk)
    shifted[:, 1:] = stk[:, :-1]
    shifted[:, 0] = x
    return np.where(np.arange(ways) <= j[:, None], shifted, stk)


def stack_compose(older: np.ndarray, newer: np.ndarray) -> np.ndarray:
    """Compose two recency stacks: ``newer`` applied after ``older``.

    The "last N distinct lines" monoid: the result is ``newer``'s tags
    followed by ``older``'s tags not already present, truncated to N.
    Associative — tags pushed past slot N can never resurface.
    """
    rows, ways = newer.shape
    nb = (newer >= 0).sum(axis=1)
    in_newer = (older[:, :, None] == newer[:, None, :]).any(axis=2)
    keep = (older >= 0) & ~in_newer
    tgt = nb[:, None] + np.cumsum(keep, axis=1) - 1
    out = newer.copy()
    mask = keep & (tgt < ways)
    r_idx = np.broadcast_to(np.arange(rows)[:, None], tgt.shape)
    out[r_idx[mask], tgt[mask]] = older[mask]
    return out


# ---------------------------------------------------------------------------
# The segmented N-way replay core
# ---------------------------------------------------------------------------

def _nway_core_np(T: np.ndarray, seg_grp: np.ndarray,
                  seg_first: np.ndarray, carried: np.ndarray,
                  max_run: int) -> tuple[np.ndarray, np.ndarray]:
    """numpy form of :func:`nway_core` (see there for the contract) —
    pass A, the segmented Hillis–Steele compose, pass B."""
    W, G = T.shape
    ways = carried.shape[1]
    # pass A: per-segment own stacks, replayed from empty
    stk = np.full((G, ways), -1, dtype=T.dtype)
    for r in range(W):
        stk = lru_insert(stk, T[r])
    # incoming[g] = carried ∘ own[first..g-1]: inclusive segmented scan
    # over E = [carried at set-first segments, own[g-1] elsewhere]
    E = np.empty_like(stk)
    E[1:] = stk[:-1]
    E[seg_first] = carried[seg_grp[seg_first]]
    d = 1
    while d < max_run:
        composed = stack_compose(E[:-d], E[d:])
        valid = seg_grp[d:] == seg_grp[:-d]
        E[d:] = np.where(valid[:, None], composed, E[d:])
        d *= 2
    # pass B: replay from the incoming stacks, recording hits
    HIT = np.empty((W, G), dtype=bool)
    stk = E
    for r in range(W):
        x = T[r]
        HIT[r] = (stk == x[:, None]).any(axis=1) & (x != -2)
        stk = lru_insert(stk, x)
    return HIT, stk


def _insert_torch(stk, x, ways_ar):
    """:func:`lru_insert` on tensors; also returns the per-row "tag
    present" flags, which pass B records as hits."""
    import torch
    cmp = stk == x[:, None]
    found = cmp.any(dim=1)
    # argmax takes no bool on CUDA; a stack's valid tags are distinct, so
    # a found row has exactly one match
    j = torch.where(found, cmp.to(torch.uint8).argmax(dim=1),
                    stk.shape[1] - 1)
    j = torch.where(x == -2, -1, j)
    shifted = torch.cat([x[:, None], stk[:, :-1]], dim=1)
    return torch.where(ways_ar[None, :] <= j[:, None], shifted, stk), found


def _compose_torch(older, newer, ways_ar):
    """:func:`stack_compose` in the gather form: ``out[:, w]`` takes the
    one column of ``older`` kept at target ``w``, else ``newer[:, w]`` —
    no boolean-mask indexing, so no shape depends on the data."""
    import torch
    ways = newer.shape[1]
    nb = (newer >= 0).sum(dim=1)
    in_newer = (older[:, :, None] == newer[:, None, :]).any(dim=2)
    keep = (older >= 0) & ~in_newer
    tgt = nb[:, None] + keep.cumsum(dim=1) - 1
    sel = keep & (tgt < ways)
    hitm = sel[:, None, :] & (tgt[:, None, :] == ways_ar[None, :, None])
    has = hitm.any(dim=2)
    src = hitm.to(torch.uint8).argmax(dim=2)
    return torch.where(has, torch.gather(older, 1, src), newer)


def _nway_core_torch(T: np.ndarray, seg_grp: np.ndarray,
                     seg_first: np.ndarray, carried: np.ndarray,
                     max_run: int) -> tuple[np.ndarray, np.ndarray]:
    """The torch form of :func:`nway_core` on the port's device: the same
    pass A, segmented Hillis–Steele compose and pass B as the numpy form,
    on tensors of ``T``'s dtype (int32, or int64 once tags pass 2^31).
    The inputs go to the device once and ``HIT`` and the stacks come back
    once; nothing in between waits for the host."""
    import torch
    dev = get_device()
    _COUNTS["nway_core"] += 1
    W, G = T.shape
    ways = carried.shape[1]
    Tt = torch.from_numpy(np.ascontiguousarray(T)).to(dev)
    sg = torch.from_numpy(seg_grp.astype(np.int64)).to(dev)
    sf = torch.from_numpy(np.ascontiguousarray(seg_first)).to(dev)
    ca = torch.from_numpy(np.ascontiguousarray(carried)).to(dev)
    ways_ar = torch.arange(ways, device=dev)
    # pass A: per-segment own stacks, replayed from empty
    stk = torch.full((G, ways), -1, dtype=Tt.dtype, device=dev)
    for r in range(W):
        stk, _ = _insert_torch(stk, Tt[r], ways_ar)
    # incoming stacks: carried at set-first segments, own[g-1] elsewhere,
    # then the segmented scan
    E = torch.cat([stk[:1], stk[:-1]], dim=0)
    E = torch.where(sf[:, None], ca[sg], E)
    d = 1
    while d < max_run:
        valid = sg[d:] == sg[:-d]
        E[d:] = torch.where(valid[:, None],
                            _compose_torch(E[:-d], E[d:], ways_ar), E[d:])
        d *= 2
    # pass B: replay from the incoming stacks, recording hits
    HIT = torch.empty((W, G), dtype=torch.bool, device=dev)
    stk = E
    for r in range(W):
        x = Tt[r]
        stk, found = _insert_torch(stk, x, ways_ar)
        HIT[r] = found & (x != -2)
    return HIT.cpu().numpy(), stk.cpu().numpy()


def nway_core(T: np.ndarray, seg_grp: np.ndarray, seg_first: np.ndarray,
              carried: np.ndarray, max_run: int,
              ) -> tuple[np.ndarray, np.ndarray]:
    """The segmented N-way LRU replay over pre-cut segments.

    ``T`` is ``(W, G)``: per-segment tag columns, −2 where inactive;
    ``seg_grp`` maps each segment to its touched-set row in ``carried``
    (the incoming recency stacks, MRU first); ``seg_first`` flags each
    set's first segment; ``max_run`` is the longest per-set segment
    run.  Returns ``(HIT, final)`` — per-position hit flags and each
    segment's outgoing stack (the caller keeps only each set's last).

    Pass A replays each segment's own stack from empty, a segmented
    Hillis–Steele compose gives each segment its incoming stack, and
    pass B replays from there recording hits.  The torch engine runs the
    torch form at ``JIT_MIN_SEGMENTS`` segments or more, and at every
    size when torch was asked for by name; both forms are bit-identical
    (integer compares and shifts only).
    """
    G = T.shape[1]
    if current() == "torch" and (G >= JIT_MIN_SEGMENTS or _explicit()):
        return _nway_core_torch(T, seg_grp, seg_first, carried, max_run)
    return _nway_core_np(T, seg_grp, seg_first, carried, max_run)
