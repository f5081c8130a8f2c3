"""The wavefront solver's running maximum as a hand-written CUDA kernel,
and the host round trip that feeds it.

``running_max`` is the exact inclusive max-scan the cycle simulator's
solver runs per stage and chunk (``start[i] = max(b[i], start[i-1] +
c[i])`` becomes a running max over ``b - cumsum(c)``).  See
``csrc/running_max.cu`` for the single-pass look-back design: one launch
per call, one read and one write of the array.

The solver's arrays live on the host, so on the card each call is a
round trip (:func:`running_max_host`), and the copies cost far more than
the scan.  The round trip is the template's decoupling over PCIe: the
array is copied once into a pinned buffer, goes up and comes back in
chunks of :data:`CHUNK` values, and is copied once out of a second
pinned buffer; buffers, streams and events are kept across calls.  One
C call enqueues every chunk: chunk k+1's upload runs on a copy stream
while chunk k is scanned on the current stream and chunk k−1's download
runs on another, events ordering the three; each chunk's scan folds in
the previous chunk's last output, a device cell, so the chunks need no
second pass.  On the CPU the same chunks and carries run the plain
version.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import _lib, ref

_ENTRY = {torch.int64: "running_max_i64", torch.int32: "running_max_i32"}
_TRIP = {torch.int64: "running_max_round_trip_i64",
         torch.int32: "running_max_round_trip_i32"}
#: values a tile of the kernel holds: 256 threads x 8 loads of 16 bytes
_TILE = {torch.int64: 4096, torch.int32: 8192}

#: values per chunk of the host round trip (2^20 values: four chunks)
CHUNK = 1 << 18

#: (device index, stream) -> the kernel's look-back state: 16 bytes of
#: counters and 16 per tile, zeroed when made, left zeroed by every launch
_STATES: dict[tuple[int, int], torch.Tensor] = {}


def _state(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """The zeroed state of the current stream, with room for ``x``'s
    tiles, and that room in tiles.  One state per stream, because two
    launches that share one must not overlap."""
    need = -(-x.shape[0] // _TILE[x.dtype])
    key = (x.device.index, _lib.stream())
    state = _STATES.get(key)
    if state is None or state.numel() // 2 - 1 < need:
        tiles = 1 << max(need - 1, 0).bit_length()
        state = torch.zeros(2 * (tiles + 1), dtype=torch.int64,
                            device=x.device)
        _STATES[key] = state
    return state, state.numel() // 2 - 1


def running_max(x: torch.Tensor, *, carry: torch.Tensor | None = None,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """Inclusive running maximum of a 1-D int64 or int32 tensor.

    ``carry`` (one value of x's dtype on x's device, or None) is folded
    in front of ``x``; ``out`` (x's shape and dtype) receives the result
    if given.  A CPU tensor takes the plain version
    (:func:`ref.running_max_ref`); a CUDA tensor launches the kernel, once,
    or raises.
    """
    if x.ndim != 1 or x.dtype not in _ENTRY:
        raise TypeError(f"running_max takes a 1-D int64 or int32 tensor, "
                        f"got {x.dtype} of shape {tuple(x.shape)}")
    if carry is not None and (carry.numel() != 1 or carry.dtype != x.dtype
                              or carry.device != x.device):
        raise ValueError("running_max: carry is one value of x's dtype on "
                         "x's device")
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.device != x.device):
        raise ValueError("running_max: out must match x")
    if x.device.type == "cpu":
        got = ref.running_max_ref(x, carry)
        return got if out is None else out.copy_(got)
    if x.device.type != "cuda":
        raise ValueError(f"running_max: unsupported device {x.device}")
    out = torch.empty_like(x) if out is None else out
    if not (x.is_contiguous() and out.is_contiguous()):
        raise ValueError("running_max kernel takes contiguous tensors")
    if x.shape[0] == 0:
        return out
    with torch.cuda.device(x.device):
        state, room = _state(x)
        err = getattr(_lib.lib("running_max"), _ENTRY[x.dtype])(
            x.data_ptr(), out.data_ptr(),
            None if carry is None else carry.data_ptr(), state.data_ptr(),
            room, x.shape[0], _lib.stream())
        _lib.LAUNCHES["running_max"] += 1
    _lib.check("running_max", err)
    return out


@dataclasses.dataclass
class _Staging:
    """The round trip's buffers on one device for one dtype: pinned host
    buffers and device buffers of ``capacity`` values, two copy streams,
    two events a chunk and one for the last download."""

    capacity: int
    pinned_in: torch.Tensor
    pinned_out: torch.Tensor
    dev_in: torch.Tensor
    dev_out: torch.Tensor
    up: torch.cuda.Stream
    down: torch.cuda.Stream
    events: list[torch.cuda.Event]
    handles: ctypes.Array          # the events' handles, for the C call
    done: torch.cuda.Event


_STAGING: dict[tuple[int | None, torch.dtype], _Staging] = {}


def _staging(device: torch.device, dtype: torch.dtype, n: int) -> _Staging:
    key = (device.index, dtype)
    st = _STAGING.get(key)
    if st is None or st.capacity < n:
        cap = max(CHUNK, 1 << (n - 1).bit_length())
        streams = (st.up, st.down) if st else (torch.cuda.Stream(device),
                                               torch.cuda.Stream(device))
        events = [torch.cuda.Event() for _ in range(2 * (-(-cap // CHUNK)))]
        done = torch.cuda.Event()
        for ev in (*events, done):
            ev.record()                     # creates the CUDA event
        st = _Staging(
            cap, torch.empty(cap, dtype=dtype, pin_memory=True),
            torch.empty(cap, dtype=dtype, pin_memory=True),
            torch.empty(cap, dtype=dtype, device=device),
            torch.empty(cap, dtype=dtype, device=device), *streams, events,
            (ctypes.c_void_p * len(events))(*[e.cuda_event for e in events]),
            done)
        _STAGING[key] = st
    return st


def _chunks(n: int) -> list[tuple[int, int]]:
    return [(lo, min(lo + CHUNK, n)) for lo in range(0, n, CHUNK)]


def running_max_host(a: np.ndarray, device: torch.device) -> np.ndarray:
    """In-place inclusive running maximum of a 1-D int64 or int32 numpy
    array, scanned on ``device`` in chunks of :data:`CHUNK` values, each
    carrying in the previous chunk's last output.

    On a CUDA device: one host copy into a pinned buffer, then the
    chunks' uploads, scans (one launch each) and downloads overlapped on
    three streams, then one host copy out of the second pinned buffer.
    On the CPU: the same chunks and carries through the plain version.
    Exact; returns ``a``.
    """
    if a.ndim != 1 or a.dtype not in (np.int64, np.int32):
        raise TypeError(f"running_max_host takes a 1-D int64 or int32 "
                        f"array, got {a.dtype} of shape {a.shape}")
    buf = np.ascontiguousarray(a)
    host = torch.from_numpy(buf)
    if buf.size == 0:
        return a
    if device.type == "cpu":
        for lo, hi in _chunks(a.size):
            running_max(host[lo:hi], carry=host[lo - 1:lo] if lo else None,
                        out=host[lo:hi])
    else:
        _round_trip(host, device)
    if buf is not a:
        a[:] = buf
    return a


def _round_trip(host: torch.Tensor, device: torch.device) -> None:
    n = host.shape[0]
    st = _staging(device, host.dtype, n)
    st.pinned_in[:n].copy_(host)
    launches = ctypes.c_int(0)
    with torch.cuda.device(device):
        state, room = _state(st.dev_in[:min(n, CHUNK)])
        err = getattr(_lib.lib("running_max"), _TRIP[host.dtype])(
            st.pinned_in.data_ptr(), st.dev_in.data_ptr(),
            st.dev_out.data_ptr(), st.pinned_out.data_ptr(),
            state.data_ptr(), room, n, CHUNK, st.up.cuda_stream,
            _lib.stream(), st.down.cuda_stream, st.handles,
            st.done.cuda_event, ctypes.byref(launches))
        _lib.LAUNCHES["running_max"] += launches.value
    _lib.check("running_max", err)
    st.done.synchronize()
    host.copy_(st.pinned_out[:n])
