"""Wire protocol of the resolution daemon: length-prefixed pickled
dicts over a local socket.

The daemon and its clients are cooperating processes of one user on one
machine (the socket is a ``AF_UNIX`` path by default, mode 0700 next to
the store; ``host:port`` selects TCP on localhost for containers whose
filesystems do not share a socket path).  Frames are plain ``pickle``
payloads — numpy arrays (inline ops matrices, packed hit planes) ride
along without copies; the *worker payload* inside a resolve request is
additionally ``cloudpickle``-encoded by the client, because the paper
kernels' trace generators are closures (same convention as the
chunk-graph executor).

Message shapes (all dicts; ``type`` selects):

client → daemon
  ``resolve``   keys, mems, seed, n_iters, chunk_iters, store_dir,
                payload (cloudpickle bytes), weight, req (client id)
  ``solved``    req, solve_wall_s — fold+solve wall, for serve stats
  ``cancel``    req
  ``stats`` / ``ping`` / ``shutdown``

daemon → client
  ``accepted``  req, first_live, committed, dedup{store,inflight,cold}
  ``busy``      retry_after_s (admission control; never queues
                unboundedly)
  ``chunk``     req, idx, cums{model: {draws,hits,misses}},
                inline{model: {ops, hits, visits} | None}
  ``done`` / ``failed`` / ``error`` / ``stats`` / ``pong``
"""

from __future__ import annotations

import hashlib
import os
import pickle
import socket
import struct
import tempfile

#: Frames above this size indicate a protocol bug, not a real message
#: (a full Floyd–Warshall inline chunk is ~100 MB; 1 GiB is paranoia).
MAX_FRAME = 1 << 30

_LEN = struct.Struct("!Q")


class ProtocolError(RuntimeError):
    """Malformed frame or closed-mid-frame peer."""


def send_msg(sock: socket.socket, obj: dict) -> None:
    blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(blob)) + blob)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    parts = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            raise ProtocolError("peer closed mid-frame")
        parts.append(b)
        n -= len(b)
    return b"".join(parts)


def recv_msg(sock: socket.socket) -> dict:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if n > MAX_FRAME:
        raise ProtocolError(f"frame of {n} bytes exceeds MAX_FRAME")
    return pickle.loads(_recv_exact(sock, n))


# -- addresses --------------------------------------------------------------

def is_inet(address: str) -> bool:
    """``host:port`` selects TCP; anything else is an AF_UNIX path."""
    host, sep, port = address.rpartition(":")
    return bool(sep) and port.isdigit() and "/" not in address


def default_address(store_dir: str | None = None) -> str:
    """The canonical daemon socket for one rescache store: a short
    ``AF_UNIX`` path in the temp dir keyed by the store directory (unix
    socket paths are limited to ~100 bytes, so the socket cannot live
    *inside* arbitrarily deep store paths) and the uid (sockets are
    per-user).  One store ⇒ one daemon ⇒ one global scheduler."""
    from ..core import rescache as _rc
    d = store_dir if store_dir is not None else (_rc._dir() or "")
    digest = hashlib.blake2b(os.path.abspath(d).encode(),
                             digest_size=8).hexdigest()
    uid = os.getuid() if hasattr(os, "getuid") else 0
    return os.path.join(tempfile.gettempdir(),
                        f"repro-torch-serve-{uid}-{digest}.sock")


def connect(address: str, timeout: float | None = 30.0) -> socket.socket:
    if is_inet(address):
        host, _, port = address.rpartition(":")
        s = socket.create_connection((host or "127.0.0.1", int(port)),
                                     timeout=timeout)
    else:
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.settimeout(timeout)
        s.connect(address)
    s.settimeout(None)
    return s


def listen(address: str) -> socket.socket:
    if is_inet(address):
        host, _, port = address.rpartition(":")
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host or "127.0.0.1", int(port)))
    else:
        try:
            os.unlink(address)
        except OSError:
            pass
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        s.bind(address)
        os.chmod(address, 0o700)
    s.listen(64)
    return s
