"""Hash-generated trace windows, shared by the Table-I workloads.

The reference benchmark's ``_mix64`` / ``_hash_ints``
(``benchmarks/paper_kernels.py``) unchanged: any window of a full-scale
trace is a pure function of the iteration index, so the port and the
reference generate identical address streams chunk by chunk.
"""

from __future__ import annotations

import numpy as np


def mix64(x: np.ndarray) -> np.ndarray:
    """SplitMix64 finalizer: a pure hash of the iteration index, so any
    trace window can be generated independently and reproducibly."""
    x = (x + np.uint64(0x9E3779B97F4A7C15))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def hash_ints(lo: int, hi: int, bound: int, salt: int) -> np.ndarray:
    """Uniform ints in [0, bound) for iterations [lo, hi)."""
    idx = np.arange(lo, hi, dtype=np.uint64)
    with np.errstate(over="ignore"):
        h = mix64(idx + np.uint64(salt) * np.uint64(0xD1342543DE82EF95))
    return (h % np.uint64(bound)).astype(np.int64)
