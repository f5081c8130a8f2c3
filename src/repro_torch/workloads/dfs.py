"""Table-I DFS (4000 nodes × 200 neighbors, ≈3 MB) for the port — the
stack is a memory SCC.

The numpy parts are the reference benchmark's ``make_dfs``
(``benchmarks/paper_kernels.py``) unchanged: the same seeded adjacency,
the same window traces and the same hash-generated full-scale traces.
The loop body is one DFS step (pop, mark, push the first unvisited
neighbor), written in torch; the stores are
:func:`~repro_torch.core.cdfg.at_set`, the port's ``x.at[i].set``.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import get_device
from ..core.cdfg import at_set
from ..core.simulator import MemAccess
from .base import PaperWorkload, i32
from .hashing import hash_ints


def make_dfs(scale: float = 0.25, seed: int = 3,
             device: str | torch.device | None = None) -> PaperWorkload:
    """``scale=1.0`` is Table-I size; ``scale`` only shrinks the graph,
    the traces are always full-scale."""
    dev = get_device(device)
    n_nodes = max(64, int(4000 * scale))
    n_nbrs = max(8, int(200 * scale))
    rng = np.random.default_rng(seed)
    adj = rng.integers(0, n_nodes, size=(n_nodes, n_nbrs)).astype(np.int32)
    adj_t = torch.from_numpy(adj.reshape(-1)).to(dev)

    def loop_body(carry, _):
        # one DFS step: pop, mark, push first unvisited neighbor.
        stack, visited, sp = carry
        node = stack[sp - 1]                       # load through the stack
        visited = at_set(visited, node, 1)         # store visited
        nb = adj_t[node * n_nbrs]                  # load adjacency
        seen = visited[nb]                         # load visited[nb]
        push = 1 - seen
        stack = at_set(stack, sp, nb)              # store through the stack
        sp = sp - 1 + push
        return (stack, visited, sp)

    # FULL-scale trace (4000 nodes x 200 nbrs ~ 3 MB adjacency)
    nf_nodes, nf_nbrs = 4000, 200
    trng = np.random.default_rng(seed + 100)
    m = 40_000
    nodes = trng.integers(0, nf_nodes, m).astype(np.int64)
    traces = {
        "stack": MemAccess("stack",
                           (trng.integers(0, 64, m) * 4).astype(np.int64)),
        "adj": MemAccess("adj", (nodes * nf_nbrs * 4) + (1 << 24)),
        "visited": MemAccess("visited", nodes * 4 + (1 << 23)),
    }

    n_full = nf_nodes * nf_nbrs

    def _g_nodes(lo, hi):
        return hash_ints(lo, hi, nf_nodes, seed + 100)

    full_traces = {
        "stack": MemAccess(
            "stack", gen=lambda lo, hi: hash_ints(lo, hi, 64, seed + 7) * 4,
            length=n_full),
        "adj": MemAccess(
            "adj",
            gen=lambda lo, hi: _g_nodes(lo, hi) * (nf_nbrs * 4) + (1 << 24),
            length=n_full),
        "visited": MemAccess(
            "visited", gen=lambda lo, hi: _g_nodes(lo, hi) * 4 + (1 << 23),
            length=n_full),
    }

    return PaperWorkload(
        name="dfs",
        loop_body=loop_body,
        carry_example=(torch.zeros(n_nodes * 4, dtype=torch.int32,
                                   device=dev),
                       torch.zeros(n_nodes, dtype=torch.int32, device=dev),
                       i32(1, dev)),
        body_args=(i32(0, dev),),
        traces=traces,
        full_traces=full_traces,
        n_iters_full=n_full,
        n_iters_sim=m,
        instrs_per_iter=14.0,
        device=dev,
        data={"adj": adj},
        mem_in_scc_regions=("arg0", "stack"),
        expected=None,
    )
