"""The paper's benchmark workloads (§V, Table I), built for the port:
SpMV, knapsack, Floyd–Warshall and DFS, each with the reference
benchmark's seeded data and traces and a loop body written in torch."""

from .base import PaperWorkload
from .dfs import make_dfs
from .floyd_warshall import make_floyd_warshall
from .knapsack import make_knapsack
from .spmv import make_spmv

#: name -> maker, in the reference's order (``benchmarks/paper_kernels.py``)
ALL_KERNELS = {
    "spmv": make_spmv,
    "knapsack": make_knapsack,
    "floyd_warshall": make_floyd_warshall,
    "dfs": make_dfs,
}

__all__ = ["ALL_KERNELS", "PaperWorkload", "make_dfs", "make_floyd_warshall",
           "make_knapsack", "make_spmv"]
