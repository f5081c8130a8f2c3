"""The paper's benchmark workloads (§V, Table I), built for the port.
This slice carries SpMV; knapsack, Floyd–Warshall and DFS follow."""

from .spmv import SpmvWorkload, make_spmv

__all__ = ["SpmvWorkload", "make_spmv"]
