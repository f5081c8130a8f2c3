"""State carried across from the reference package into the port.

The reference works on numpy arrays; the port on torch tensors and its
own dataclasses.  These helpers convert plain data only — dicts of numpy
arrays and records with the reference's field names — so nothing here
imports the reference package:

* :func:`spmv_state_to_torch` turns the reference's SpMV state (CSR
  arrays, the BSR blocks from ``csr_to_bsr`` and ``x``) into tensors on a
  named device;
* :func:`stage_records` flattens simulator stages (the reference's
  ``SimStage`` / ``MemAccess``, or the port's — any object with those
  fields) into plain dicts of numpy arrays, and :func:`stages_from_records`
  builds the port's :class:`~repro_torch.core.simulator.SimStage` list
  from them, so both simulators can be fed identical stages.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from ._device import get_device
from .core.simulator import MemAccess, SimStage

#: the reference SpMV state, by key: CSR (indptr, indices, data), BSR
#: (bsr_values, bsr_col_ids) and the dense vector x
SPMV_KEYS = ("indptr", "indices", "data", "bsr_values", "bsr_col_ids", "x")


def spmv_state_to_torch(state: Mapping[str, np.ndarray],
                        device: str | torch.device | None = None,
                        ) -> dict[str, torch.Tensor]:
    """Tensors on ``device`` (default: the port's device policy) for the
    SpMV state keys present in ``state``; dtypes are kept (int32 column
    ids, float32 values)."""
    dev = get_device(device)
    unknown = set(state) - set(SPMV_KEYS)
    if unknown:
        raise KeyError(f"unknown SpMV state keys {sorted(unknown)}; "
                       f"expected some of {SPMV_KEYS}")
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in state.items()}


def stage_records(stages: Sequence[Any],
                  n_iters: int | None = None) -> list[dict]:
    """Plain-dict view of simulator stages: every access's addresses are
    materialized as an int64 numpy array over its first ``n_iters``
    iterations (default: its whole length)."""
    out = []
    for st in stages:
        accs = []
        for a in st.accesses:
            n = len(a) if n_iters is None else min(n_iters, len(a))
            addrs = a.addrs[:n] if a.addrs is not None else np.asarray(
                a.gen(0, n), dtype=np.int64)
            accs.append({"region": a.region, "addrs": np.array(addrs),
                         "is_store": bool(a.is_store),
                         "width": int(getattr(a, "width", 1))})
        out.append({"name": st.name, "ii": int(st.ii),
                    "latency": int(st.latency),
                    "mem_in_scc": bool(st.mem_in_scc), "accesses": accs})
    return out


def stages_from_records(records: Sequence[Mapping[str, Any]]
                        ) -> list[SimStage]:
    """The port's :class:`SimStage` list from :func:`stage_records`
    output (or any records with the same keys)."""
    return [SimStage(
        name=r["name"], ii=int(r["ii"]), latency=int(r["latency"]),
        mem_in_scc=bool(r.get("mem_in_scc", False)),
        accesses=[MemAccess(a["region"], np.asarray(a["addrs"], np.int64),
                            is_store=bool(a.get("is_store", False)),
                            width=int(a.get("width", 1)))
                  for a in r.get("accesses", ())])
        for r in records]
