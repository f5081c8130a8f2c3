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
  from them, so both simulators can be fed identical stages;
* :func:`lm_params_to_torch` turns the reference's LM parameter tree
  (nested dicts and lists of numpy arrays, each segment's leaves stacked
  over its repeats) into the port's tree, one entry per repeat, and
  :func:`lm_params_to_numpy` and :func:`lm_cache_to_numpy` stack the
  port's parameters (or grads, or optimiser moments) and decode cache
  back into the reference's layout, so weights, training state and
  caches compare across packages.
  The first and last keep each leaf's dtype: the reference's fp32 leaves (a MoE
  router, Mamba's ``A_log``, RWKV's decay, the SSM states) stay fp32 in
  a bf16 model, and an int8 cache keeps its int8 codes and float16
  scales.
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


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _stack_trees(trees: Sequence[Any]) -> Any:
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return [_stack_trees([t[i] for t in trees])
                for i in range(len(first))]
    return np.stack([_to_numpy(t) for t in trees])


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy in its own dtype; bfloat16, which numpy lacks,
    as float32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def lm_params_to_torch(params: Mapping[str, Any], cfg,
                       device: str | torch.device | None = None
                       ) -> dict[str, Any]:
    """The port's parameter tree from the reference's, as numpy.

    ``params`` is the reference's tree with numpy leaves
    (``jax.tree_util.tree_map(np.asarray, params)``): ``segment_<i>`` is
    a list over the unit's layers whose leaves carry a leading ``repeats``
    axis.  Returns ``segment_<i>[repeat][unit_index]`` trees of tensors on
    ``device`` (default: the port's device policy) in the reference's
    dtypes; every other subtree (embeddings, norms, the ``mtp`` head) is
    carried leaf for leaf.
    """
    dev = get_device(device)

    def leaf(a) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":   # numpy has no bfloat16 of its own
            return torch.from_numpy(a.astype(np.float32)).to(
                dev, torch.bfloat16)
        return torch.from_numpy(np.array(a, order="C")).to(dev)

    out: dict[str, Any] = {}
    segments = {f"segment_{si}": seg for si, seg in enumerate(cfg.segments)}
    for key, sub in params.items():
        if key not in segments:
            out[key] = _tree_map(leaf, sub)
            continue
        seg = segments[key]
        if len(sub) != len(seg.unit):
            raise ValueError(f"{key}: {len(sub)} layers in the unit, the "
                             f"config says {len(seg.unit)}")
        out[key] = [[_tree_map(lambda a, r=r: leaf(np.asarray(a)[r]), layer)
                     for layer in sub] for r in range(seg.repeats)]
    missing = set(segments) - set(out)
    if missing:
        raise KeyError(f"reference params lack {sorted(missing)}")
    return out


def lm_params_to_numpy(params: Mapping[str, Any], cfg) -> dict[str, Any]:
    """The reference's parameter layout from the port's tree, as numpy:
    the inverse of :func:`lm_params_to_torch`.  Each ``segment_<i>``'s
    repeats are stacked on a leading axis (``segment_<i>[unit_index]``);
    every other subtree is carried leaf for leaf.  Takes any tree of the
    params' structure (grads, AdamW's ``mu`` and ``nu``), so the port's
    training state compares leaf by leaf with the reference's; bfloat16
    as float32."""
    segments = {f"segment_{si}" for si in range(len(cfg.segments))}
    return {key: _stack_trees(sub) if key in segments
            else _tree_map(_to_numpy, sub)
            for key, sub in params.items()}


def lm_cache_to_numpy(cache: Mapping[str, Any]) -> dict[str, Any]:
    """The reference's cache layout from the port's: each
    ``segment_<i>[repeat][unit_index]`` tree stacked over its repeats into
    ``segment_<i>[unit_index]`` with a leading repeats axis, as numpy
    arrays in the cache's dtypes (bfloat16 as float32)."""
    return {key: _stack_trees(reps) for key, reps in cache.items()}
