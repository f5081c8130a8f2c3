"""Rank functions for the port's multi-rank tests.

``repro_torch.launch.mesh.spawn`` starts each rank in a fresh
interpreter, which imports the function by name: they live here, in a
module that imports torch and the port only (no jax, no ``repro``).
Inputs arrive as numpy arrays; every rank returns its results to the
test process, which holds them against the reference.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import _device, tree
from repro_torch.core import pipeline_apply, pipeline_apply_emulated
from repro_torch.core import collectives
from repro_torch.core.collectives import Collectives


def tanh_linear(w, x):
    """The reference's ``tests/test_multidevice.py:60`` stage."""
    return torch.tanh(x @ w)


def mini_block(p, x):
    """The reference's ``tests/test_multidevice.py:121`` stage: one mini
    transformer block, x (B, L, D)."""
    h = torch.tanh(x @ p["w_qkv"])
    return x + torch.tanh(h @ p["w_ff"])


STAGES = {"tanh_linear": tanh_linear, "mini_block": mini_block}


def _tensors(arrays, device, requires_grad=False):
    return tree.tree_map(
        lambda a: torch.tensor(a, device=device, requires_grad=requires_grad),
        arrays)


def gpipe(stage: str, params, mbs, grad: bool = True) -> dict:
    """``pipeline_apply`` of ``STAGES[stage]`` over the world; with
    ``grad``, also this rank's share of the gradient of ``mean(y²)``
    (the parameters' and the microbatches')."""
    dev = _device.get_device()
    fn = STAGES[stage]
    p = _tensors(params, dev, grad)
    x = _tensors(mbs, dev, grad)
    y = pipeline_apply(fn, p, x)
    out = {"y": y.detach(), "rank": dist.get_rank()}
    if grad:
        leaves = tree.leaves(p)
        g = torch.autograd.grad((y ** 2).mean(), [*leaves, x])
        out["grads"] = tree.unflatten(p, list(g[:-1]))
        out["g_mbs"] = g[-1]
    return out


def gpipe_on_subgroup(stage: str, params, mbs, ranks: list[int]) -> dict:
    """``pipeline_apply`` over a subgroup ``ranks`` of the world; the
    other ranks only take part in creating the group."""
    group = dist.new_group(ranks)
    if dist.get_rank() not in ranks:
        return {}
    dev = _device.get_device()
    p = _tensors(params, dev, True)
    y = pipeline_apply(STAGES[stage], p, _tensors(mbs, dev), group=group)
    g = torch.autograd.grad((y ** 2).mean(), tree.leaves(p))
    return {"y": y.detach(), "grads": tree.unflatten(p, list(g))}


def emulated(stage: str, params, mbs, num_stages: int) -> dict:
    """``pipeline_apply_emulated`` and the grad of ``mean(y²)`` on this
    rank alone (the single-device oracle, for the ``cuda`` tests)."""
    dev = _device.get_device()
    p = _tensors(params, dev, True)
    y = pipeline_apply_emulated(STAGES[stage], p, _tensors(mbs, dev),
                                num_stages)
    g = torch.autograd.grad((y ** 2).mean(), tree.leaves(p))
    return {"y": y.detach(), "grads": tree.unflatten(p, list(g))}


def _quickstart_kernel(table, idx, w):
    g = table[idx]
    h = g * w
    return torch.tanh(h) + 1.0


def _two_streams(table, idx, scale):
    return table[idx] * scale


KERNELS = {"quickstart": _quickstart_kernel, "two_streams": _two_streams}


def systolic(kernel: str, args, stream_argnums: tuple) -> dict:
    """``SystolicPipeline.build_sharded`` over the world on ``args``
    (stream args with a leading microbatch axis), compiled from the
    first microbatch; the stage count and outputs."""
    from repro_torch.core import SystolicPipeline
    from repro_torch.dataflow import compile as dcompile
    dev = _device.get_device()
    args = [torch.as_tensor(a, device=dev) for a in args]
    example = [a[0] if i in stream_argnums else a
               for i, a in enumerate(args)]
    c = dcompile(KERNELS[kernel], *example, stream_argnums=stream_argnums)
    pipe = SystolicPipeline(c.program, stream_argnums)
    outs = pipe.build_sharded()(*args)
    return {"stages": pipe.num_stages, "outs": outs,
            "emulated": pipe.run_emulated(*args)}


def backends(table, idx, w, stream) -> dict:
    """The quickstart kernel through every execute backend, a stream
    through the sharded pipeline, and the systolic backend's route."""
    from repro_torch.dataflow import compile as dcompile, execute_backends
    dev = _device.get_device()
    table, idx, w, stream = (torch.as_tensor(a, device=dev)
                             for a in (table, idx, w, stream))
    c = dcompile(_quickstart_kernel, table, idx, w, stream_argnums=(1,))
    got = {name: c(table, idx, w, backend=name)
           for name in execute_backends()}
    run = c.schedule.pipeline.build_sharded()
    return {"available": c.backends(), "stages": c.num_stages,
            "direct": _quickstart_kernel(table, idx, w), "got": got,
            "stream": run(table, stream, w)[0],
            "route": Collectives(None, dev).route}


def staged_gather(idx, table) -> dict:
    """``decoupled_gather_staged`` on the ``systolic`` backend, beside the
    port's plain ``decoupled_gather_ref``."""
    from repro_torch.kernels import (decoupled_gather_ref,
                                     decoupled_gather_staged)
    dev = _device.get_device()
    idx, table = (torch.as_tensor(idx, device=dev),
                  torch.as_tensor(table, device=dev))
    return {"got": decoupled_gather_staged(idx, table, backend="systolic"),
            "plain": decoupled_gather_ref(idx, table)}


def compress(xs, chunk: int = 256) -> dict:
    """Rank r's ``compressed_psum`` of ``xs[r]`` (and of a dict of two
    leaves through ``compress_tree_psum``), beside the fp32 psum."""
    from repro_torch.optim.compress import (compress_tree_psum,
                                            compressed_psum)
    dev = _device.get_device()
    r = dist.get_rank()
    x = torch.as_tensor(xs[r], device=dev)
    comm = Collectives(None, dev)
    tree_in = {"a": x, "b": x[:3] * 2}
    out = {"got": compressed_psum(x, chunk=chunk), "plain": comm.psum(x),
           "tree": compress_tree_psum(tree_in, chunk=chunk),
           "b": compressed_psum(tree_in["b"], chunk=chunk)}
    # the same calls again stage through the buffers pinned already
    pinned = len(collectives._PINNED)
    compressed_psum(x, chunk=chunk)
    compress_tree_psum(tree_in, chunk=chunk)
    out["pinned"] = (pinned, len(collectives._PINNED))
    return out


def ring(values, hops: int) -> dict:
    """``ppermute`` of this rank's row of ``values`` forward and back, and
    the collectives' results, on the ring of the world."""
    dev = _device.get_device()
    comm = Collectives(None, dev)
    x = torch.as_tensor(values[comm.rank], device=dev)
    fwd = x
    for _ in range(hops):
        fwd = comm.ppermute(fwd)
    back = comm.ppermute(x, hop=-1)
    return {"fwd": fwd, "back": back, "sum": comm.psum(x),
            "max": comm.pmax(x), "bcast": comm.broadcast(x, comm.size - 1),
            "route": comm.route}


def fail_on(rank: int) -> None:
    """Rank ``rank`` raises; the others wait in a collective that can
    never complete without it."""
    if dist.get_rank() == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    dist.barrier()
    return np.zeros(1)
