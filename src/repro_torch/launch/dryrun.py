"""Multi-pod dry run: every (arch × shape × mesh) cell's step, on one rank
of the production mesh.

The port of the reference's ``launch/dryrun.py``.  The reference lowers
and compiles each cell for 512 placeholder CPU devices and reads XLA's
artifacts; here the cell's step runs once on DTensors over a
``DeviceMesh`` of a fake process group of 256 or 512 ranks
(``launch/mesh.fake_world``), with ``meta`` shards, and one rank's local
ops are counted (``launch/steps.lower_cell``, ``launch/census.py``).

Per cell the record holds the reference's keys where the port measures
the same thing — ``mem_argument_size_in_bytes`` (one rank's shards of
every input; equal to the reference's), ``mem_output_size_in_bytes``,
``coll`` (each collective kind's result bytes and count), ``fit``,
``dataflow``, ``roofline``, ``model_flops`` — and, in place of the keys
that name XLA artifacts:

* ``rank_flops`` for ``hlo_flops`` (the rank's FLOPs, from its local
  ops) and ``model_vs_rank_flops`` for ``model_vs_hlo_flops``;
* ``rank_bytes`` for ``hlo_bytes`` (bytes its non-view local ops read
  and write);
* ``peak_bytes`` for ``mem_temp_size_in_bytes`` (the peak of the rank's
  live local bytes, arguments included);
* ``trace_s`` for ``lower_s`` / ``compile_s``; there is no
  ``hlo_lines``.

``dataflow`` is the stage/channel census of the step through the port's
dataflow driver, for every kind of cell.  A census error makes the cell
``error``, and the CLI exits non-zero on any error cell.

Run:  python -m repro_torch.launch.dryrun --arch all --shape all
      --mesh both [--seq-parallel] [--out build/dryrun] [--device cpu]
      [--jobs N]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

from .. import _device
from ..configs.base import ARCH_IDS, SHAPES, cell_is_applicable, load_config
from ..runtime.sharding import (HBM_BW, HBM_BYTES_PER_CHIP, ICI_BW_PER_LINK,
                                PEAK_FLOPS_BF16)
from . import mesh as meshes
from .steps import lower_cell

MESH_NAMES = {mp: "x".join(map(str, dims))
              for mp, (dims, _) in meshes.PRODUCTION_MESHES.items()}


def roofline_terms(flops: float, bytes_hbm: float, coll_bytes: float
                   ) -> dict:
    """The three per-step time lower bounds (seconds) on the card, from
    one rank's quantities."""
    t_compute = flops / PEAK_FLOPS_BF16
    t_memory = bytes_hbm / HBM_BW
    t_coll = coll_bytes / ICI_BW_PER_LINK
    dominant = max((t_compute, "compute"), (t_memory, "memory"),
                   (t_coll, "collective"))[1]
    return {
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
    }


def dataflow_census(cfg, shape) -> dict:
    """Stage/channel census of the cell's step through the port's
    dataflow driver (analysis passes only: the step is traced on
    ``meta`` inputs, partitioned by Algorithm 1 and the schedule
    summarized).  Decode and long cells trace ``decode_step``
    (``launch/serve.decode_compiled``), prefill cells ``forward``, each
    segment one ``scan`` equation as in the reference; train cells the
    train step (:func:`train_compiled`)."""
    from ..models import model as M
    from . import serve
    if isinstance(shape, str):
        shape = SHAPES[shape]
    params = M.init_params(None, cfg, "meta")
    if shape.kind == "decode":
        compiled = serve.decode_compiled(cfg, params, shape.global_batch,
                                         shape.seq_len)
    elif shape.kind == "prefill":
        compiled = forward_compiled(cfg, params, shape)
    else:
        compiled = train_compiled(cfg, shape)
    return census_of(compiled)


def census_of(compiled) -> dict:
    """The census fields of a compiled step."""
    sch = compiled.schedule
    return {
        "ops": len(compiled.cdfg.nodes),
        "memory_ops": len(compiled.cdfg.memory_nodes),
        "long_ops": len(compiled.cdfg.long_nodes),
        "stages": sch.num_stages,
        "channels": sch.num_channels,
        "channel_bytes": sch.channel_bytes,
        "pipeline_ii": sch.pipeline_ii,
    }


def train_compiled(cfg, shape, *, device="meta", backend: str = "eager"):
    """``make_train_step(cfg, AdamWConfig())`` on the cell's batch,
    compiled by the dataflow driver: the inputs are the train state's
    leaves in the reference's layout and order
    (``steps.stack_train_state``: each segment leaf stacked over its
    repeats, keys sorted), then the batch's; the outputs the new state's
    leaves in that order, then the metrics'.  The step traces with
    ``loss_and_grads`` as a ``grad`` leaf (``core/autodiff.py``: the
    loss's equations, their residuals and transposes; each segment one
    ``cdfg.scan`` over its stacked leaves partially evaluated as JAX
    does — its loop invariants and its attention's masks hoisted, its
    forward and reverse scans, the attention's scan, the WKV recurrence
    or the Mamba scans nested in each, under ``cfg.remat`` the body one
    ``remat2`` equation; DeepSeek-V3's MTP head's layer inline), the
    embedding's read as ``x[idx]``, and the port's own
    ``warmup_cosine`` and ``apply_updates``.  ``device`` other than
    ``meta`` compiles a step that runs (the ``sequential`` backend
    replays the lowered equations)."""
    import torch

    from .. import tree
    from ..core import cdfg
    from ..dataflow import compile as dataflow_compile
    from ..models import layers, model as M, transformer
    from ..optim import adamw
    from . import steps
    if isinstance(shape, str):
        shape = SHAPES[shape]
    opt_cfg = adamw.AdamWConfig()
    state = steps.stack_train_state(steps.abstract_train_state(cfg, opt_cfg))
    batch = M.input_specs(cfg, shape)
    train_step = steps.make_train_step(cfg, opt_cfg)

    def step(state_leaves, batch_leaves):
        new, metrics = train_step(tree.unflatten(state, list(state_leaves)),
                                  tree.unflatten(batch, list(batch_leaves)))
        new.opt = {k: new.opt[k] for k in state.opt}    # the input's order
        return (*tree.leaves(new), *tree.leaves(metrics))

    def example(t):
        return t if device == "meta" else torch.zeros(
            t.shape, dtype=t.dtype, device=device)

    with cdfg.leaves(index=[(layers, "take")],
                     scan=[(transformer, "_segment_forward")],
                     grad=[(steps, "loss_and_grads")]):
        return dataflow_compile(step, tuple(map(example, tree.leaves(state))),
                                tuple(map(example, tree.leaves(batch))),
                                backend=backend, device=device,
                                use_cache=False)


def forward_compiled(cfg, params: dict, shape):
    """``forward``'s logits on the cell's prompt, compiled by the
    dataflow driver for ``meta`` tensors: the parameter leaves in the
    reference's order (``serve.reference_order``), then the tokens (or
    embeddings); the embedding's read is ``x[idx]`` and each segment one
    ``scan`` equation."""
    from .. import tree
    from ..core import cdfg
    from ..dataflow import compile as dataflow_compile
    from ..models import layers, model as M, transformer
    from .serve import _at, reference_order
    meta = tree.tree_map(lambda t: t.to("meta"), params)
    specs = M.input_specs(cfg, shape)
    inp = specs.get("tokens", specs.get("embeds"))
    order = reference_order(meta)
    paths = [p for p, _ in tree.flatten_with_paths(meta)]

    def fwd(p_leaves, inputs):
        p = dict(zip(order, p_leaves))
        logits, _ = M.forward(tree.unflatten(meta, [p[k] for k in paths]),
                              inputs, cfg)
        return logits

    with cdfg.leaves(index=[(layers, "take")],
                     scan=[(transformer, "_segment_forward")]):
        return dataflow_compile(fwd, tuple(_at(meta, k) for k in order),
                                inp, backend="eager", device="meta",
                                use_cache=False)


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             out_dir: str = "build/dryrun", save: bool = True,
             variant: str | None = None, overrides: dict | None = None,
             ep_serve: bool = False, device=None, cfg=None, shape=None,
             mesh_dims: tuple | None = None) -> dict:
    """One cell on a fake world of 256 or 512 ranks, opened for this call
    and destroyed after (raises if a process group is initialised).
    ``variant``/``overrides``/``ep_serve`` serve the §Perf variants:
    overrides are ``dataclasses.replace``d onto the config (``{"moe":
    {...}}`` onto its MoE config).  ``device`` is the card (default) or
    ``"cpu"``: the mesh's device type.  ``cfg``, ``shape`` (an
    ``InputShape``) and ``mesh_dims`` (the production mesh's axes at
    other sizes) replace the arch's config, the named shape and the
    production sizes: a reduced cell on a small fake world."""
    dev = _device.get_device(device)
    cfg = cfg or load_config(arch)
    if overrides:
        overrides = dict(overrides)
        moe_over = overrides.pop("moe", None)
        if moe_over and cfg.moe is not None:
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, **moe_over))
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
    shape = shape or SHAPES[shape_name]
    dims, names = meshes.PRODUCTION_MESHES[multi_pod]
    dims = mesh_dims or dims
    n_chips = math.prod(dims)
    mesh_name = "x".join(map(str, dims))
    cell = f"{arch}__{shape_name}__{mesh_name}"
    if variant:
        cell += f"__{variant}"
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "chips": n_chips, "variant": variant,
                 "device_type": dev.type}

    if not cell_is_applicable(cfg, shape):
        rec["status"] = "skip"
        rec["reason"] = ("long_500k requires sub-quadratic decode; "
                         f"{arch} is pure full-attention")
        return _save(rec, cell, out_dir, save)

    t0 = time.time()
    try:
        with meshes.fake_world(n_chips):
            mesh = meshes.make_mesh(dims, names, dev)
            got = lower_cell(cfg, shape, mesh, ep_serve=ep_serve)
        got.pop("local_shapes")
        rec.update(got)
        rec["fit"] = _fit_analysis(cfg, shape, n_chips)
        rec["dataflow"] = dataflow_census(cfg, shape)
        flops = rec["rank_flops"]
        rec["roofline"] = roofline_terms(flops, rec["rank_bytes"],
                                         rec["coll"]["total"])
        # model-FLOPs context (6·N·D train / 2·N·D inference, N = active
        # params for MoE): global, so compared with n_chips × rank flops
        N = (cfg.active_param_count() if cfg.moe is not None
             else cfg.param_count())
        toks = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                     else 1)
        mult = 6 if shape.kind == "train" else 2
        rec["model_flops"] = float(mult * N * toks)
        rec["model_vs_rank_flops"] = (rec["model_flops"] / (flops * n_chips)
                                      if flops else None)
        rec["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — record and continue the matrix
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 1)
    return _save(rec, cell, out_dir, save)


def _fit_analysis(cfg, shape, n_chips: int) -> dict:
    """Analytic bytes a chip for weights (+ AdamW state if train),
    assuming the 2-D layout spreads params over all chips, against the
    card's HBM."""
    pbytes = cfg.param_count() * 2  # bf16
    out = {"param_bytes_global": pbytes}
    if shape.kind == "train":
        state = pbytes + cfg.param_count() * 4 * 2  # fp32 m+v
        per_chip = state / n_chips
        out["train_state_per_chip"] = per_chip
        out["fits_hbm"] = bool(per_chip < 0.9 * HBM_BYTES_PER_CHIP)
        if not out["fits_hbm"]:
            out["pods_needed"] = int(math.ceil(
                state / (0.9 * HBM_BYTES_PER_CHIP) / 256))
    else:
        per_chip = pbytes / min(n_chips, 256)
        out["serve_params_per_chip"] = per_chip
        out["fits_hbm"] = bool(per_chip < 0.9 * HBM_BYTES_PER_CHIP)
    return out


def _save(rec: dict, cell: str, out_dir: str, save: bool) -> dict:
    if save:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, f"{cell}.json"), "w") as f:
            json.dump(rec, f, indent=1, default=str)
    status = rec["status"]
    extra = ""
    if status == "ok":
        r = rec["roofline"]
        extra = (f" flops={rec['rank_flops']:.3g}"
                 f" coll={rec['coll']['total']:.3g}B"
                 f" dom={r['dominant']}"
                 f" trace={rec['trace_s']:.1f}s")
    elif status == "error":
        extra = " " + rec["error"][:120]
    print(f"[{status:5s}] {cell}{extra}", flush=True)
    return rec


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--arch", default="all", help="arch id or 'all'")
    p.add_argument("--shape", default="all", help="shape name or 'all'")
    p.add_argument("--mesh", default="single",
                   choices=["single", "multi", "both"])
    p.add_argument("--out", default="build/dryrun")
    p.add_argument("--seq-parallel", action="store_true",
                   help="apply the sequence-parallel activation layout")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default) or 'cpu': the meshes' device")
    p.add_argument("--jobs", type=int, default=1,
                   help="cells run at once, each in a process of its own "
                        "(spawned; the default 1 runs them in this one)")
    args = p.parse_args(argv)
    _device.get_device(args.device)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    mps = {"single": [False], "multi": [True],
           "both": [False, True]}[args.mesh]
    cells = [(arch, shape, mp, args.out, args.device, args.seq_parallel)
             for arch in archs for shape in shapes for mp in mps]
    if args.jobs > 1:
        import multiprocessing as mp_
        with mp_.get_context("spawn").Pool(args.jobs) as pool:
            done = pool.map(_cli_cell, cells, chunksize=1)
    else:
        done = [_cli_cell(c) for c in cells]
    n = {s: done.count(s) for s in ("ok", "error", "skip")}
    print(f"done: {n['ok']} ok, {n['skip']} skip, {n['error']} error")
    if n["error"]:
        raise SystemExit(1)


def _cli_cell(cell: tuple) -> str:
    """One CLI cell (in this process or a pool's): its status."""
    from ..runtime.sharding import sequence_parallel
    arch, shape, mp, out, device, seq_parallel = cell
    if seq_parallel:
        with sequence_parallel():
            rec = run_cell(arch, shape, multi_pod=mp, out_dir=out,
                           device=device)
    else:
        rec = run_cell(arch, shape, multi_pod=mp, out_dir=out, device=device)
    return rec["status"]


if __name__ == "__main__":
    main()
