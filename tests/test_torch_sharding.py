"""The port's sharding rules (``repro_torch.runtime.sharding``) against the
reference's (``repro.runtime.sharding``), leaf by leaf, at full width.

The reference's specs come from ``jax.eval_shape`` trees on an
``AbstractMesh`` (no devices); the port's from ``meta`` trees on the
mesh's axis sizes.  The port keeps one leaf per repeat of a segment
where the reference stacks the repeats and prefixes ``None``: each of
the port's repeat leaves must carry the reference's spec without that
``None``.  Per-rank argument bytes of every dry-run cell follow from the
specs and shapes alone; they must equal the reference's, computed the
same way, and ``mem_argument_size_in_bytes`` in ``experiments/dryrun``
(XLA's own count), under the reference's hardware (v5e's 16 GiB HBM,
which decides the serve policy).  DTensor's placements must split a dim
over a tuple of axes as JAX splits it (checked rank by rank on the
2×16×16 mesh).
"""

import functools
import json
import math
import os
import subprocess
import sys

import jax
import pytest
from jax._src.interpreters import partial_eval as pe
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.configs import load_config as ref_load_config
from repro.launch import steps as ref_steps
from repro.models import model as ref_M
from repro.runtime import sharding as ref_shr
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, SHAPES, load_config
from repro_torch.configs.base import cell_is_applicable
from repro_torch.launch import mesh as lm
from repro_torch.launch import steps
from repro_torch.models import model as M
from repro_torch.runtime import sharding as shr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
V5E_HBM = 16 * 2**30


def _abstract(mesh_name):
    dims, names = MESHES[mesh_name]
    return AbstractMesh(dims, names)


def _sizes(mesh_name):
    dims, names = MESHES[mesh_name]
    return dict(zip(names, dims))


def _ref_key(k):
    return getattr(k, "key", getattr(k, "idx", getattr(k, "name", k)))


def _ref_flat(tree):
    """``{path: leaf}`` of a reference tree, paths of plain keys."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(_ref_key(k) for k in p): leaf for p, leaf in flat}


def _port_to_ref(path):
    """The reference's path of a port leaf, and whether it is stacked:
    ``segment_<i>[repeat][unit]...`` → ``segment_<i>[unit]...``."""
    if path and str(path[0]).startswith("segment_"):
        return (path[0],) + tuple(path[2:]), True
    return tuple(path), False


def _spec(p):
    return tuple(p)


def _compare(port_tree, port_spec_fn, ref_specs):
    """Every port leaf's spec against its reference leaf's, and every
    reference leaf reached.  Returns the number of leaves checked."""
    seen = set()
    n = 0
    for path, leaf in tree.flatten_with_paths(port_tree):
        rpath, stacked = _port_to_ref(path)
        want = _spec(ref_specs[rpath])
        if stacked:
            assert want[:1] in ((), (None,)), (path, want)
            want = want[1:]
        got = port_spec_fn(path, leaf)
        assert got == want, (path, tuple(leaf.shape), got, want)
        seen.add(rpath)
        n += 1
    assert seen == set(ref_specs), set(ref_specs) - seen
    return n


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = ref_load_config(arch)
    return jax.eval_shape(lambda: ref_M.init_params(jax.random.PRNGKey(0),
                                                    cfg))


def _ref_param_bytes(params):
    return sum(l.size * l.dtype.itemsize
               for l in jax.tree_util.tree_leaves(params))


def _ref_serve_specs(mesh, params, ep_serve, policy, monkeypatch):
    """The reference's serve layout with its policy forced by its HBM
    constant."""
    hbm = 2**62 if policy == "tp" else 1
    monkeypatch.setattr(ref_shr, "HBM_BYTES_PER_CHIP", hbm)
    assert ref_shr.serve_weight_policy(_ref_param_bytes(params),
                                       mesh) == policy
    sh = ref_shr.params_shardings_serve(mesh, params,
                                        _ref_param_bytes(params),
                                        ep_serve=ep_serve)
    return {p: s.spec for p, s in _ref_flat(sh).items()}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_equal_the_reference_leaf_by_leaf(arch, monkeypatch):
    """Train, serve ``tp`` / ``2d`` with and without ``ep_serve``, cache
    (decode_32k and, for SSM archs, long_500k) and batch rules, on both
    meshes, every leaf at full width."""
    cfg = load_config(arch)
    ref_params = _ref_params(arch)
    params = M.init_params(None, cfg, "meta")
    pbytes = steps._param_bytes(params)
    assert pbytes == _ref_param_bytes(ref_params)
    n = 0
    for mesh_name in MESHES:
        amesh, sizes = _abstract(mesh_name), _sizes(mesh_name)
        ref_train = {p: ref_shr.param_pspec(amesh, p, leaf)
                     for p, leaf in _ref_flat(ref_params).items()}
        n += _compare(params, lambda p, l: shr.param_pspec(sizes, p, l),
                      ref_train)
        for policy, hbm in (("tp", 2**62), ("2d", 1)):
            assert shr.serve_weight_policy(pbytes, sizes,
                                           hbm_bytes=hbm) == policy
            for ep in (False, True):
                want = _ref_serve_specs(amesh, ref_params, ep, policy,
                                        monkeypatch)
                got = shr.params_specs_serve(sizes, params, pbytes,
                                             ep_serve=ep, hbm_bytes=hbm)
                flat = dict(tree.flatten_with_paths(params))
                spec_of = {p: s for p, s in zip(flat, steps._spec_leaves(got))}
                n += _compare(params, lambda p, l: spec_of[p], want)
        for shape_name in ("decode_32k", "long_500k"):
            shape = SHAPES[shape_name]
            if not cell_is_applicable(cfg, shape):
                continue
            ref_cache = ref_M.input_specs(ref_load_config(arch),
                                          shape_name)["cache"]
            want = {p: ref_shr.cache_pspec(amesh, p, leaf)
                    for p, leaf in _ref_flat(ref_cache).items()}
            cache = M.input_specs(cfg, shape)["cache"]
            n += _compare(cache, lambda p, l: shr.cache_pspec(sizes, p, l),
                          want)
        for shape_name, shape in SHAPES.items():
            ref_specs = ref_M.input_specs(ref_load_config(arch), shape_name)
            for key, t in M.input_specs(cfg, shape).items():
                if key == "cache":
                    continue
                want = _spec(ref_shr.batch_pspec(amesh, ref_specs[key].shape))
                assert shr.batch_pspec(sizes, t.shape) == want, (key, want)
                n += 1
    assert n > 100


# -- argument bytes of every dry-run cell -------------------------------------

def _local_numel(shape, spec, sizes):
    return math.prod(shr.local_shape(sizes, shape, tuple(spec)))


def _ref_step_and_args(arch, shape_name, amesh):
    """The reference's step, its abstract arguments and their shardings,
    as its ``lower_cell`` builds them (serve policy under v5e's HBM)."""
    cfg = ref_load_config(arch)
    specs = ref_M.input_specs(cfg, shape_name)
    kind = SHAPES[shape_name].kind
    if kind == "train":
        opt_cfg = ref_steps.adamw.AdamWConfig()
        state = ref_steps.abstract_train_state(cfg, opt_cfg)
        return (ref_steps.make_train_step(cfg, opt_cfg), (state, specs),
                (ref_steps.train_state_shardings(amesh, state),
                 ref_steps.batch_shardings(amesh, specs)))
    params = _ref_params(arch)
    assert ref_shr.HBM_BYTES_PER_CHIP == V5E_HBM
    psh = ref_shr.params_shardings_serve(amesh, params,
                                         _ref_param_bytes(params))
    if kind == "prefill":
        inp = specs.get("tokens", specs.get("embeds"))
        return (ref_steps.make_forward(cfg), (params, inp),
                (psh, NamedSharding(amesh,
                                    ref_shr.batch_pspec(amesh, inp.shape))))
    return (ref_steps.make_decode_step(cfg),
            (params, specs["token"], specs["cache"], specs["length"]),
            (psh, NamedSharding(amesh, ref_shr.batch_pspec(
                amesh, specs["token"].shape)),
             ref_shr.tree_shardings(amesh, specs["cache"],
                                    ref_shr.cache_pspec),
             NamedSharding(amesh, P())))


def _ref_argument_bytes(arch, shape_name, mesh_name):
    """The reference's per-device argument bytes from its PartitionSpecs
    and ``eval_shape`` shapes alone: of every argument leaf, and of the
    leaves its step reads (XLA drops the others from the compiled
    program's arguments: DeepSeek-V3's MTP head and Command R+'s unused
    second norms when serving, RWKV-6's decode ``length``, the front-end
    models' embedding table in prefill)."""
    amesh, sizes = _abstract(mesh_name), _sizes(mesh_name)
    fn, args, shardings = _ref_step_and_args(arch, shape_name, amesh)
    leaves = jax.tree_util.tree_leaves(args)
    shs = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, NamedSharding))
    assert len(leaves) == len(shs)
    each = [_local_numel(l.shape, sh.spec, sizes) * l.dtype.itemsize
            for l, sh in zip(leaves, shs)]
    if SHAPES[shape_name].kind == "train":
        return sum(each), sum(each)
    closed = jax.make_jaxpr(fn)(*args)
    _, used = pe.dce_jaxpr(closed.jaxpr, [True] * len(closed.jaxpr.outvars))
    return sum(each), sum(b for b, u in zip(each, used) if u)


CELLS = [(a, s, m) for a in ARCH_IDS for s in SHAPES for m in MESHES
         if cell_is_applicable(load_config(a), SHAPES[s])]


def test_cells_are_the_reference_matrix():
    assert len(CELLS) == 64


@pytest.mark.parametrize("arch,shape,mesh_name", CELLS)
def test_argument_bytes_equal_the_reference(arch, shape, mesh_name):
    """One rank's argument bytes under the reference's hardware: the
    port's (its rules on its trees) == the reference's (its specs on its
    trees); and the reference's over the leaves its step reads == XLA's
    ``mem_argument_size_in_bytes``."""
    kind, args, specs = steps.cell_inputs(
        load_config(arch), shape, _sizes(mesh_name), hbm_bytes=V5E_HBM)
    got = steps.argument_bytes(args, specs, _sizes(mesh_name))
    every, read = _ref_argument_bytes(arch, shape, mesh_name)
    assert got == every
    with open(os.path.join(ROOT, "experiments", "dryrun",
                           f"{arch}__{shape}__{mesh_name}.json")) as f:
        assert read == json.load(f)["mem_argument_size_in_bytes"]


def test_argument_bytes_of_the_named_cells():
    """The four cells the port is held to by name (16×16)."""
    want = {("smollm-135m", "decode_32k"): 394_367_652,
            ("qwen2.5-14b", "decode_32k"): 5_068_410_916,
            ("qwen2.5-14b", "prefill_32k"): 1_847_447_552,
            ("smollm-135m", "train_4k"): 5_866_696}
    for (arch, shape), n in want.items():
        kind, args, specs = steps.cell_inputs(
            load_config(arch), shape, _sizes("16x16"), hbm_bytes=V5E_HBM)
        assert steps.argument_bytes(args, specs, _sizes("16x16")) == n


# -- placements ---------------------------------------------------------------

_JAX_CHUNKS = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(np.array(jax.devices()).reshape(2, 16, 16),
            ("pod", "data", "model"))
out = {}
for name, shape, spec in json.loads(sys.argv[1]):
    spec = P(*[tuple(e) if isinstance(e, list) else e for e in spec])
    m = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
    out[name] = {d.id: [s.start or 0 for s in idx] for d, idx in m.items()}
print(json.dumps(out))
"""

_PLACED = [
    ("batch_pod_data", (512, 64, 32), [["pod", "data"], None, "model"]),
    ("ep_all_axes", (1024, 8, 8), [["pod", "data", "model"]]),
    ("model_only", (4, 32), [None, "model"]),
]


def test_placements_split_as_jax_rank_by_rank():
    """Every rank's chunk offset on the 2×16×16 mesh, from DTensor's
    placements (the rank a fake world plays), equals the start of the
    device's chunk in JAX's ``NamedSharding`` with the same spec (JAX on
    512 forced host devices, in a subprocess)."""
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    env = dict(os.environ, XLA_FLAGS=(
        "--xla_force_host_platform_device_count=512"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _JAX_CHUNKS,
                          json.dumps(_PLACED)], env=env, check=True,
                         capture_output=True, text=True, timeout=300)
    want = json.loads(out.stdout)
    for rank in range(0, 512, 7):
        with lm.fake_world(512, rank=rank):
            mesh = lm.make_mesh((2, 16, 16), ("pod", "data", "model"), "cpu")
            for name, shape, spec in _PLACED:
                sp = tuple(tuple(e) if isinstance(e, list) else e
                           for e in spec)
                _, offset = compute_local_shape_and_global_offset(
                    shape, mesh, shr.to_placements(mesh, sp))
                assert list(offset) == want[name][str(rank)], (name, rank)


def test_to_placements_refuses_an_order_dtensor_cannot_split():
    with lm.fake_world(8):
        mesh = lm.make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
        with pytest.raises(ValueError, match="mesh's order"):
            shr.to_placements(mesh, (("data", "pod"),))


def test_local_shape_and_axis_sizes():
    sizes = _sizes("2x16x16")
    assert shr.axis_size(sizes, ("pod", "data")) == 32
    assert shr.local_shape(sizes, (64, 48), (("pod", "data"), "model")) \
        == (2, 3)
    with pytest.raises(ValueError):
        shr.local_shape(sizes, (9,), ("model",))
    assert shr.safe_spec(sizes, (9, 32), ["model", "model"]) == (None,
                                                                 "model")


def test_train_state_and_batch_shardings():
    """The moments take their params' placements, ``count`` and ``step``
    are replicated; a batch splits over the data axes and a decode cell's
    cache by the cache rules."""
    from torch.distributed.tensor import Replicate, Shard
    cfg = load_config("smollm-135m")
    with lm.fake_world(8):
        mesh = lm.make_mesh((2, 4), ("data", "model"), "cpu")
        state = steps.abstract_train_state(cfg, steps.adamw.AdamWConfig())
        sh = steps.train_state_shardings(mesh, state)
        p = steps._spec_leaves(sh.params)
        assert steps._spec_leaves(sh.opt["mu"]) == p
        assert steps._spec_leaves(sh.opt["nu"]) == p
        assert sh.opt["count"].placements == sh.step.placements \
            == (Replicate(), Replicate())
        assert sh.params["embed"]["table"].placements == (Shard(1), Shard(0))
        assert sh.params["embed"]["table"].mesh is mesh
        # one leaf a tensor: the shardings align with the state's leaves
        assert len(tree.leaves(sh)) == len(tree.leaves(state))
        b = steps.batch_shardings(mesh, M.input_specs(cfg, "decode_32k"))
        assert b["token"].placements == (Shard(0), Replicate())
        assert b["cache"]["segment_0"][0][0]["mixer"]["k"].placements == (
            Shard(0), Shard(2))


def test_global_norm_and_batch_shardings_take_the_reference_keywords():
    """``adamw.global_norm(tree=...)`` and ``steps.batch_shardings(mesh,
    batch_specs=...)``: the reference's parameter names, called by them
    on both packages."""
    import inspect

    import jax.numpy as jnp
    import torch
    from repro.optim import adamw as ref_adamw
    from repro_torch.optim import adamw
    for ref_fn, fn in ((ref_adamw.global_norm, adamw.global_norm),
                       (ref_steps.batch_shardings, steps.batch_shardings)):
        assert list(inspect.signature(fn).parameters) == list(
            inspect.signature(ref_fn).parameters)
    leaves = [[3.0, 4.0], [12.0]]
    assert float(adamw.global_norm(tree={"a": [
        torch.tensor(v) for v in leaves]})) == float(ref_adamw.global_norm(
            tree={"a": [jnp.asarray(v) for v in leaves]})) == 13.0
    cfg = load_config("smollm-135m")
    with lm.fake_world(8):
        mesh = lm.make_mesh((2, 4), ("data", "model"), "cpu")
        b = steps.batch_shardings(mesh, batch_specs=M.input_specs(
            cfg, "train_4k"))
    assert b["tokens"].placements == steps.batch_shardings(
        mesh, M.input_specs(cfg, "train_4k"))["tokens"].placements
    ref = ref_steps.batch_shardings(
        AbstractMesh((2, 4), ("data", "model")), batch_specs=ref_M.input_specs(
            ref_load_config("smollm-135m"), "train_4k"))
    assert set(ref) == set(b) == {"tokens"}
