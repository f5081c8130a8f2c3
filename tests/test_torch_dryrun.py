"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun``), on the CPU.

* The dataflow census of every decode, prefill and long cell at full
  width equals the reference's, live (under this jax; the records in
  ``experiments/dryrun`` were taken under another, and differ on the
  LayerNorm architectures by one ``jit`` equation's latency).
* ``chip_smoke.py``'s pinned tables (``REF_DRYRUN_ARGS``,
  ``REF_DRYRUN_SPECS``, ``REF_DRYRUN_CENSUS``) equal the live reference.
* ``run_cell`` on a fake 2×4 world for the ten reduced architectures ×
  their applicable kinds (and, in ``test_torch_dryrun_pods.py``, on a
  2×2×2 one for their decode steps, and the train step of one
  architecture per mechanism): every cell ``ok``, one rank's argument
  bytes as the rules give them, a census on the serve kinds.
* Sequence parallelism turns the TP all-reduces of a reduced train
  step into reduce-scatters and moves fewer bytes.
* The fake world does not change the program: on 4 real CPU gloo ranks
  the sharded decode step, forward and train step equal the plain
  port's, and launch the collectives the fake 2×2 world counted.

The reference's ``dryrun`` module sets ``XLA_FLAGS`` for 512 devices when
imported; it is imported after jax has initialised its one CPU device,
and the variable is restored, so this process keeps seeing one device.
"""

import functools
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import load_config as ref_load_config
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, SHAPES, load_config
from repro_torch.configs.base import InputShape, cell_is_applicable, reduced
from repro_torch.launch import dryrun, mesh as lm, steps
from repro_torch.launch.mesh import spawn
from repro_torch.models import model as M
from repro_torch.runtime import sharding as shr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _ref_dryrun():
    jax.devices()                      # one device, before the import
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as ref
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return ref


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    import chip_smoke
    return chip_smoke


CENSUS_CELLS = [(a, s) for a in ARCH_IDS
                for s in ("decode_32k", "prefill_32k", "long_500k")
                if cell_is_applicable(load_config(a), SHAPES[s])]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_census_equals_the_reference(arch):
    """Decode, prefill and long cells at full width: ops, memory and
    long ops, stages, channels, channel bytes and II."""
    ref = _ref_dryrun()
    for a, s in CENSUS_CELLS:
        if a != arch:
            continue
        want = ref.dataflow_census(ref_load_config(arch), s)
        assert dryrun.dataflow_census(load_config(arch), s) == want, s


def test_pinned_census_equals_the_reference():
    """``REF_DRYRUN_CENSUS``, which phase 14b holds the card's run to: the
    22 cells and DeepSeek-V3's absorbed decode, live."""
    import dataclasses
    ref = _ref_dryrun()
    pinned = _chip_smoke().REF_DRYRUN_CENSUS
    assert len(pinned) == len(CENSUS_CELLS) + 1
    for (a, s), want in pinned.items():
        if a.endswith("+absorbed"):
            cfg = dataclasses.replace(ref_load_config(a.split("+")[0]),
                                      mla_absorbed=True)
        else:
            cfg = ref_load_config(a)
        assert ref.dataflow_census(cfg, s) == want, (a, s)


#: the live reference's census of SmolLM-135M ``train_4k``
#: (``channel_bytes`` left out), and its step's top-level equations: the
#: loss alone, its ``value_and_grad``, the whole step
REF_TRAIN_CENSUS = {"ops": 411, "memory_ops": 2, "long_ops": 183,
                    "stages": 184, "channels": 361, "pipeline_ii": 1}
REF_TRAIN_EQNS = {"forward": 33, "value_and_grad": 116, "step": 411}


def test_reference_train_census_is_the_recorded_one():
    """The live reference's census of SmolLM-135M ``train_4k``, which the
    port's equals less its pinned difference
    (``tests/test_torch_train_census.py``), and the step's equations
    split into the forward (the loss), the backward (``value_and_grad``
    less the forward) and AdamW (the step less ``value_and_grad``) — 33,
    83 and 295."""
    from repro.configs.base import SHAPES as REF_SHAPES
    from repro.launch import steps as ref_steps
    from repro.models import model as ref_M
    from repro.optim import adamw as ref_adamw
    ref = _ref_dryrun()
    cfg = ref_load_config("smollm-135m")
    census = ref.dataflow_census(cfg, "train_4k")
    assert {k: census[k] for k in REF_TRAIN_CENSUS} == REF_TRAIN_CENSUS
    opt_cfg = ref_adamw.AdamWConfig()
    state = ref_steps.abstract_train_state(cfg, opt_cfg)
    batch = ref_M.input_specs(cfg, REF_SHAPES["train_4k"])

    def loss(p, b):
        return ref_M.loss_fn(p, b, cfg)

    eqns = {
        "forward": jax.make_jaxpr(loss)(state.params, batch),
        "value_and_grad": jax.make_jaxpr(
            jax.value_and_grad(loss, has_aux=True))(state.params, batch),
        "step": jax.make_jaxpr(ref_steps.make_train_step(cfg, opt_cfg))(
            state, batch)}
    assert {k: len(v.jaxpr.eqns) for k, v in eqns.items()} == \
        REF_TRAIN_EQNS


def test_pinned_argument_bytes_and_specs_equal_the_rules():
    """``REF_DRYRUN_ARGS`` (all 64 cells under v5e's HBM) and
    ``REF_DRYRUN_SPECS`` (a digest of every leaf's spec) equal what the
    port's rules give; ``test_torch_sharding.py`` holds the rules to the
    live reference."""
    cs = _chip_smoke()
    assert cs.REF_DRYRUN_ARGS == cs.dryrun_arguments(16 * 2**30)
    assert cs.REF_DRYRUN_SPECS == cs.dryrun_spec_digests()


# -- the reduced matrix on fake worlds -----------------------------------------

SMALL = {"train_4k": InputShape("train_4k", 32, 8, "train"),
         "prefill_32k": InputShape("prefill_32k", 64, 8, "prefill"),
         "decode_32k": InputShape("decode_32k", 64, 8, "decode"),
         "long_500k": InputShape("long_500k", 128, 1, "decode")}


#: the kinds each architecture runs on the 3-D mesh, where DTensor's
#: planning costs most: every architecture's decode steps, and the train
#: step (whose forward is the prefill's) of one architecture for each
#: mixer or MLP the others lack — attention, MoE, MLA, Mamba, RWKV
TRAIN_ON_3D = ("smollm-135m", "llama4-scout-17b-a16e", "deepseek-v3-671b",
               "jamba-1.5-large-398b", "rwkv6-1.6b")


def reduced_cells(arch, mesh_dims):
    """``run_cell`` for the reduced ``arch``'s applicable kinds on a fake
    world of ``mesh_dims``: on 2-D meshes every kind, on 3-D ones the
    kinds :data:`TRAIN_ON_3D` names."""
    cfg = reduced(load_config(arch))
    sizes = dict(zip(("data", "model") if len(mesh_dims) == 2
                     else ("pod", "data", "model"), mesh_dims))
    for name, shape in SMALL.items():
        if not cell_is_applicable(cfg, shape):
            continue
        if len(mesh_dims) == 3 and (
                shape.kind == "prefill"
                or shape.kind == "train" and arch not in TRAIN_ON_3D):
            continue
        rec = dryrun.run_cell(arch, name, multi_pod=len(mesh_dims) == 3,
                              save=False, device="cpu", cfg=cfg, shape=shape,
                              mesh_dims=mesh_dims)
        assert rec["status"] == "ok", (name, rec.get("traceback"))
        assert "dataflow" in rec
        kind, args, specs = steps.cell_inputs(cfg, shape, sizes)
        assert rec["mem_argument_size_in_bytes"] == steps.argument_bytes(
            args, specs, sizes)
        assert rec["rank_flops"] > 0 and rec["peak_bytes"] >= rec[
            "mem_argument_size_in_bytes"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_matrix_on_a_fake_2x4_world(arch):
    reduced_cells(arch, (2, 4))


def test_run_cell_skips_full_attention_at_500k(tmp_path):
    rec = dryrun.run_cell("qwen2.5-14b", "long_500k", multi_pod=False,
                          out_dir=str(tmp_path), device="cpu")
    assert rec["status"] == "skip"
    assert (tmp_path / "qwen2.5-14b__long_500k__16x16.json").exists()


def test_a_census_error_is_a_cell_error(monkeypatch):
    monkeypatch.setattr(dryrun, "dataflow_census", _raise)
    rec = dryrun.run_cell("smollm-135m", "decode_32k", multi_pod=False,
                          save=False, device="cpu",
                          cfg=reduced(load_config("smollm-135m")),
                          shape=SMALL["decode_32k"], mesh_dims=(2, 4))
    assert rec["status"] == "error"
    assert "no sharding strategy" in rec["error"]
    assert not torch.distributed.is_initialized()


def test_fake_world_refuses_a_live_group_and_leaves_none():
    with lm.fake_world(8):
        with pytest.raises(RuntimeError, match="already initialised"):
            with lm.fake_world(8):
                pass
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="needs a process group"):
        lm.make_production_mesh(False, "cpu")


def test_cli_exits_nonzero_on_an_error_cell(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "lower_cell", _raise)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "smollm-135m", "--shape", "decode_32k",
                     "--out", str(tmp_path), "--device", "cpu"])
    assert e.value.code == 1


def _raise(*a, **k):
    raise NotImplementedError("no sharding strategy")


# -- plain tensors take the plain path -----------------------------------------

class _OpNames(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.__name__)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_plain_decode_step_stacks_nothing(arch):
    """One decode step on plain tensors runs each layer's recurrence once:
    RWKV-6 and Mamba call their one-token step, not the scan over a
    sequence of one (no ``unbind``, no ``stack``)."""
    cfg = reduced(load_config(arch))
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    cache = M.init_cache(cfg, 2, 16, "cpu")
    with _OpNames() as ops:
        M.decode_step(params, torch.zeros(2, dtype=torch.int32), cache, 5,
                      cfg)
    assert ops.names and not [n for n in ops.names
                              if n.startswith(("stack", "unbind"))]


def test_plain_model_code_never_reaches_dtensor():
    """Serving and training on plain tensors never import
    ``torch.distributed.tensor``: the model code's DTensor checks answer
    a plain tensor at once (a fresh interpreter, the ten reduced
    architectures' forward and decode step)."""
    code = """if True:
        import sys, torch
        from repro_torch.configs import ARCH_IDS, load_config
        from repro_torch.configs.base import reduced
        from repro_torch.models import model as M
        for arch in ARCH_IDS:
            cfg = reduced(load_config(arch))
            p = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
            inp = M.input_specs(cfg, "train_4k")
            x = inp.get("tokens", inp.get("embeds"))
            M.forward(p, torch.zeros((2, 8) + tuple(x.shape[2:]),
                                     dtype=x.dtype), cfg)
            M.decode_step(p, torch.zeros(2, dtype=torch.int32),
                          M.init_cache(cfg, 2, 16, "cpu"), 5, cfg)
        assert "torch.distributed.tensor" not in sys.modules
    """
    import subprocess
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    got = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-2000:]


# -- sequence parallelism -----------------------------------------------------

def test_sequence_parallel_turns_tp_all_reduces_into_reduce_scatters():
    """Under ``sequence_parallel()`` the forward's TP all-reduces become
    reduce-scatters and a rank moves fewer bytes; the train step's
    all-reduces drop too (its backward gathers more, so its bytes rise:
    PERF.md §6)."""
    cfg = reduced(load_config("smollm-135m"))
    got = {}
    with lm.fake_world(8):
        mesh = lm.make_mesh((2, 4), ("data", "model"), "cpu")
        for kind in ("prefill", "train"):
            shape = InputShape(kind, 32, 8, kind)
            base = steps.lower_cell(cfg, shape, mesh)["coll"]
            with shr.sequence_parallel():
                sp = steps.lower_cell(cfg, shape, mesh)["coll"]
            got[kind] = base, sp
    base, sp = got["prefill"]
    assert base["count"]["all-reduce"] > 0 == sp["count"]["all-reduce"]
    assert sp["count"]["reduce-scatter"] > 0
    assert sp["total"] < base["total"]
    base, sp = got["train"]
    assert sp["count"]["all-reduce"] < base["count"]["all-reduce"]


# -- the sharded steps on real ranks (imported by name in each rank) ---------

def _cell_inputs_whole(cfg, shape, kind, meta_args, seed):
    """Whole inputs of a cell's step from a seeded generator, the same on
    every rank: params and moments normal × 0.02, token ids in range."""
    gen = torch.Generator().manual_seed(seed)

    def fill(t):
        if t.dtype in (torch.int32, torch.int64):
            if t.ndim == 0:
                return torch.zeros((), dtype=t.dtype)
            return torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                                 dtype=t.dtype)
        return (torch.randn(t.shape, generator=gen) * 0.02).to(t.dtype)

    return tree.tree_map(fill, meta_args)


def sharded_steps(arch: str, shapes: list, mesh_dims: tuple,
                  seed: int) -> list:
    """Reduced cells' steps (each ``shape`` = (name, seq_len, batch,
    kind)) on this rank's shards of seeded whole inputs
    (``launch/steps.lower_cell`` with ``inputs``) and, on the same
    inputs, the plain steps; both gathered whole, with the rank's
    collective counts, a dict a cell."""
    from repro_torch.configs.base import InputShape, load_config, reduced
    from repro_torch.launch import mesh as lm
    from repro_torch.launch import steps
    from torch.distributed.tensor import DTensor

    cfg = reduced(load_config(arch))
    names = ("data", "model") if len(mesh_dims) == 2 else (
        "pod", "data", "model")
    mesh = lm.make_mesh(mesh_dims, names, "cpu")
    out = []
    for shape in shapes:
        ishape = InputShape(*shape)
        kind, meta_args, _ = steps.cell_inputs(cfg, ishape, mesh)
        whole = _cell_inputs_whole(cfg, ishape, kind, meta_args, seed)
        plain_in = tree.tree_map(torch.clone, whole)
        rec = steps.lower_cell(cfg, ishape, mesh, inputs=whole)
        got = tree.tree_map(
            lambda t: t.full_tensor() if isinstance(t, DTensor) else t,
            rec["outputs"])
        if kind == "train":
            want = steps.make_train_step(cfg, steps.adamw.AdamWConfig())(
                *plain_in)
        elif kind == "prefill":
            want = steps.make_forward(cfg)(*plain_in)
        else:
            want = steps.make_decode_step(cfg)(*plain_in[:3],
                                               ishape.seq_len - 1)
        out.append({"got": got, "want": want,
                    "count": rec["coll"]["count"]})
    return out


# -- the fake world does not change the program --------------------------------

def _compare(got, want, kind, lr):
    if kind == "train":
        g_state, g_metrics = got
        w_state, w_metrics = want
        np.testing.assert_allclose(g_metrics["loss"], w_metrics["loss"],
                                   rtol=1e-4)
        for g, w in zip(tree.leaves(g_state.params),
                        tree.leaves(w_state.params)):
            np.testing.assert_allclose(g.float(), w.float(), rtol=0,
                                       atol=0.1 * lr)
        for key in ("mu", "nu"):
            for g, w in zip(tree.leaves(g_state.opt[key]),
                            tree.leaves(w_state.opt[key])):
                np.testing.assert_allclose(
                    g, w, rtol=1e-3, atol=1e-4 * float(w.abs().max()))
        return
    for g, w in zip(tree.leaves(got), tree.leaves(want)):
        np.testing.assert_allclose(g.float(), w.float(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("arch", ["smollm-135m", "llama4-scout-17b-a16e"])
def test_gloo_ranks_run_the_fake_worlds_program(arch):
    """Four CPU gloo ranks on a 2×2 mesh: the sharded decode step, forward
    and train step equal the plain step (fp32: 1e-4; train at the
    training bars of PERF.md §2), and each launches the collectives the
    fake 2×2 world counted."""
    cells = [("decode_32k", 64, 4, "decode"),
             ("prefill_32k", 32, 4, "prefill"),
             ("train_4k", 16, 4, "train")]
    cfg = reduced(load_config(arch))
    fake = {}
    with lm.fake_world(4):
        mesh = lm.make_mesh((2, 2), ("data", "model"), "cpu")
        for cell in cells:
            fake[cell] = steps.lower_cell(cfg, InputShape(*cell),
                                          mesh)["coll"]["count"]
    res = spawn(sharded_steps, 4, arch, cells, (2, 2), 0,
                backend="gloo", device="cpu", timeout_s=300)
    for i, cell in enumerate(cells):
        for r in res:
            assert r[i]["count"] == fake[cell], cell
        _compare(res[0][i]["got"], res[0][i]["want"], cell[3],
                 steps.adamw.AdamWConfig().lr)
