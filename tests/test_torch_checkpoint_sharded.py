"""Elastic checkpoints and sharded batches on ranks: ``Checkpointer.save``
of a state whose leaves are DTensors, ``Checkpointer.restore(shardings=)``
and ``prefetched(sharding=)``.

One ``spawn`` of 4 gloo CPU ranks runs ``chip_smoke.elastic_rank`` (phase
15b of ``chip_smoke.py``, here at a reduced SmolLM-135M in bf16 with fp32
moments): the one-process checkpoint restored onto a 2×2 and a 4×1
``("data", "model")`` mesh; the 2×2 state saved sharded (F11: a DTensor
leaf made ``save`` raise) and restored on both meshes; every rank's
every local shard held bit for bit to its chunk of the plain restore;
three prefetched batches a mesh held to the chunks of the unsharded
stream; a shape mismatch.  The sharded checkpoint is then restored whole
in this process.  The reference's ``restore(shardings=)`` places leaves
with ``jax.device_put`` (``src/repro/checkpoint/checkpointer.py:124``);
the port's placed leaf keeps the stored dtype, as the reference's does.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import tree
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import load_config, reduced
from repro_torch.launch import steps
from repro_torch.launch.mesh import spawn

BATCH, SEQ, BATCHES = 8, 32, 3


@pytest.fixture(autouse=True)
def _port_on_cpu():
    repro_torch.set_device("cpu")
    yield
    repro_torch.set_device(None)


def _cfg():
    return dataclasses.replace(reduced(load_config("smollm-135m")),
                               dtype="bfloat16")


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    import chip_smoke
    return chip_smoke


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    """The state, the ranks' results and the sharded checkpoint restored
    whole here."""
    cs = _chip_smoke()
    repro_torch.set_device("cpu")
    work = tmp_path_factory.mktemp("elastic")
    plain_dir, sharded_dir = str(work / "plain"), str(work / "sharded")
    cfg = _cfg()
    state = cs.elastic_state(cfg, torch.device("cpu"), seed=15)
    Checkpointer(plain_dir).save(7, state, blocking=True)
    res = spawn(cs.elastic_rank, 4, plain_dir, sharded_dir, cfg, BATCH, SEQ,
                BATCHES, 15, backend="gloo", device="cpu", timeout_s=300)
    abstract = steps.abstract_train_state(cfg, steps.adamw.AdamWConfig())
    whole, step = Checkpointer(sharded_dir).restore(abstract)
    return {"state": state, "ranks": res, "whole": whole, "step": step}


def _same_bits(a, b):
    bits = _chip_smoke()._bits
    return a.dtype == b.dtype and torch.equal(bits(a), bits(b))


def test_sharded_save_writes_the_whole_state(elastic):
    """F11: the 2×2 DTensor state saved from every rank (rank 0 writes)
    restores whole in one process, bit for bit the state, bf16 params
    and fp32 moments; after ``wait`` every rank sees the step."""
    assert elastic["step"] == 11
    got, want = tree.leaves(elastic["whole"]), tree.leaves(elastic["state"])
    assert len(got) == len(want)
    assert {t.dtype for t in want} == {torch.bfloat16, torch.float32,
                                       torch.int32}
    for g, w in zip(got, want):
        assert _same_bits(g, w)
    assert [r["latest"] for r in elastic["ranks"]] == [11] * 4


@pytest.mark.parametrize("source", ["plain", "sharded"])
@pytest.mark.parametrize("dims", [(2, 2), (4, 1)])
def test_restore_places_each_rank_chunk(elastic, source, dims):
    """``restore(shardings=train_state_shardings)`` on each mesh: every
    leaf is a DTensor on that mesh whose local shard is this rank's
    chunk of the plain restore, bit for bit; the ranks hold the state
    between them."""
    recs = [r[source, dims] for r in elastic["ranks"]]
    assert all(rec["ok"] for rec in recs)
    assert all(rec["step"] == (7 if source == "plain" else 11)
               for rec in recs)
    nbytes = sum(t.numel() * t.element_size()
                 for t in tree.leaves(elastic["state"]))
    held = sum(rec["bytes"] for rec in recs)
    assert nbytes <= held < 4 * nbytes     # sharded leaves split, others copy


@pytest.mark.parametrize("dims", [(2, 2), (4, 1)])
def test_prefetched_gives_each_rank_its_chunk(elastic, dims):
    """``prefetched(sharding=batch_shardings(...)["tokens"])``: three
    batches, each rank's local tokens the chunk of the unsharded
    stream's batch, split over the data axis."""
    for r in elastic["ranks"]:
        rec = r["batches", dims]
        assert rec["ok"]
        assert rec["local"] == (BATCH // dims[0], SEQ + 1)


def test_shape_mismatch_raises_value_error(elastic):
    """A stored shape that differs from the example's raises
    ``ValueError`` naming the leaf, on every rank."""
    for r in elastic["ranks"]:
        assert "params/embed/table" in r["mismatch"]
        assert "checkpoint shape" in r["mismatch"]


def test_restore_of_a_meta_example_lands_on_the_port_device(tmp_path):
    """Without shardings a ``meta`` example's leaf goes to the port's
    device in the example's dtype, as before for a real example."""
    cfg = _cfg()
    state = _chip_smoke().elastic_state(cfg, torch.device("cpu"), seed=3)
    ck = Checkpointer(str(tmp_path))
    ck.save(2, state, blocking=True)
    abstract = steps.abstract_train_state(cfg, steps.adamw.AdamWConfig())
    got, step = ck.restore(abstract)
    assert step == 2
    for g, w in zip(tree.leaves(got), tree.leaves(state)):
        assert g.device.type == "cpu" and _same_bits(g, w)


def test_shardings_must_name_the_state_leaves(tmp_path):
    """A shardings tree of another structure raises ``ValueError``
    before anything is placed."""
    cfg = _cfg()
    state = _chip_smoke().elastic_state(cfg, torch.device("cpu"), seed=3)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state, blocking=True)
    with pytest.raises(ValueError, match="shardings and state differ"):
        ck.restore(state, shardings={"params": None})


@pytest.mark.cuda
def test_phase15b_at_reduced_size():
    """``chip_smoke.py`` phase 15b on the card at the reduced config: 4
    gloo ranks sharing it, the shards host-staged for the sharded
    save."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    res = _chip_smoke().elastic_checkpoints(torch.device("cuda"), "card",
                                            cfg=_cfg(), batch=BATCH,
                                            seq=SEQ)
    assert len(res) == 4 and all(r["latest"] == 11 for r in res)
    assert np.isfinite([r["peak_gib"] for r in res]).all()
