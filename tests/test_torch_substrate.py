"""The port's training substrate — AdamW, the LR schedule, the data
pipeline, the checkpointer and ``train_loop`` — as
``tests/test_substrate.py`` holds the reference's, plus parity with the
reference where the two compute the same thing: the schedule's values
(rtol 1e-6: fp32 cos by XLA and by PyTorch), the streams' batches (bit
for bit: the same numpy code) and the global norm (rtol 1e-6).  The
train loops run on the CPU at the reference's test sizes.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.data import DataConfig as RefDataConfig
from repro.data import file_stream as ref_file_stream
from repro.data import synthetic_stream as ref_synthetic_stream
from repro.optim import global_norm as ref_global_norm
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro_torch import tree
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import load_config, reduced
from repro_torch.data import (DataConfig, file_stream, prefetched,
                              synthetic_stream)
from repro_torch.launch import train as port_train
from repro_torch.launch.steps import TrainState
from repro_torch.launch.train import train_loop
from repro_torch.optim import (AdamWConfig, apply_updates, global_norm,
                               init_opt_state, warmup_cosine)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    repro_torch.set_device("cpu")
    yield
    repro_torch.set_device(None)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _toy_params(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "dense": {"w": torch.from_numpy(rng.normal(size=(8, 4))).float(),
                  "bias": torch.zeros(4)},
        "norm": {"scale": torch.ones(8)},
    }


def test_adamw_converges_on_quadratic():
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0, grad_clip_norm=1e9)
    params = _toy_params()
    target = tree.tree_map(torch.ones_like, params)
    state = init_opt_state(params, cfg)

    def loss(p):
        return sum(((a - b) ** 2).sum() for a, b in zip(
            tree.leaves(p), tree.leaves(target)))

    l0 = float(loss(params))
    for _ in range(200):
        leaves = [p.detach().requires_grad_() for p in tree.leaves(params)]
        grads = torch.autograd.grad(loss(tree.unflatten(params, leaves)),
                                    leaves)
        params, state, _ = apply_updates(
            params, tree.unflatten(params, list(grads)), state, cfg)
    assert float(loss(params)) < 1e-3 * l0


def test_adamw_grad_clip():
    cfg = AdamWConfig(lr=1e-3, grad_clip_norm=1.0)
    params = _toy_params()
    state = init_opt_state(params, cfg)
    huge = tree.tree_map(lambda p: 1e6 * torch.ones_like(p), params)
    new_params, _, info = apply_updates(params, huge, state, cfg)
    # update magnitude bounded: params can't move more than ~lr per element
    delta = max(float((a - b).abs().max()) for a, b in zip(
        tree.leaves(new_params), tree.leaves(params)))
    assert delta < 10 * cfg.lr
    assert float(info["grad_norm"]) > 1e5


def test_adamw_no_decay_on_norm_and_bias():
    cfg = AdamWConfig(lr=0.0, weight_decay=1.0)  # lr 0: only decay matters
    params = _toy_params()
    state = init_opt_state(params, cfg)
    zeros = tree.tree_map(torch.zeros_like, params)
    new_params, _, _ = apply_updates(params, zeros, state, cfg)
    # with lr=0 nothing changes at all — decay also scales by lr
    for a, b in zip(tree.leaves(new_params), tree.leaves(params)):
        assert torch.equal(a, b)
    # with lr > 0 and zero grads only the decayed leaf moves: w, not the
    # norm's scale or the bias
    moved, _, _ = apply_updates(params, zeros, state,
                                AdamWConfig(lr=0.1, weight_decay=1.0))
    assert not torch.equal(moved["dense"]["w"], params["dense"]["w"])
    assert torch.equal(moved["dense"]["bias"], params["dense"]["bias"])
    assert torch.equal(moved["norm"]["scale"], params["norm"]["scale"])


def test_adamw_keeps_bf16_params_and_fp32_state():
    """bf16 params are updated in the state dtype and rounded back (no
    master copy); the moments stay fp32."""
    cfg = AdamWConfig(lr=1e-2)
    params = tree.tree_map(lambda p: p.to(torch.bfloat16), _toy_params())
    state = init_opt_state(params, cfg)
    grads = tree.tree_map(torch.ones_like, params)
    new_params, new_state, _ = apply_updates(params, grads, state, cfg)
    assert all(p.dtype == torch.bfloat16 for p in tree.leaves(new_params))
    assert all(m.dtype == torch.float32 for m in
               tree.leaves(new_state["mu"]) + tree.leaves(new_state["nu"]))
    # the update is computed in fp32 and rounded once: the fp32 step on
    # the same values, rounded to bf16
    as32 = tree.tree_map(lambda p: p.float(), params)
    want, _, _ = apply_updates(as32, tree.tree_map(lambda g: g.float(),
                                                   grads),
                               init_opt_state(as32, cfg), cfg)
    for a, b in zip(tree.leaves(new_params), tree.leaves(want)):
        assert torch.equal(a, b.to(torch.bfloat16))


def test_global_norm_matches_reference():
    rng = np.random.default_rng(3)
    leaves = [rng.normal(size=s).astype(np.float32)
              for s in ((5, 7), (11,), (2, 3, 4))]
    got = global_norm({"a": [torch.from_numpy(x) for x in leaves]})
    want = ref_global_norm({"a": [jnp.asarray(x) for x in leaves]})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# LR schedule
# ---------------------------------------------------------------------------

def test_warmup_cosine_shape():
    s = [float(warmup_cosine(i, warmup_steps=10, total_steps=100))
         for i in range(100)]
    assert s[0] == 0.0
    assert abs(s[10] - 1.0) < 0.11
    assert s[99] < 0.2
    assert max(s) <= 1.0 + 1e-6


@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 30), (1, 3),
                                          (200, 10_000), (5, 5)])
def test_warmup_cosine_matches_reference(warmup, total):
    """The schedule's values at every step up to past the horizon, from an
    int and from an int32 tensor step, within rtol 1e-6 of the
    reference's; a 0-d fp32 tensor."""
    for step in range(0, total + 5, max(1, total // 50)):
        want = float(ref_warmup_cosine(step, warmup_steps=warmup,
                                       total_steps=total))
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            got = warmup_cosine(s, warmup_steps=warmup, total_steps=total)
            assert got.dtype == torch.float32 and got.ndim == 0
            np.testing.assert_allclose(float(got), want, rtol=1e-6,
                                       atol=1e-7)


# ---------------------------------------------------------------------------
# Data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch,seq,vocab,seed", [(2, 16, 64, 3),
                                                  (8, 64, 256, 0),
                                                  (4, 33, 49_152, 7)])
def test_synthetic_stream_is_the_references(batch, seq, vocab, seed):
    """Bit for bit the reference's batches, from step 0 and resumed."""
    for start in (0, 5):
        ours = synthetic_stream(DataConfig(batch, seq, vocab, seed),
                                start_step=start)
        ref = ref_synthetic_stream(RefDataConfig(batch, seq, vocab, seed),
                                   start_step=start)
        for _ in range(4):
            a, b = next(ours), next(ref)
            assert a["step"] == b["step"]
            assert a["tokens"].dtype == b["tokens"].dtype == np.int32
            np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_file_stream_is_the_references(tmp_path):
    path = str(tmp_path / "tokens.bin")
    np.random.default_rng(0).integers(0, 1000, size=4096).astype(
        np.int32).tofile(path)
    ours = file_stream(path, DataConfig(3, 20, 1000, seed=2), start_step=1)
    ref = ref_file_stream(path, RefDataConfig(3, 20, 1000, seed=2),
                          start_step=1)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert a["step"] == b["step"]
        np.testing.assert_array_equal(a["tokens"], b["tokens"])


def test_synthetic_stream_deterministic_resume():
    cfg = DataConfig(batch_size=2, seq_len=16, vocab_size=64, seed=3)
    a = synthetic_stream(cfg)
    batches = [next(a) for _ in range(6)]
    # resume from step 3 must reproduce batch 3 exactly
    resumed = next(synthetic_stream(cfg, start_step=3))
    np.testing.assert_array_equal(batches[3]["tokens"], resumed["tokens"])


def test_prefetched_pipeline_preserves_order():
    cfg = DataConfig(batch_size=1, seq_len=8, vocab_size=32)
    direct = synthetic_stream(cfg)
    want = [next(direct)["tokens"] for _ in range(5)]
    fifo = prefetched(synthetic_stream(cfg), depth=3)
    for i, a in enumerate(want):
        item = next(fifo)
        assert item["step"] == i
        assert isinstance(item["tokens"], torch.Tensor)
        assert item["tokens"].device.type == "cpu"
        np.testing.assert_array_equal(a, item["tokens"].numpy())


def test_stream_is_learnable_structure():
    """The synthetic process must be predictable (loss can decrease)."""
    cfg = DataConfig(batch_size=4, seq_len=32, vocab_size=64)
    batch = next(synthetic_stream(cfg))["tokens"]
    same = (np.diff(batch, axis=1) == 0).mean()
    assert same > 0.3


# ---------------------------------------------------------------------------
# Checkpointer
# ---------------------------------------------------------------------------

def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(rng.normal(size=(4, 4))
                                             .astype(np.float32))},
            "step": torch.tensor(seed, dtype=torch.int32)}


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    s = _state(7)
    ck.save(7, s, blocking=True)
    restored, step = ck.restore(_state(0))
    assert step == 7
    assert torch.equal(restored["params"]["w"], s["params"]["w"])
    assert restored["step"].dtype == torch.int32 and int(restored["step"]) == 7


def test_checkpoint_keep_n_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for i in range(5):
        ck.save(i, _state(i), blocking=True)
    assert ck.all_steps() == [3, 4]
    assert ck.latest_step() == 4


def test_checkpoint_atomic_no_partial(tmp_path):
    """A .tmp file lying around must never be visible as a checkpoint."""
    ck = Checkpointer(str(tmp_path), keep=3)
    ck.save(1, _state(1), blocking=True)
    with open(os.path.join(str(tmp_path), "step_00000002.tmp"), "wb") as f:
        f.write(b"garbage")
    assert ck.all_steps() == [1]
    _, step = ck.restore(_state(0))
    assert step == 1


def test_checkpoint_shape_mismatch_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _state(1), blocking=True)
    bad = {"params": {"w": torch.zeros(2, 2)},
           "step": torch.zeros((), dtype=torch.int32)}
    with pytest.raises(ValueError, match="shape"):
        ck.restore(bad)


def test_checkpoint_bf16_bits_round_trip(tmp_path):
    """Every one of the 65,536 bfloat16 bit patterns (NaNs, infinities,
    subnormals, -0) is stored as its 16 bits and restored bit for bit,
    with its dtype in the manifest."""
    bits = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(torch.int16)
    state = {"p": bits.view(torch.bfloat16).reshape(256, 256)}
    ck = Checkpointer(str(tmp_path))
    ck.save(3, state, blocking=True)
    with open(tmp_path / "step_00000003.json") as f:
        assert json.load(f)["dtypes"] == {"p": "bfloat16"}
    example = {"p": torch.zeros(256, 256, dtype=torch.bfloat16)}
    restored, _ = ck.restore(example)
    assert restored["p"].dtype == torch.bfloat16
    assert torch.equal(restored["p"].view(torch.int16),
                       state["p"].view(torch.int16))


def test_checkpoint_train_state_tree(tmp_path):
    """A TrainState (dataclass, per-repeat lists, nested dicts) round-trips
    under its paths' names; the snapshot is a copy, so a later in-place
    change to the live state does not reach the file."""
    params = {"embed": {"table": torch.randn(6, 4)},
              "segment_0": [[{"w": torch.randn(4, 4)}],
                            [{"w": torch.randn(4, 4)}]]}
    opt = init_opt_state(params, AdamWConfig())
    st = TrainState(params, opt, torch.tensor(9, dtype=torch.int32))
    want = [t.clone() for t in tree.leaves(st)]
    ck = Checkpointer(str(tmp_path))
    ck.save(9, st)
    params["segment_0"][1][0]["w"].add_(1.0)
    ck.wait()
    with open(tmp_path / "step_00000009.json") as f:
        names = json.load(f)["names"]
    assert "params/segment_0/1/0/w" in names and "opt/count" in names
    example = TrainState(tree.tree_map(torch.zeros_like, params),
                         init_opt_state(params, AdamWConfig()),
                         torch.zeros((), dtype=torch.int32))
    restored, step = ck.restore(example)
    assert step == 9 and isinstance(restored, TrainState)
    for a, b in zip(tree.leaves(restored), want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# train_loop: failure recovery, resume, falling loss (the reference's sizes)
# ---------------------------------------------------------------------------

def test_train_recovers_from_injected_failure(tmp_path):
    cfg = reduced(load_config("smollm-135m"), max_repeats=1)
    # run A: uninterrupted
    out_a = train_loop(cfg, steps=12, batch_size=2, seq_len=16,
                       ckpt_dir=str(tmp_path / "a"), ckpt_every=4)
    # run B: failure injected at step 9 → restore from ckpt 8 → same result
    out_b = train_loop(cfg, steps=12, batch_size=2, seq_len=16,
                       ckpt_dir=str(tmp_path / "b"), ckpt_every=4,
                       fail_at=9)
    assert out_b["failures"] == 1 and out_b["restores"] == 1
    assert len(out_b["losses"]) == len(out_b["step_s"]) == 12
    np.testing.assert_allclose(out_a["final_loss"], out_b["final_loss"],
                               rtol=1e-5)


def test_train_failure_without_a_checkpoint_raises():
    """With nothing to restore from, the failure propagates."""
    from repro_torch.runtime.fault_tolerance import StepFailure
    cfg = reduced(load_config("smollm-135m"), max_repeats=1)
    with pytest.raises(StepFailure):
        train_loop(cfg, steps=3, batch_size=2, seq_len=16, fail_at=1)


def test_train_resume_matches_uninterrupted(tmp_path):
    """Kill after 8 steps, restart to 12 — the same final loss as a single
    12-step run (deterministic data + bitwise state restore)."""
    cfg = reduced(load_config("smollm-135m"), max_repeats=1)
    full = train_loop(cfg, steps=12, batch_size=2, seq_len=16,
                      ckpt_dir=str(tmp_path / "full"), ckpt_every=100)
    part1 = train_loop(cfg, steps=8, batch_size=2, seq_len=16,
                       ckpt_dir=str(tmp_path / "r"), ckpt_every=100,
                       schedule_steps=12)
    part2 = train_loop(cfg, steps=12, batch_size=2, seq_len=16,
                       ckpt_dir=str(tmp_path / "r"), ckpt_every=100,
                       schedule_steps=12)
    assert len(part1["losses"]) == 8 and len(part2["losses"]) == 4
    np.testing.assert_allclose(full["final_loss"], part2["final_loss"],
                               rtol=1e-5)


def test_train_loss_decreases(tmp_path):
    cfg = reduced(load_config("smollm-135m"), d_model=128, max_repeats=2)
    out = train_loop(cfg, steps=40, batch_size=8, seq_len=64,
                     ckpt_dir=str(tmp_path), ckpt_every=50, lr=1e-3)
    first = float(np.mean(out["losses"][:5]))
    last = float(np.mean(out["losses"][-5:]))
    assert last < first, (first, last)


def test_train_cli_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train ... --device cpu`` trains,
    checkpoints and prints the final loss; without a card it refuses the
    default device."""
    port_train.main(["--arch", "olmo-1b", "--reduced", "--steps", "4",
                     "--batch", "2", "--seq", "16", "--device", "cpu",
                     "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert "final loss:" in out and "failures=0 restores=0" in out
    assert Checkpointer(str(tmp_path)).all_steps() == [2, 4]
    if not torch.cuda.is_available():
        repro_torch.set_device(None)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_train.main(["--arch", "olmo-1b", "--reduced",
                             "--steps", "1"])


def test_train_loop_state_lives_on_the_device():
    cfg = reduced(load_config("smollm-135m"), max_repeats=1)
    out = train_loop(cfg, steps=2, batch_size=2, seq_len=16, device="cpu")
    st = out["state"]
    assert int(st.step) == 2 and int(st.opt["count"]) == 2
    assert all(t.device.type == "cpu" for t in tree.leaves(st))
