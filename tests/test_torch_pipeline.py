"""The port's multi-rank pipeline executors against the JAX reference.

``pipeline_apply`` (GPipe over ``torch.distributed`` ranks), its
one-device oracle ``pipeline_apply_emulated``,
``SystolicPipeline.build_sharded`` and the ``systolic`` backend, with the
ranks started by ``repro_torch.launch.mesh.spawn``: CPU processes under
gloo, meeting through a ``FileStore``, each spawn bounded by a timeout.
The reference's multi-device executors run on 8 forced host devices in a
subprocess, and ``jax.grad`` through its ``pipeline_apply`` fails under
jax 0.9.0, so the ranks are held against the reference's
``pipeline_apply_emulated`` and ``jax.grad`` of it, and against its
``run_emulated`` — on the same seeded numpy inputs.  The rank functions
live in ``tests/_torch_ranks.py`` (torch only).  Tests marked ``cuda``
run the same on ranks sharing the card (the host-staged route) and phase
13 of ``chip_smoke.py`` at a reduced depth.
"""

import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
import repro_torch
from repro.core import CDFG, SystolicPipeline as RefSystolicPipeline
from repro.core import decouple as ref_decouple
from repro.core import partition_cdfg as ref_partition
from repro.core import pipeline_apply_emulated as ref_emulated
from repro.kernels import decoupled_gather_ref as ref_gather
from repro_torch import tree
from repro_torch.core import pipeline_apply_emulated
from repro_torch.dataflow import BackendUnavailableError
from repro_torch.dataflow import compile as port_compile
from repro_torch.launch.mesh import RankError, spawn

TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _port_on_cpu():
    repro_torch.set_device("cpu")
    yield
    repro_torch.set_device(None)


def _on_cpu(fn, world, *args):
    return spawn(fn, world, *args, backend="gloo", device="cpu",
                 timeout_s=TIMEOUT_S)


def _ref_tanh_linear(w, x):
    return jnp.tanh(x @ w)


def _ref_mini_block(p, x):
    h = jnp.tanh(x @ p["w_qkv"])
    return x + jnp.tanh(h @ p["w_ff"])


def _ref_loss_grads(stage_fn, params, mbs, S):
    """The reference's emulated forward and ``jax.grad`` of ``mean(y²)``
    with respect to the parameters and the microbatches."""
    def loss(p, x):
        return jnp.mean(ref_emulated(stage_fn, p, x, num_stages=S) ** 2)

    y = ref_emulated(stage_fn, params, mbs, num_stages=S)
    gp, gx = jax.grad(loss, argnums=(0, 1))(params, mbs)
    return np.asarray(y), jax.tree_util.tree_map(np.asarray, gp), \
        np.asarray(gx)


def _summed(results, key):
    """The full gradient: the sum of the ranks' shares."""
    return tree.tree_map(lambda *gs: sum(g.numpy() for g in gs),
                         *[r[key] for r in results])


def _linear_inputs(S, M, D, scale=0.2, seed=0):
    rng = np.random.default_rng(seed)
    params = (rng.normal(size=(S, D, D)) * scale).astype(np.float32)
    mbs = rng.normal(size=(M, D)).astype(np.float32)
    return params, mbs


# -- the one-device oracle -------------------------------------------------------

def test_pipeline_apply_emulated_matches_reference():
    """``tests/test_core_pipeline.py:177``'s S = 4, M = 6, D = 8: forward
    against the reference's emulation and its sequential product (rtol
    1e-5), grads against ``jax.grad`` of it (rtol 1e-4, atol 1e-6)."""
    S, M, D = 4, 6, 8
    params, mbs = _linear_inputs(S, M, D, scale=0.1)
    p = torch.tensor(params, requires_grad=True)
    x = torch.tensor(mbs, requires_grad=True)
    y = pipeline_apply_emulated(ranks.tanh_linear, p, x, num_stages=S)
    gp, gx = torch.autograd.grad((y ** 2).mean(), [p, x])
    want, want_gp, want_gx = _ref_loss_grads(_ref_tanh_linear, params, mbs, S)
    np.testing.assert_allclose(y.detach().numpy(), want, rtol=1e-5)
    seq = mbs
    for s in range(S):
        seq = np.tanh(seq @ params[s])
    np.testing.assert_allclose(y.detach().numpy(), seq, rtol=1e-5)
    np.testing.assert_allclose(gp.numpy(), want_gp, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gx.numpy(), want_gx, rtol=1e-4, atol=1e-6)


# -- pipeline_apply on ranks ------------------------------------------------------

@pytest.mark.parametrize("S,M,D", [(8, 16, 4),   # test_multidevice.py:60
                                   (1, 4, 4),    # a group of one rank
                                   (4, 2, 4)])   # fewer microbatches than stages
def test_pipeline_apply_on_ranks_fwd_and_grad(S, M, D):
    """Every rank's replicated output against the reference's emulated
    forward (rtol 1e-5, atol 1e-6); the ranks' summed gradient shares of
    ``mean(y²)`` against ``jax.grad`` (rtol 1e-4, atol 1e-6): parameters
    and microbatches.  Rank r's share of a parameter is nonzero only in
    its slice r, and only rank 0's microbatch share is nonzero."""
    params, mbs = _linear_inputs(S, M, D)
    res = _on_cpu(ranks.gpipe, S, "tanh_linear", params, mbs)
    want, want_gp, want_gx = _ref_loss_grads(_ref_tanh_linear, params, mbs, S)
    for r in res:
        np.testing.assert_allclose(r["y"].numpy(), want, rtol=1e-5,
                                   atol=1e-6)
        others = np.delete(r["grads"].numpy(), r["rank"], axis=0)
        assert not others.any(), f"rank {r['rank']} touched another slice"
        if r["rank"] > 0:
            assert not r["g_mbs"].numpy().any()
    np.testing.assert_allclose(_summed(res, "grads"), want_gp, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(_summed(res, "g_mbs"), want_gx, rtol=1e-4,
                               atol=1e-6)


def test_transformer_pipeline_on_ranks():
    """``tests/test_multidevice.py:121``'s mini transformer, one block per
    stage on 4 ranks, 8 microbatches of (2, 16, 32): the sequential
    forward and the reference's emulation (rtol 1e-5, atol 1e-6), and the
    grads against ``jax.grad`` of the emulation (rtol 1e-4, atol 1e-6)."""
    S, M, B, L, D = 4, 8, 2, 16, 32
    rng = np.random.default_rng(0)
    params = {k: (rng.normal(size=(S, D, D)) * 0.05).astype(np.float32)
              for k in ("w_qkv", "w_ff")}
    mbs = rng.normal(size=(M, B, L, D)).astype(np.float32)
    res = _on_cpu(ranks.gpipe, S, "mini_block", params, mbs)
    want, want_gp, _ = _ref_loss_grads(_ref_mini_block, params, mbs, S)
    seq = []
    for m in range(M):
        x = jnp.asarray(mbs[m])
        for s in range(S):
            x = _ref_mini_block({k: v[s] for k, v in params.items()}, x)
        seq.append(np.asarray(x))
    for r in res:
        np.testing.assert_allclose(r["y"].numpy(), np.stack(seq), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(r["y"].numpy(), want, rtol=1e-5,
                                   atol=1e-6)
    got = _summed(res, "grads")
    for k in params:
        np.testing.assert_allclose(got[k], want_gp[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_pipeline_apply_on_a_subgroup():
    """Three of four ranks form the pipeline's group (as phase 13 runs
    it beside a fourth rank); the fourth takes part in creating the group
    only."""
    S, M, D = 3, 5, 4
    params, mbs = _linear_inputs(S, M, D, seed=1)
    res = _on_cpu(ranks.gpipe_on_subgroup, 4, "tanh_linear", params, mbs,
                  [0, 1, 2])
    want, want_gp, _ = _ref_loss_grads(_ref_tanh_linear, params, mbs, S)
    assert res[3] == {}
    for r in res[:3]:
        np.testing.assert_allclose(r["y"].numpy(), want, rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(_summed(res[:3], "grads"), want_gp,
                               rtol=1e-4, atol=1e-6)


# -- the systolic executor and backend --------------------------------------------

def _quickstart_kernel(x, idx, w):
    a = x[idx]
    b = a * w
    return jnp.tanh(b) + 1.0


def _two_streams(table, idx, scale):
    return table[idx] * scale


def _ref_run_emulated(fn, args, stream_argnums):
    example = [a[0] if i in stream_argnums else a
               for i, a in enumerate(args)]
    prog = ref_decouple(ref_partition(CDFG.from_function(fn, *example)))
    pipe = RefSystolicPipeline(prog, stream_argnums=stream_argnums)
    return pipe.num_stages, pipe.run_emulated(*[jnp.asarray(a)
                                                for a in args])


@pytest.mark.parametrize("kernel", ["quickstart", "two_streams"])
def test_build_sharded_matches_reference(kernel):
    """``tests/test_multidevice.py:31``'s kernel (T = 9, one stream
    argument) and ``tests/test_core_pipeline.py:158``'s two stream
    arguments, one stage per rank: every rank's outputs equal the
    reference's ``run_emulated`` (rtol 1e-6) and the port's own."""
    if kernel == "quickstart":
        T = 9
        args = [np.arange(64, dtype=np.float32),
                np.stack([(np.arange(8) * (t + 1)) % 64 for t in range(T)]
                         ).astype(np.int32), np.float32(0.5)]
        argnums, ref_fn = (1,), _quickstart_kernel
    else:
        T = 4
        args = [np.arange(32, dtype=np.float32),
                np.stack([np.arange(4) + t for t in range(T)]
                         ).astype(np.int32),
                np.arange(1., T + 1., dtype=np.float32)]
        argnums, ref_fn = (1, 2), _two_streams
    S, want = _ref_run_emulated(ref_fn, args, argnums)
    res = _on_cpu(ranks.systolic, S, kernel, args, argnums)
    for r in res:
        assert r["stages"] == S
        assert len(r["outs"]) == len(want)
        for got, emu, w in zip(r["outs"], r["emulated"], want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-6)
            assert torch.equal(got, emu)


def _quickstart_args():
    table = np.arange(1024, dtype=np.float32)
    idx = np.array([3, 997, 41, 512, 7, 800, 64, 2], dtype=np.int32)
    stream = np.stack([(idx + t) % 1024 for t in range(6)])
    return table, idx, np.float32(1.5), stream


def test_systolic_backend_on_ranks():
    """The quickstart kernel on 4 ranks (4 stages): every execute backend,
    ``systolic`` included, equals the direct call on every rank, as
    ``tests/test_dataflow_driver.py:53``; a 6-microbatch stream through
    the sharded pipeline equals the reference's direct calls."""
    table, idx, w, stream = _quickstart_args()
    res = _on_cpu(ranks.backends, 4, table, idx, w, stream)
    want = np.asarray(_quickstart_kernel(jnp.asarray(table), idx, w))
    want_stream = np.stack([np.asarray(_quickstart_kernel(
        jnp.asarray(table), s, w)) for s in stream])
    for r in res:
        assert r["stages"] == 4 and "systolic" in r["available"]
        assert r["route"] == "gloo"
        assert set(r["got"]) == {"eager", "emulated", "sequential",
                                 "systolic"}
        for name, got in r["got"].items():
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       err_msg=name)
            assert torch.equal(got, r["direct"]), name
        np.testing.assert_allclose(r["stream"].numpy(), want_stream,
                                   rtol=1e-6)


def test_systolic_backend_outside_a_group_raises():
    """In one process the backend is unavailable and a call raises,
    naming how to get ranks; the stages never run elsewhere instead."""
    table, idx, w, _ = _quickstart_args()
    c = port_compile(ranks._quickstart_kernel, torch.tensor(table),
                     torch.tensor(idx), torch.tensor(w), stream_argnums=(1,))
    assert "systolic" not in c.backends()
    with pytest.raises(BackendUnavailableError,
                       match=r"needs 4 ranks.*launch\.mesh\.spawn.*torchrun "
                             r"--nproc-per-node 4"):
        c(torch.tensor(table), torch.tensor(idx), torch.tensor(w),
          backend="systolic")


def test_staged_gather_on_systolic_ranks():
    """``decoupled_gather_staged(..., backend="systolic")`` (3 stages) on 4
    ranks — the first 3 run the stages, the fourth receives — bit for bit
    the port's plain ``decoupled_gather_ref`` and within 1e-6 of the
    reference's (one tanh, two implementations), indices past both ends
    included."""
    rng = np.random.default_rng(0)
    table = rng.normal(size=(64, 16)).astype(np.float32)
    idx = np.concatenate([rng.integers(0, 64, 40), [64, 70, -1, -64, -65]]
                         ).astype(np.int32)
    res = _on_cpu(ranks.staged_gather, 4, idx, table)
    want = np.asarray(ref_gather(jnp.asarray(idx), jnp.asarray(table)))
    for r in res:
        assert torch.equal(r["got"], r["plain"])
        np.testing.assert_allclose(r["got"].numpy(), want, rtol=1e-6,
                                   atol=1e-6)


# -- the collectives and the ranks themselves -----------------------------------

def test_collectives_on_ranks():
    """The ring shift forward (two hops) and back, psum, pmax and
    broadcast on 3 ranks, against numpy."""
    S = 3
    vals = np.random.default_rng(2).normal(size=(S, 5)).astype(np.float32)
    res = _on_cpu(ranks.ring, S, vals, 2)
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["fwd"], vals[(r - 2) % S])
        np.testing.assert_array_equal(out["back"], vals[(r + 1) % S])
        np.testing.assert_allclose(out["sum"], vals.sum(0), rtol=1e-6)
        np.testing.assert_array_equal(out["max"], vals.max(0))
        np.testing.assert_array_equal(out["bcast"], vals[S - 1])
        assert out["route"] == "gloo"


def test_spawn_raises_when_a_rank_raises():
    """A rank that raises makes ``spawn`` raise with its traceback while
    the others wait in a barrier it never reaches — within the timeout,
    not at it."""
    t0 = time.monotonic()
    with pytest.raises(RankError, match="rank 2 fails on purpose"):
        _on_cpu(ranks.fail_on, 4, 2)
    assert time.monotonic() - t0 < TIMEOUT_S / 2


def test_spawn_raises_when_a_rank_dies_or_hangs():
    """A rank that exits without returning, and ranks that outlast
    ``timeout_s``, make ``spawn`` raise; nothing is left running."""
    with pytest.raises(RankError, match="exited with code 3"):
        _on_cpu(os._exit, 2, 3)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"did not return within 5"):
        spawn(time.sleep, 2, 60, backend="gloo", device="cpu", timeout_s=5)
    assert time.monotonic() - t0 < 30


def test_spawn_refuses_nccl_without_a_card_per_rank():
    with pytest.raises(ValueError, match="nccl needs one card per rank"):
        spawn(time.sleep, 2, 0, backend="nccl", device="cpu")


# -- on the card ------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    from repro_torch.kernels import _lib
    _lib.build_all()        # before any rank starts
    return torch.device("cuda")


@pytest.mark.cuda
def test_pipeline_apply_on_ranks_sharing_the_card():
    """3 ranks on ``cuda:0`` under gloo (the host-staged shift): the
    forward and the summed gradient shares against the emulation and its
    autograd on the card (fp32; rtol 1e-5 / 1e-4, atol 1e-6)."""
    _card()
    S, M, D = 3, 6, 64
    params, mbs = _linear_inputs(S, M, D, scale=0.1)
    res = spawn(ranks.gpipe, S, "tanh_linear", params, mbs, backend="gloo",
                device="cuda", timeout_s=TIMEOUT_S)
    want = spawn(ranks.emulated, 1, "tanh_linear", params, mbs, S,
                 backend="gloo", device="cuda", timeout_s=TIMEOUT_S)[0]
    for r in res:
        np.testing.assert_allclose(r["y"].numpy(), want["y"].numpy(),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_summed(res, "grads"),
                               want["grads"].numpy(), rtol=1e-4, atol=1e-6)
    probe = spawn(ranks.ring, S, mbs[:S], 1, backend="gloo", device="cuda",
                  timeout_s=TIMEOUT_S)
    assert probe[0]["route"] == "gloo host-staged"


@pytest.mark.cuda
def test_systolic_and_compress_on_ranks_sharing_the_card():
    """The quickstart kernel's backends and stream on 4 ranks on the card,
    and ``compressed_psum`` on 3 ranks there within the reference's
    bound (S · ½ · the shared scale of each chunk); calls made again pin
    no new staging buffers."""
    _card()
    table, idx, w, stream = _quickstart_args()
    res = spawn(ranks.backends, 4, table, idx, w, stream, backend="gloo",
                device="cuda", timeout_s=TIMEOUT_S)
    for r in res:
        assert r["route"] == "gloo host-staged"
        for name, got in r["got"].items():
            assert torch.equal(got, r["direct"]), name
    xs = np.random.default_rng(0).normal(size=(3, 1000)).astype(np.float32)
    out = spawn(ranks.compress, 3, xs, backend="gloo", device="cuda",
                timeout_s=TIMEOUT_S)
    scale = np.repeat(np.abs(np.pad(xs, ((0, 0), (0, 24)))).reshape(
        3, -1, 256).max(axis=(0, 2)) / 127.0, 256)[:1000]
    for r in out:
        assert np.all(np.abs(r["got"].numpy() - xs.sum(0))
                      <= 3 * 0.5 * scale * (1 + 1e-4) + 1e-6)
        first, again = r["pinned"]
        assert first > 0 and again == first


@pytest.mark.cuda
def test_phase13_at_reduced_depth():
    """``chip_smoke.py`` phase 13 at 6 blocks (3 stages of 2), 4
    microbatches of 1 × 64 tokens: 13a-13d to their bars."""
    import chip_smoke
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = chip_smoke.pipelined_smollm(dev, num_layers=6, microbatches=4,
                                      seq=64)
    assert out["flash_attention"] == 2 * 4 * 3
