"""The port's LM serving path (repro_torch.models, repro_torch.launch.serve)
against the JAX reference on reduced SmolLM-135M.

The reference's parameters are drawn once from its own init, carried
across with ``interop.lm_params_to_torch`` and run through both packages
in fp32 on the CPU (the port's kernels take their plain versions there;
the reference's Pallas kernels run in interpret mode).  Tolerance 1e-4:
fp32 products summed in another order by XLA and by PyTorch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import load_config as ref_load_config
from repro.configs import reduced as ref_reduced
from repro.launch.serve import BatchedServer as RefServer
from repro.launch.serve import Request as RefRequest
from repro.models import decode_step as ref_decode_step
from repro.models import init_params as ref_init_params
from repro.models import layers as ref_layers
from repro.models import prefill as ref_prefill
from repro_torch import interop
from repro_torch.configs import LayerSpec, Segment, load_config, reduced
from repro_torch.kernels import _lib
from repro_torch.launch import serve as port_serve
from repro_torch.models import (decode_step, init_cache, init_params, layers,
                                prefill)

TOL = dict(rtol=1e-4, atol=1e-4)
MAX_LEN = 24


@pytest.fixture(autouse=True)
def _port_on_cpu():
    repro_torch.set_device("cpu")
    _lib.reset_counts()
    yield
    repro_torch.set_device(None)


@pytest.fixture(scope="module")
def model():
    """Reduced smollm in both packages with the reference's weights."""
    ref_cfg = ref_reduced(ref_load_config("smollm-135m"))
    cfg = reduced(load_config("smollm-135m"))
    ref_params = ref_init_params(jax.random.PRNGKey(0), ref_cfg)
    params = interop.lm_params_to_torch(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    return ref_cfg, cfg, ref_params, params


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def test_reduced_config_matches_reference(model):
    ref_cfg, cfg, _, _ = model
    ref_fields = dataclasses.asdict(ref_cfg)
    for k, v in dataclasses.asdict(cfg).items():
        assert ref_fields[k] == v, k
    assert cfg.torch_dtype == torch.float32
    assert load_config("smollm-135m").torch_dtype == torch.bfloat16


def test_params_carry_across(model):
    ref_cfg, cfg, ref_params, params = model
    seg = params["segment_0"]
    assert len(seg) == cfg.segments[0].repeats and len(seg[0]) == 1
    np.testing.assert_array_equal(
        seg[1][0]["mixer"]["w_q"].numpy(),
        np.asarray(ref_params["segment_0"][0]["mixer"]["w_q"])[1])
    port_own = init_params(torch.Generator().manual_seed(0), cfg)

    def shapes(tree):
        return interop._tree_map(lambda t: (tuple(t.shape), t.dtype), tree)

    assert shapes(port_own) == shapes(params)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    b = rng.normal(size=(16,)).astype(np.float32)
    xt, xj = _t(x), jnp.asarray(x)
    _close(layers.rmsnorm_apply({"scale": _t(w)}, xt),
           ref_layers.rmsnorm_apply({"scale": jnp.asarray(w)}, xj))
    _close(layers.layernorm_apply({"scale": _t(w), "bias": _t(b)}, xt),
           ref_layers.layernorm_apply({"scale": jnp.asarray(w),
                                       "bias": jnp.asarray(b)}, xj))
    _close(layers.nonparametric_ln_apply(xt),
           ref_layers.nonparametric_ln_apply(xj))
    for kind in ("rmsnorm", "layernorm", "nonparametric_ln"):
        _, apply = layers.make_norm(kind)
        _, ref_apply = ref_layers.make_norm(kind)
        p = {} if kind == "nonparametric_ln" else {"scale": _t(w)}
        rp = {} if kind == "nonparametric_ln" else {"scale": jnp.asarray(w)}
        _close(apply(p, xt), ref_apply(rp, xj))
    pos = rng.integers(0, 100, size=(2, 5))
    _close(layers.rope_freqs(16), ref_layers.rope_freqs(16))
    _close(layers.apply_rope(xt, _t(pos), 1e4),
           ref_layers.apply_rope(xj, jnp.asarray(pos), 1e4))
    mlp = {k: rng.normal(size=s).astype(np.float32) * 0.2 for k, s in
           (("w_up", (16, 32)), ("w_gate", (16, 32)), ("w_down", (32, 16)))}
    for act in ("silu", "gelu"):
        _close(layers.mlp_apply({k: _t(v) for k, v in mlp.items()}, xt, act),
               ref_layers.mlp_apply({k: jnp.asarray(v)
                                     for k, v in mlp.items()}, xj, act))
    table = rng.normal(size=(50, 16)).astype(np.float32)
    tok = rng.integers(0, 50, size=(2, 5))
    _close(layers.embedding_apply({"table": _t(table)}, _t(tok)),
           ref_layers.embedding_apply({"table": jnp.asarray(table)},
                                      jnp.asarray(tok)))
    logits = layers.unembed_apply({"table": _t(table)}, xt)
    assert logits.dtype == torch.float32
    _close(logits, ref_layers.unembed_apply({"table": jnp.asarray(table)},
                                            xj))


# ---------------------------------------------------------------------------
# prefill + decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["full", "chunked", "pallas"])
def test_prefill_and_decode_match_reference(model, impl):
    ref_cfg, cfg, ref_params, params = model
    ref_cfg = dataclasses.replace(ref_cfg, attn_impl=impl)
    cfg = dataclasses.replace(cfg, attn_impl=impl)
    rng = np.random.default_rng(1)
    B, S = 2, 13
    prompts = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)

    ref_logits, ref_cache = ref_prefill(ref_params, jnp.asarray(prompts),
                                        ref_cfg, MAX_LEN)
    logits, cache = prefill(params, _t(prompts), cfg, MAX_LEN)
    _close(logits, ref_logits)
    got_cache = interop.lm_cache_to_numpy(cache)
    want_cache = jax.tree_util.tree_map(np.asarray, ref_cache)
    for key in ("k", "v"):
        np.testing.assert_allclose(got_cache["segment_0"][0]["mixer"][key],
                                   want_cache["segment_0"][0]["mixer"][key],
                                   **TOL)

    tok = np.asarray(ref_logits).argmax(-1).astype(np.int32)
    for step in range(3):
        ref_logits, ref_cache = ref_decode_step(
            ref_params, jnp.asarray(tok), ref_cache,
            jnp.asarray(S + step, jnp.int32), ref_cfg)
        logits, cache = decode_step(params, _t(tok), cache, S + step, cfg)
        _close(logits, ref_logits)
        tok = np.asarray(ref_logits).argmax(-1).astype(np.int32)
    got_cache = interop.lm_cache_to_numpy(cache)
    want_cache = jax.tree_util.tree_map(np.asarray, ref_cache)
    np.testing.assert_allclose(got_cache["segment_0"][0]["mixer"]["v"],
                               want_cache["segment_0"][0]["mixer"]["v"], **TOL)
    assert _lib.counts() == dict.fromkeys(_lib.SIGNATURES, 0)


def test_parallel_block_and_init_cache(model):
    """The parallel-block branch, and decoding from an empty cache."""
    ref_cfg, cfg, ref_params, params = model
    ref_cfg = dataclasses.replace(ref_cfg, parallel_block=True)
    cfg = dataclasses.replace(cfg, parallel_block=True)
    tok = np.array([3, 7], np.int32)
    from repro.models import init_cache as ref_init_cache
    ref_logits, _ = ref_decode_step(ref_params, jnp.asarray(tok),
                                    ref_init_cache(ref_cfg, 2, 8),
                                    jnp.asarray(0, jnp.int32), ref_cfg)
    logits, cache = decode_step(params, _t(tok), init_cache(cfg, 2, 8), 0,
                                cfg)
    _close(logits, ref_logits)
    assert cache["segment_0"][1][0]["mixer"]["k"].shape == (2, 1, 8, 16)


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

def test_server_tokens_identical_to_reference(model):
    ref_cfg, cfg, ref_params, params = model
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=(10,)).astype(np.int32)
               for _ in range(3)]
    gens = [4, 6, 5]
    want = RefServer(ref_cfg, ref_params, max_len=MAX_LEN).serve(
        [RefRequest(i, p, g) for i, (p, g) in enumerate(zip(prompts, gens))])
    for impl in ("full", "pallas"):
        server = port_serve.BatchedServer(
            dataclasses.replace(cfg, attn_impl=impl), params, max_len=MAX_LEN)
        got = server.serve([port_serve.Request(i, p, g) for i, (p, g)
                            in enumerate(zip(prompts, gens))])
        assert [r.tokens for r in got] == [r.tokens for r in want], impl
        assert [len(r.tokens) for r in got] == gens


@pytest.mark.parametrize("greedy", [True, False])
def test_server_takes_the_reference_greedy_flag(model, greedy):
    """The reference's ``BatchedServer(..., greedy=...)`` argmaxes either
    way: both settings serve the same tokens as the reference's server
    with that flag and as the port's server without it."""
    ref_cfg, cfg, ref_params, params = model
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, size=(7,)).astype(np.int32)
               for _ in range(2)]
    want = RefServer(ref_cfg, ref_params, max_len=MAX_LEN,
                     greedy=greedy).serve(
        [RefRequest(i, p, 4) for i, p in enumerate(prompts)])
    reqs = [port_serve.Request(i, p, 4) for i, p in enumerate(prompts)]
    server = port_serve.BatchedServer(cfg, params, max_len=MAX_LEN,
                                      greedy=greedy)
    assert server.greedy is greedy
    got = [r.tokens for r in server.serve(reqs)]
    assert got == [r.tokens for r in want]
    assert got == [r.tokens for r in port_serve.BatchedServer(
        cfg, params, max_len=MAX_LEN).serve(reqs)]


def test_demo_cli_serves_on_the_cpu(capsys):
    port_serve.main(["--arch", "smollm-135m", "--reduced", "--requests", "2",
                     "--prompt-len", "6", "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 2 requests, 6 tokens on cpu" in out


# ---------------------------------------------------------------------------
# what this slice does not carry raises
# ---------------------------------------------------------------------------

def test_unported_features_raise(model, tmp_path):
    """What still waits raises, naming its ROADMAP item: the decode-step
    dataflow report, and training's ``loss_fn`` (with DeepSeek-V3's MTP
    loss) and ``input_specs``.  Every architecture's config loads and
    its layers build (tests/test_torch_models.py holds them to the
    reference)."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.models import input_specs, loss_fn
    _, cfg, _, params = model
    server = port_serve.BatchedServer(cfg, params)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        server.dataflow_report([])
    batch = {"tokens": torch.zeros(1, 5, dtype=torch.long)}
    with pytest.raises(NotImplementedError, match="ROADMAP: \"Training\""):
        loss_fn(params, batch, cfg)
    mtp = reduced(load_config("deepseek-v3-671b"))
    with pytest.raises(NotImplementedError, match="MTP loss"):
        loss_fn({}, batch, mtp)
    with pytest.raises(NotImplementedError, match="ROADMAP: \"Training\""):
        input_specs(cfg, "train_4k")
    assert [load_config(a).name for a in ARCH_IDS] == ARCH_IDS
    mtp_params = init_params(torch.Generator().manual_seed(0), mtp)
    assert set(mtp_params["mtp"]) == {"proj", "layer", "norm"}
    # the daemon's control commands are ported: with no daemon at the
    # socket, ``stats`` and ``shutdown`` report it and exit 1
    absent = str(tmp_path / "absent.sock")
    for sub in ("stats", "shutdown"):
        with pytest.raises(SystemExit) as stop:
            port_serve.main([sub, "--socket", absent])
        assert stop.value.code == 1
    if not torch.cuda.is_available():     # a daemon on the card needs one
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port_serve.main(["daemon", "--socket", absent,
                             "--device", "cuda"])
