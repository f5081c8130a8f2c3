"""The port's model stack (repro_torch.models, configs, interop and the
server) against the JAX reference on all ten architectures.

The reference's parameters are drawn from its own init on each
architecture's ``reduced`` config, carried across with
``interop.lm_params_to_torch`` and run through both packages in fp32 on
the CPU.  Tolerance 1e-4 (``tests/test_torch_serve.py``'s): fp32
products summed in another order by XLA and by PyTorch.  Integer
results (routing, int8 codes, greedy tokens) must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import ARCH_IDS as REF_ARCH_IDS
from repro.configs import load_config as ref_load_config
from repro.configs import reduced as ref_reduced
from repro.launch.serve import BatchedServer as RefServer
from repro.launch.serve import Request as RefRequest
from repro.models import attention as ref_attention
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_transformer
from repro.models import decode_step as _ref_decode_step
from repro.models import forward as _ref_forward
from repro.models import init_params as ref_init_params
from repro.models import prefill as _ref_prefill
from repro_torch import interop
from repro_torch.configs import (ARCH_IDS, SHAPES, cell_is_applicable,
                                 load_config, reduced)
from repro_torch.kernels import _lib
from repro_torch.launch import serve as port_serve
from repro_torch.models import (attention, decode_step, forward, init_params,
                                moe, prefill, ssm, transformer)

TOL = dict(rtol=1e-4, atol=1e-4)
MAX_LEN = 16
B, S = 2, 8

# the reference's entry points jitted once per config: called eagerly,
# each call would trace and compile its layer scans anew
ref_forward = jax.jit(_ref_forward, static_argnums=2)
ref_prefill = jax.jit(_ref_prefill, static_argnums=(2, 3))
ref_decode_step = jax.jit(_ref_decode_step, static_argnums=4)
ref_moe_apply = jax.jit(ref_moe.moe_apply, static_argnums=2)
ref_mamba_apply = jax.jit(ref_ssm.mamba_apply, static_argnums=(2, 3))
ref_mamba_decode = jax.jit(ref_ssm.mamba_decode, static_argnums=3)
ref_rwkv6_apply = jax.jit(ref_ssm.rwkv6_apply, static_argnums=(2, 3))
ref_rwkv6_decode = jax.jit(ref_ssm.rwkv6_decode, static_argnums=3)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    repro_torch.set_device("cpu")
    _lib.reset_counts()
    yield
    repro_torch.set_device(None)


_MODELS: dict = {}


def model(arch: str):
    """Reduced ``arch`` in both packages with the reference's weights
    (built once per architecture)."""
    if arch not in _MODELS:
        ref_cfg = ref_reduced(ref_load_config(arch))
        cfg = reduced(load_config(arch))
        ref_params = ref_init_params(jax.random.PRNGKey(0), ref_cfg)
        params = interop.lm_params_to_torch(
            jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
        _MODELS[arch] = (ref_cfg, cfg, ref_params, params)
    return _MODELS[arch]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **(tol or TOL))


def _tokens(cfg, seed: int, n: int = S) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(B, n)).astype(np.int32)


def _trees_close(got, want, path=""):
    """Every leaf of the port's cache (stacked by ``lm_cache_to_numpy``)
    against the reference's: same keys, integer leaves identical,
    floating leaves within TOL."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _trees_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _trees_close(g, w, f"{path}/{i}")
    else:
        w = np.asarray(want)
        if w.dtype.name == "bfloat16":
            w = w.astype(np.float32)
        assert got.shape == w.shape, path
        if np.issubdtype(w.dtype, np.integer):
            assert got.dtype == w.dtype, path
            np.testing.assert_array_equal(got, w, err_msg=path)
        else:
            np.testing.assert_allclose(got, w.astype(np.float32), **TOL,
                                       err_msg=path)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_arch_ids_are_the_reference():
    assert ARCH_IDS == REF_ARCH_IDS
    assert set(SHAPES) == {"train_4k", "prefill_32k", "decode_32k",
                           "long_500k"}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_and_param_counts_match_reference(arch):
    """The full and reduced configs equal the reference's field for
    field, with the same param counts, ``subquadratic`` and applicable
    cells."""
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import cell_is_applicable as ref_applicable
    for ref_cfg, cfg in ((ref_load_config(arch), load_config(arch)),
                         (ref_reduced(ref_load_config(arch)),
                          reduced(load_config(arch)))):
        ref_fields = dataclasses.asdict(ref_cfg)
        for k, v in dataclasses.asdict(cfg).items():
            assert ref_fields[k] == v, k
        assert cfg.param_count() == ref_cfg.param_count()
        assert cfg.active_param_count() == ref_cfg.active_param_count()
        assert cfg.subquadratic == ref_cfg.subquadratic
        for name in SHAPES:
            assert cell_is_applicable(cfg, SHAPES[name]) == \
                ref_applicable(ref_cfg, REF_SHAPES[name])
    assert load_config(arch).torch_dtype == torch.bfloat16


def test_port_init_builds_the_reference_tree():
    """The port's own init gives the reference's tree, shapes and dtypes
    (the MTP head included) on every architecture."""
    for arch in ARCH_IDS:
        ref_cfg, cfg, _, params = model(arch)
        own = init_params(torch.Generator().manual_seed(0), cfg)

        def sig(tree):
            return interop._tree_map(lambda t: (tuple(t.shape), t.dtype),
                                     tree)

        assert sig(own) == sig(params), arch
    assert "mtp" in model("deepseek-v3-671b")[3]


# ---------------------------------------------------------------------------
# whole models against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_matches_reference(arch):
    """Logits and the summed load-balance aux of ``forward``."""
    ref_cfg, cfg, ref_params, params = model(arch)
    tokens = _tokens(cfg, 1)
    want, ref_aux = ref_forward(ref_params, jnp.asarray(tokens), ref_cfg)
    got, aux = forward(params, _t(tokens), cfg)
    _close(got, want)
    _close(aux["lb_loss"], ref_aux["lb_loss"])
    if cfg.moe is not None:
        assert float(aux["lb_loss"]) > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill logits and cache, then four decode steps' logits and the
    final cache."""
    ref_cfg, cfg, ref_params, params = model(arch)
    tokens = _tokens(cfg, 2)
    ref_logits, ref_cache = ref_prefill(ref_params, jnp.asarray(tokens),
                                        ref_cfg, MAX_LEN)
    logits, cache = prefill(params, _t(tokens), cfg, MAX_LEN)
    _close(logits, ref_logits)
    _trees_close(interop.lm_cache_to_numpy(cache),
                 jax.tree_util.tree_map(np.asarray, ref_cache))
    tok = np.asarray(ref_logits).argmax(-1).astype(np.int32)
    for step in range(4):
        ref_logits, ref_cache = ref_decode_step(
            ref_params, jnp.asarray(tok), ref_cache,
            jnp.asarray(S + step, jnp.int32), ref_cfg)
        logits, cache = decode_step(params, _t(tok), cache, S + step, cfg)
        _close(logits, ref_logits)
        tok = np.asarray(ref_logits).argmax(-1).astype(np.int32)
    _trees_close(interop.lm_cache_to_numpy(cache),
                 jax.tree_util.tree_map(np.asarray, ref_cache))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_server_tokens_identical_to_reference(arch):
    ref_cfg, cfg, ref_params, params = model(arch)
    rng = np.random.default_rng(3)
    # prompts of two lengths: the server pads the shorter on the right,
    # and a recurrent mixer's state carries the padding, in both packages
    prompts = [rng.integers(0, cfg.vocab_size, size=(n,)).astype(np.int32)
               for n in (6, 4)]
    gens = [3, 4]
    want = RefServer(ref_cfg, ref_params, max_len=MAX_LEN).serve(
        [RefRequest(i, p, g) for i, (p, g) in enumerate(zip(prompts, gens))])
    got = port_serve.BatchedServer(cfg, params, max_len=MAX_LEN).serve(
        [port_serve.Request(i, p, g)
         for i, (p, g) in enumerate(zip(prompts, gens))])
    assert [r.tokens for r in got] == [r.tokens for r in want]


@pytest.mark.parametrize("arch", ["musicgen-large", "chameleon-34b"])
def test_frontend_stub_takes_embeddings(arch):
    """Audio / vision front ends: 3-D inputs are embeddings, through
    ``forward`` and ``prefill``."""
    ref_cfg, cfg, ref_params, params = model(arch)
    assert cfg.frontend_stub
    emb = np.random.default_rng(4).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)
    want, _ = ref_forward(ref_params, jnp.asarray(emb), ref_cfg)
    got, _ = forward(params, _t(emb), cfg)
    _close(got, want)
    ref_logits, ref_cache = ref_prefill(ref_params, jnp.asarray(emb),
                                        ref_cfg, MAX_LEN)
    logits, cache = prefill(params, _t(emb), cfg, MAX_LEN)
    _close(logits, ref_logits)
    _trees_close(interop.lm_cache_to_numpy(cache),
                 jax.tree_util.tree_map(np.asarray, ref_cache))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_case(arch, seed, **moe_changes):
    ref_cfg, cfg, ref_params, params = model(arch)
    ref_cfg = dataclasses.replace(
        ref_cfg, moe=dataclasses.replace(ref_cfg.moe, **moe_changes))
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, **moe_changes))
    seg = next(i for i, s in enumerate(cfg.segments)
               if any(sp.mlp == "moe" for sp in s.unit))
    j = next(j for j, sp in enumerate(cfg.segments[seg].unit)
             if sp.mlp == "moe")
    p = params[f"segment_{seg}"][0][j]["mlp"]
    rp = jax.tree_util.tree_map(lambda a: a[0],
                                ref_params[f"segment_{seg}"][j]["mlp"])
    x = np.random.default_rng(seed).normal(
        size=(2, 8, cfg.d_model)).astype(np.float32)
    return ref_cfg, cfg, rp, p, x


def _ref_routing(rp, x, cfg):
    """The reference's routing of ``x``: top_ids, keep, slots, capacity."""
    m = cfg.moe
    T = x.shape[0] * x.shape[1]
    E, k = m.num_experts, m.top_k
    logits = jnp.asarray(x).reshape(T, -1) @ rp["router"]
    scores = jax.nn.sigmoid(logits) if m.router_fn == "sigmoid" else \
        jax.nn.softmax(logits, -1)
    if m.route_groups > 1 and m.route_device_limit > 0:
        G = m.route_groups
        gs = scores.reshape(T, G, E // G).max(-1)
        _, top_g = jax.lax.top_k(gs, m.route_device_limit)
        gmask = jax.nn.one_hot(top_g, G, dtype=scores.dtype).sum(1)
        scores = (scores.reshape(T, G, E // G) * gmask[..., None]
                  ).reshape(T, E)
    top_w, top_ids = jax.lax.top_k(scores, k)
    cap = int(np.ceil(k * T / E * m.capacity_factor))
    onehot = jax.nn.one_hot(top_ids, E, dtype=jnp.int32).reshape(T * k, E)
    pos = ((jnp.cumsum(onehot, 0) - onehot) * onehot).sum(-1).reshape(T, k)
    return (np.asarray(top_ids), np.asarray(pos < cap),
            np.asarray(top_ids * cap + pos), cap)


@pytest.mark.parametrize("case", ["drops", "groups", "int8", "sigmoid"])
def test_moe_matches_reference(case):
    """Capacity drops (slots past E·cap), device-limited routing with
    ties at 0, int8 dispatch and the sigmoid router with a shared
    expert: outputs and aux within TOL, the same routing."""
    arch, changes = {
        "drops": ("llama4-scout-17b-a16e", dict(capacity_factor=0.5)),
        "groups": ("jamba-1.5-large-398b",
                   dict(route_groups=2, route_device_limit=1)),
        "int8": ("jamba-1.5-large-398b", dict(dispatch_dtype="int8",
                                              capacity_factor=0.75)),
        "sigmoid": ("deepseek-v3-671b", dict(capacity_factor=0.5)),
    }[case]
    ref_cfg, cfg, rp, p, x = _moe_case(arch, 5, **changes)
    want, ref_aux = ref_moe_apply(rp, jnp.asarray(x), ref_cfg)
    got, aux = moe.moe_apply(p, _t(x), cfg)
    _close(got, want)
    for key in ("lb_loss", "dropped_frac"):
        _close(aux[key], ref_aux[key])
    top_ids, keep, slot, cap = _ref_routing(rp, x, ref_cfg)
    m = cfg.moe
    if m.route_groups > 1:
        # each token's experts lie in its one kept group
        groups = top_ids // (m.num_experts // m.route_groups)
        assert (groups == groups[:, :1]).all()
    assert float(aux["dropped_frac"]) == pytest.approx(1.0 - keep.mean())
    if case != "groups":
        assert not keep.all()
    if case == "drops":
        assert (slot >= m.num_experts * cap).any()


def test_moe_top_k_prefers_the_lower_index_on_ties():
    """``moe._top_k`` orders ties as ``jax.lax.top_k`` does."""
    x = np.array([[0.0, 0.5, 0.0, 0.5, 0.0, 0.0, 0.25, 0.0],
                  [0.0] * 8, [1.0, 1.0, 1.0, 0.0, 0.0, 1.0, 0.0, 1.0]],
                 np.float32)
    for k in (1, 2, 3, 5):
        v, i = moe._top_k(_t(x), k)
        rv, ri = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(v.numpy(), np.asarray(rv))


def test_moe_decode_drops_with_capacity_one():
    """Decode of two sequences, top-1 of 4 experts: cap = 1, so two
    tokens routed to one expert drop one of them, as in the reference."""
    ref_cfg, cfg, rp, p, _ = _moe_case("llama4-scout-17b-a16e", 0)
    rng = np.random.default_rng(6)
    for _ in range(20):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        want, ref_aux = ref_moe_apply(rp, jnp.asarray(x), ref_cfg)
        got, aux = moe.moe_apply(p, _t(x), cfg)
        _close(got, want)
        _close(aux["dropped_frac"], ref_aux["dropped_frac"])
        if float(ref_aux["dropped_frac"]) > 0:
            return
    pytest.fail("no draw routed both tokens to one expert")


# ---------------------------------------------------------------------------
# attention: the int8 cache and MLA
# ---------------------------------------------------------------------------

def test_int8_kv_cache_codes_and_scales_are_the_reference():
    """Prefill and decode of an int8 cache: codes and f16 scales bit for
    bit the reference's, logits within TOL of the reference's int8
    path."""
    ref_cfg, cfg, ref_params, params = model("qwen2.5-14b")
    ref_cfg = dataclasses.replace(ref_cfg, kv_cache_dtype="int8")
    cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    tokens = _tokens(cfg, 7)
    ref_logits, ref_cache = ref_prefill(ref_params, jnp.asarray(tokens),
                                        ref_cfg, MAX_LEN)
    logits, cache = prefill(params, _t(tokens), cfg, MAX_LEN)
    _close(logits, ref_logits)

    def exact(got_cache, want_cache):
        got = interop.lm_cache_to_numpy(got_cache)["segment_0"][0]["mixer"]
        want = want_cache["segment_0"][0]["mixer"]
        for key, dt in (("k", np.int8), ("v", np.int8),
                        ("k_scale", np.float16), ("v_scale", np.float16)):
            assert got[key].dtype == dt, key
            np.testing.assert_array_equal(got[key], np.asarray(want[key]),
                                          err_msg=key)

    exact(cache, ref_cache)
    tok = np.asarray(ref_logits).argmax(-1).astype(np.int32)
    for step in range(3):
        ref_logits, ref_cache = ref_decode_step(
            ref_params, jnp.asarray(tok), ref_cache,
            jnp.asarray(S + step, jnp.int32), ref_cfg)
        logits, cache = decode_step(params, _t(tok), cache, S + step, cfg)
        _close(logits, ref_logits)
        tok = np.asarray(ref_logits).argmax(-1).astype(np.int32)
    exact(cache, ref_cache)
    # the quantizer alone, on halves and ties
    x = np.array([[[[0.5, -1.5, 2.5, 127.0, -127.0, 63.5, 0.0, 1e-9]]]],
                 np.float32)
    q, s = attention._kv_quantize(_t(x))
    rq, rs = ref_attention._kv_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    zero = np.zeros((1, 1, 1, 8), np.float32)
    assert attention._kv_quantize(_t(zero))[1].item() == \
        np.asarray(ref_attention._kv_quantize(jnp.asarray(zero))[1]).item() \
        == 0.0


def test_mla_absorbed_and_naive_match_the_reference():
    """Absorbed and naive MLA decode, each against the reference's, and
    against each other at the reference's 2e-3."""
    ref_cfg, cfg, ref_params, params = model("deepseek-v3-671b")
    tokens = _tokens(cfg, 8)
    # the prefill does not depend on the decode's form
    _, ref_cache0 = ref_prefill(ref_params, jnp.asarray(tokens), ref_cfg,
                                MAX_LEN)
    _, cache0 = prefill(params, _t(tokens), cfg, MAX_LEN)
    out = {}
    for absorbed in (False, True):
        rc = dataclasses.replace(ref_cfg, mla_absorbed=absorbed)
        c = dataclasses.replace(cfg, mla_absorbed=absorbed)
        ref_cache = ref_cache0
        cache = interop._tree_map(torch.clone, cache0)  # updated in place
        tok = tokens[:, -1]
        for step in range(2):
            want, ref_cache = ref_decode_step(
                ref_params, jnp.asarray(tok), ref_cache,
                jnp.asarray(S + step, jnp.int32), rc)
            got, cache = decode_step(params, _t(tok), cache, S + step, c)
            _close(got, want)
            tok = np.asarray(want).argmax(-1).astype(np.int32)
        out[absorbed] = got
    _close(out[True], out[False].numpy(), rtol=2e-3, atol=2e-3)
    # the module alone, absorbed vs naive, against the reference's
    lp = params["segment_1"][0][0]["mixer"]
    rlp = jax.tree_util.tree_map(lambda a: a[0],
                                 ref_params["segment_1"][0]["mixer"])
    x = np.random.default_rng(9).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)
    _close(attention.mla_apply(lp, _t(x), cfg),
           ref_attention.mla_apply(rlp, jnp.asarray(x), ref_cfg))


@pytest.mark.parametrize("case", ["int8", "mla-naive", "mla-absorbed"])
def test_decoding_past_max_len_matches_reference(case):
    """Past ``max_len`` the reference's cache writes clamp to the last
    slot (``dynamic_update_slice``) while positions keep counting: the
    int8 cache (Qwen2.5, codes and f16 scales bit for bit) and the MLA
    latent cache (DeepSeek-V3, naive and absorbed decode) give the
    reference's logits (TOL) and greedy tokens (exact) at every step,
    and its caches at the end."""
    arch = "qwen2.5-14b" if case == "int8" else "deepseek-v3-671b"
    ref_cfg, cfg, ref_params, params = model(arch)
    change = ({"kv_cache_dtype": "int8"} if case == "int8" else
              {"mla_absorbed": case == "mla-absorbed"})
    ref_cfg = dataclasses.replace(ref_cfg, **change)
    cfg = dataclasses.replace(cfg, **change)
    tokens = _tokens(cfg, 11)
    max_len = S + 2
    ref_logits, ref_cache = ref_prefill(ref_params, jnp.asarray(tokens),
                                        ref_cfg, max_len)
    logits, cache = prefill(params, _t(tokens), cfg, max_len)
    for step in range(5):            # lengths S..S+4 against S+2 slots
        tok = np.asarray(ref_logits).argmax(-1).astype(np.int32)
        assert np.array_equal(logits.argmax(-1).numpy(), tok)
        ref_logits, ref_cache = ref_decode_step(
            ref_params, jnp.asarray(tok), ref_cache,
            jnp.asarray(S + step, jnp.int32), ref_cfg)
        logits, cache = decode_step(params, _t(tok), cache, S + step, cfg)
        _close(logits, ref_logits)
    _trees_close(interop.lm_cache_to_numpy(cache),
                 jax.tree_util.tree_map(np.asarray, ref_cache))


# ---------------------------------------------------------------------------
# SSM: Mamba and RWKV-6
# ---------------------------------------------------------------------------

def _mixer(arch, kind):
    ref_cfg, cfg, ref_params, params = model(arch)
    seg = cfg.segments[0]
    j = next(j for j, sp in enumerate(seg.unit) if sp.mixer == kind)
    p = params["segment_0"][0][j]
    rp = jax.tree_util.tree_map(lambda a: a[0], ref_params["segment_0"][j])
    return ref_cfg, cfg, rp, p


@pytest.mark.parametrize("scan", ["sequential", "chunked"])
def test_mamba_matches_reference(scan):
    """``mamba_apply`` (both scans) with its cache, then decode steps,
    against the reference; the chunked scan equals the sequential."""
    ref_cfg, cfg, rp, p = _mixer("jamba-1.5-large-398b", "mamba")
    ref_cfg = dataclasses.replace(
        ref_cfg, ssm=dataclasses.replace(ref_cfg.ssm, scan_impl=scan,
                                         chunk=4))
    cfg = dataclasses.replace(
        cfg, ssm=dataclasses.replace(cfg.ssm, scan_impl=scan, chunk=4))
    x = np.random.default_rng(10).normal(
        size=(B, 12, cfg.d_model)).astype(np.float32)
    want, rcache = ref_mamba_apply(rp["mixer"], jnp.asarray(x), ref_cfg,
                                   True)
    got, cache = ssm.mamba_apply(p["mixer"], _t(x), cfg, return_cache=True)
    _close(got, want)
    _close(cache["h"], rcache["h"])
    _close(cache["conv"], rcache["conv"])
    seq = dataclasses.replace(
        cfg, ssm=dataclasses.replace(cfg.ssm, scan_impl="sequential"))
    _close(got, ssm.mamba_apply(p["mixer"], _t(x), seq).numpy())
    step = np.random.default_rng(11).normal(
        size=(B, 1, cfg.d_model)).astype(np.float32)
    for _ in range(2):
        want, rcache = ref_mamba_decode(rp["mixer"], jnp.asarray(step),
                                        rcache, ref_cfg)
        got, cache = ssm.mamba_decode(p["mixer"], _t(step), cache, cfg)
        _close(got, want)
        step = np.asarray(want)
    _close(cache["h"], rcache["h"])


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-1.5-large-398b"])
def test_empty_sequence_matches_reference(arch):
    """A recurrence over no tokens: the reduced RWKV-6's ``forward`` on
    (1, 0) tokens gives (1, 0, vocab) logits, and a reduced Jamba Mamba
    layer's ``mamba_apply`` on (2, 0, d) gives (2, 0, d), both the
    reference's (``cdfg.scan`` stacks each ``y`` to length 0)."""
    if arch == "rwkv6-1.6b":
        ref_cfg, cfg, ref_params, params = model(arch)
        tok = np.zeros((1, 0), np.int32)
        want, _ = ref_forward(ref_params, jnp.asarray(tok), ref_cfg)
        got, _ = forward(params, _t(tok), cfg)
    else:
        ref_cfg, cfg, rp, p = _mixer(arch, "mamba")
        x = np.zeros((2, 0, cfg.d_model), np.float32)
        want = ref_mamba_apply(rp["mixer"], jnp.asarray(x), ref_cfg, False)
        got = ssm.mamba_apply(p["mixer"], _t(x), cfg)
    assert tuple(got.shape) == want.shape == (
        (1, 0, cfg.vocab_size) if arch == "rwkv6-1.6b" else (2, 0, cfg.d_model))
    _close(got, want)


def test_rwkv6_and_channel_mix_match_reference():
    """RWKV-6 with its cache and decode, and the channel mix with a
    carried ``prev``."""
    ref_cfg, cfg, rp, p = _mixer("rwkv6-1.6b", "rwkv")
    x = np.random.default_rng(12).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)
    want, rcache = ref_rwkv6_apply(rp["mixer"], jnp.asarray(x), ref_cfg,
                                   True)
    got, cache = ssm.rwkv6_apply(p["mixer"], _t(x), cfg, return_cache=True)
    _close(got, want)
    _close(cache["S"], rcache["S"])
    _close(cache["x_prev"], rcache["x_prev"])
    step = np.random.default_rng(13).normal(
        size=(B, 1, cfg.d_model)).astype(np.float32)
    want, rcache = ref_rwkv6_decode(rp["mixer"], jnp.asarray(step),
                                    rcache, ref_cfg)
    got, cache = ssm.rwkv6_decode(p["mixer"], _t(step), cache, cfg)
    _close(got, want)
    _close(cache["S"], rcache["S"])
    prev = np.random.default_rng(14).normal(
        size=(B, 1, cfg.d_model)).astype(np.float32)
    for pv in (None, prev):
        _close(transformer._cmix_apply(p["mlp"], _t(x),
                                       None if pv is None else _t(pv)),
               ref_transformer._cmix_apply(
                   rp["mlp"], jnp.asarray(x),
                   None if pv is None else jnp.asarray(pv)))


def test_prefill_then_decode_equals_forward_on_ssm_archs():
    """The serving split on the recurrent archs: prefill the first S
    tokens, decode the next two; the logits equal ``forward`` over the
    S + 2 tokens at those positions (the port alone, fp32, at the
    reference's ``test_prefill_then_decode_matches_forward`` 2e-3, with
    its capacity factor 8 so that no MoE drop depends on the batch)."""
    for arch in ("rwkv6-1.6b", "jamba-1.5-large-398b"):
        _, cfg, _, params = model(arch)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=8.0))
        tokens = _tokens(cfg, 15, S + 2)
        full, _ = forward(params, _t(tokens), cfg)
        logits, cache = prefill(params, _t(tokens[:, :S]), cfg, MAX_LEN)
        _close(logits, full[:, S - 1].numpy(), rtol=2e-3, atol=2e-3)
        for i in range(2):
            logits, cache = decode_step(params, _t(tokens[:, S + i]), cache,
                                        S + i, cfg)
            _close(logits, full[:, S + i].numpy(), rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------------------------
# on the card: chip_smoke.py's phases 6c-6f at a reduced depth
# ---------------------------------------------------------------------------

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    return torch.device("cuda")


def _cut(cfg, layers: int = 2):
    """``cfg`` at full width with its first segment cut to ``layers``."""
    from repro_torch.configs import Segment
    seg = cfg.segments[0]
    return dataclasses.replace(cfg, num_layers=layers * len(seg.unit),
                               segments=(Segment(seg.unit, layers),))


@pytest.mark.cuda
def test_qwen_serves_on_the_card():
    """6c at two layers, full width: fp32 kernels == plain tokens, the bf16
    logits bar, every launch on its design, and the int8 cache within the
    reference's int8 tolerance of the bf16 cache."""
    dev = _needs_card()
    from repro_torch.kernels.flash_attention import (decode_design,
                                                    decode_split)
    cfg = _cut(load_config("qwen2.5-14b"))
    tokens = torch.from_numpy(_tokens(cfg, 20, 64)).to(dev)
    reqs = [port_serve.Request(i, tokens[i].cpu().numpy(), 4)
            for i in range(B)]

    def served(c, params, impl):
        c = dataclasses.replace(c, attn_impl=impl)
        with torch.inference_mode():
            logits, _ = prefill(params, tokens, c, 72)
        _lib.reset_counts()
        res = port_serve.BatchedServer(c, params, max_len=72).serve(reqs)
        return (logits.float(), [r.tokens for r in res], _lib.counts(),
                _lib.routes())

    c32 = dataclasses.replace(cfg, dtype="float32")
    p32 = init_params(torch.Generator(device=dev).manual_seed(0), c32, dev)
    lp, tp, *_ = served(c32, p32, "pallas")
    lf, tf, *_ = served(c32, p32, "full")
    torch.testing.assert_close(lp, lf, rtol=1e-3, atol=1e-3)
    assert tp == tf
    del p32
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         dev)
    bf, _, *_ = served(cfg, params, "full")
    bp, _, n, routes = served(cfg, params, "pallas")
    err = float((bp - bf).abs().max())
    assert err <= max(2e-2 * float(bf.abs().max()),
                      float((bf - lf).abs().max()))
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    split = decode_design(decode_split(B, cfg.num_kv_heads, 72, sms))
    assert routes["flash_attention"] == {"mma.sync": 2}
    assert routes["decode_attention"] == {split: 2 * 4}
    cp = dataclasses.replace(cfg, attn_impl="pallas")
    c8 = dataclasses.replace(cp, kv_cache_dtype="int8")
    with torch.inference_mode():
        logits, cache = prefill(params, tokens, cp, 72)
        tok = logits.argmax(-1)
        base, _ = decode_step(params, tok, cache, 64, cp)
        _, cache = prefill(params, tokens, c8, 72)
        assert cache["segment_0"][0][0]["mixer"]["k_scale"].dtype == \
            torch.float16
        quant, _ = decode_step(params, tok, cache, 64, c8)
    dp = (torch.softmax(base.float(), -1)
          - torch.softmax(quant.float(), -1)).abs().max()
    assert float(dp) < 0.05
    assert torch.equal(base.argmax(-1), quant.argmax(-1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_attention_kernels_at_qwen_heads_on_the_card(dtype, tol):
    """40 query heads over 8 kv heads of dim 128 (a group of 5: the
    decode kernel's eight-heads-at-a-time route with three heads idle)
    against the plain versions."""
    dev = _needs_card()
    from repro_torch.kernels import ops, ref
    g = torch.Generator(device=dev).manual_seed(21)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    q, k, v = randn(2, 40, 96, 128), randn(2, 8, 96, 128), \
        randn(2, 8, 96, 128)
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, causal=True),
        ref.flash_attention_ref(q, k, v, causal=True), rtol=tol, atol=tol)
    qd, kc, vc = randn(3, 40, 128), randn(3, 8, 552, 128), \
        randn(3, 8, 552, 128)
    lengths = torch.tensor([1, 513, 552], dtype=torch.int32, device=dev)
    torch.testing.assert_close(
        ops.decode_attention(qd, kc, vc, lengths),
        ref.decode_attention_ref(qd, kc, vc, lengths), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_deepseek_routing_and_mla_on_the_card():
    """6d on the reduced config: absorbed and naive MLA decode agree
    (tokens, and logits at the reference's 2e-3), and the card's top-k
    routing is the host's."""
    dev = _needs_card()
    cfg = reduced(load_config("deepseek-v3-671b"))
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         dev)
    tokens = torch.from_numpy(_tokens(cfg, 22)).to(dev)
    outs = {}
    for absorbed in (False, True):
        c = dataclasses.replace(cfg, mla_absorbed=absorbed)
        with torch.inference_mode():
            logits, cache = prefill(params, tokens, c, MAX_LEN)
            seq, steps = logits.argmax(-1), []
            for i in range(4):
                logits, cache = decode_step(params, seq, cache, S + i, c)
                steps.append(logits)
                seq = logits.argmax(-1)
        outs[absorbed] = torch.stack(steps)
    torch.testing.assert_close(outs[True], outs[False], rtol=2e-3, atol=2e-3)
    assert torch.equal(outs[True].argmax(-1), outs[False].argmax(-1))
    scores = torch.rand((64, 256), generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    scores[:, ::3] = 0.0                      # ties, as group masking makes
    assert torch.equal(moe._top_k(scores, 8)[1].cpu(),
                       moe._top_k(scores.cpu(), 8)[1])


@pytest.mark.cuda
def test_rwkv_prefill_then_decode_equals_forward_on_the_card():
    """6e at two layers, full width, fp32 (the reference's 2e-3)."""
    dev = _needs_card()
    cfg = dataclasses.replace(_cut(load_config("rwkv6-1.6b")),
                              dtype="float32")
    params = init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                         dev)
    tokens = torch.from_numpy(_tokens(cfg, 23, 40)).to(dev)
    with torch.inference_mode():
        full, _ = forward(params, tokens, cfg)
        logits, cache = prefill(params, tokens[:, :32], cfg, 48)
        torch.testing.assert_close(logits, full[:, 31], rtol=2e-3,
                                   atol=2e-3)
        for i in range(8):
            logits, cache = decode_step(params, tokens[:, 32 + i], cache,
                                        32 + i, cfg)
            torch.testing.assert_close(logits, full[:, 32 + i], rtol=2e-3,
                                       atol=2e-3)


@pytest.mark.cuda
def test_mamba_layer_at_full_width_on_the_card():
    """6f at batch 2 and 64 + 8 tokens: apply then decode == apply over
    the whole, chunked == sequential (fp32, 1e-3)."""
    dev = _needs_card()
    cfg = dataclasses.replace(load_config("jamba-1.5-large-398b"),
                              dtype="float32")
    seq = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, scan_impl="sequential"))
    chunked = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, scan_impl="chunked"))
    g = torch.Generator(device=dev).manual_seed(0)
    p = ssm.mamba_init(g, cfg, dev)
    x = torch.randn((2, 80, cfg.d_model), generator=g, device=dev)
    with torch.inference_mode():
        whole = ssm.mamba_apply(p, x, seq)
        torch.testing.assert_close(ssm.mamba_apply(p, x, chunked), whole,
                                   rtol=1e-3, atol=1e-3)
        _, cache = ssm.mamba_apply(p, x[:, :64], seq, return_cache=True)
        for i in range(64, 80):
            y, cache = ssm.mamba_decode(p, x[:, i:i + 1], cache, seq)
            torch.testing.assert_close(y, whole[:, i:i + 1], rtol=1e-3,
                                       atol=1e-3)
