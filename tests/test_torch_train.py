"""The port's training path (``models.loss_fn``, ``optim``,
``launch.steps``) against the JAX reference on all ten architectures.

The reference's parameters are drawn from its own init on each
architecture's ``reduced`` config and carried across with
``interop.lm_params_to_torch``; the batch is the reference's
``synthetic_stream`` (embeddings from a seeded numpy draw where the
config takes them).  Both packages run in fp32 on the CPU, the
reference's loss, grads and AdamW step ``jax.jit``-ted with the config
static.  Grads, moments and params come back to the reference's layout
through ``interop.lm_params_to_numpy`` and compare leaf by leaf, by
name.  Tolerances are stated where used; the floating ones are fp32
sums in another order by XLA and by PyTorch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import load_config as ref_load_config
from repro.configs import reduced as ref_reduced
from repro.data import DataConfig as RefDataConfig
from repro.data import synthetic_stream as ref_synthetic_stream
from repro.launch import steps as ref_steps
from repro.models import init_params as _ref_init_params
from repro.models import input_specs as ref_input_specs
from repro.models import loss_fn as ref_loss_fn
from repro.optim import adamw as ref_adamw
from repro_torch import interop, tree
from repro_torch.configs import ARCH_IDS, load_config, reduced
from repro_torch.kernels import _lib, ops
from repro_torch.kernels.decoupled_gather import decoupled_gather
from repro_torch.launch import steps
from repro_torch.models import input_specs, loss_fn
from repro_torch.optim import adamw

B, S = 2, 16

ref_init_params = jax.jit(_ref_init_params, static_argnums=1)
ref_value_and_grad = jax.jit(jax.value_and_grad(ref_loss_fn, has_aux=True),
                             static_argnums=2)
ref_apply_updates = jax.jit(ref_adamw.apply_updates, static_argnums=3)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    repro_torch.set_device("cpu")
    _lib.reset_counts()
    yield
    repro_torch.set_device(None)


def _batch(cfg, seed: int = 1) -> dict:
    """The reference stream's batch (and seeded embeddings where the
    config takes embeddings), as numpy."""
    tokens = next(ref_synthetic_stream(RefDataConfig(
        batch_size=B, seq_len=S, vocab_size=cfg.vocab_size,
        seed=seed)))["tokens"]
    if cfg.frontend_stub:
        rng = np.random.default_rng(seed)
        return {"embeds": rng.normal(size=(B, S, cfg.d_model))
                .astype(np.float32), "labels": tokens[:, 1:]}
    return {"tokens": tokens}


def _to_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


_CASES: dict = {}


def case(arch: str) -> dict:
    """Reduced ``arch`` in both packages with the reference's weights and
    batch, the reference's loss, grads and two AdamW steps (the second
    from the first's non-zero moments), and the port's loss and grads —
    built once per architecture."""
    if arch not in _CASES:
        ref_cfg = ref_reduced(ref_load_config(arch))
        cfg = reduced(load_config(arch))
        ref_params = ref_init_params(jax.random.PRNGKey(0), ref_cfg)
        batch = _batch(cfg)
        (ref_loss, ref_metrics), ref_grads = ref_value_and_grad(
            ref_params, {k: jnp.asarray(v) for k, v in batch.items()},
            ref_cfg)
        opt_cfg = ref_adamw.AdamWConfig()
        p1, s1, _ = ref_apply_updates(
            ref_params, ref_grads, ref_adamw.init_opt_state(ref_params,
                                                            opt_cfg),
            opt_cfg)
        p2, s2, info2 = ref_apply_updates(p1, ref_grads, s1, opt_cfg)
        to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
        params = interop.lm_params_to_torch(to_np(ref_params), cfg, "cpu")
        (loss, metrics), grads = steps.loss_and_grads(
            params, _to_torch(batch), cfg)
        _CASES[arch] = dict(
            ref_cfg=ref_cfg, cfg=cfg, params=params, batch=batch,
            ref_loss=float(ref_loss),
            ref_metrics={k: float(v) for k, v in ref_metrics.items()},
            ref_grads=to_np(ref_grads), step1=(to_np(p1), to_np(s1)),
            step2=(to_np(p2), to_np(s2), to_np(info2)),
            loss=loss, metrics=metrics, grads=grads)
    return _CASES[arch]


def _named(t) -> dict[str, np.ndarray]:
    """Leaves of a reference-layout tree by path name, as fp32 or int."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
        a = np.asarray(leaf)
        out[jax.tree_util.keystr(path)] = (a.astype(np.float32)
                                           if a.dtype.name == "bfloat16"
                                           else a)
    return out


def _ref_name(path: tuple) -> str:
    """A port leaf's name in the reference's layout (``jax``'s keystr):
    under ``segment_<i>`` the repeat index goes, since the reference
    stacks the repeats on a leading axis of one leaf."""
    key, rest = path[0], path[1:]
    if str(key).startswith("segment_"):
        rest = rest[1:]
    return "".join(f"[{k!r}]" for k in (key, *rest))


def _leaves_close(got, want, *, rtol: float, scale_atol: float = 0.0,
                  atol: float = 0.0) -> None:
    """Every leaf of ``got`` (the port's, stacked to the reference's
    layout) against ``want`` by name: the same names and shapes, and
    |got − want| ≤ atol + scale_atol·max|want_leaf| + rtol·|want|."""
    g, w = _named(got), _named(want)
    assert g.keys() == w.keys()
    for name in w:
        assert g[name].shape == w[name].shape, name
        bound = atol + scale_atol * float(np.abs(w[name]).max(initial=0))
        np.testing.assert_allclose(g[name], w[name], rtol=rtol, atol=bound,
                                   err_msg=name)


# ---------------------------------------------------------------------------
# loss_fn, grads and AdamW, all ten architectures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_and_metrics_match_reference(arch):
    """loss and every metric (lm, load-balance, MTP) within rtol 1e-4."""
    c = case(arch)
    assert set(c["metrics"]) == set(c["ref_metrics"])
    np.testing.assert_allclose(float(c["loss"]), c["ref_loss"], rtol=1e-4)
    for k, want in c["ref_metrics"].items():
        np.testing.assert_allclose(float(c["metrics"][k]), want, rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("x", [-1, -100, 8, -11])
def test_xent_takes_labels_as_the_reference(x):
    """The reference's ``_xent`` gathers with ``take_along_axis``: a
    negative label wraps once by V, and one still out of range reads NaN
    into the mean.  V = 8 and labels [[0, 1, x], [2, 3, 4]] on the same
    seeded logits: x = −1 reads class 7, x = −100, V and −V − 3 give NaN
    (−100 is not dropped).  Finite values within 1e-6, NaN where the
    reference's is."""
    from repro.models.model import _xent as ref_xent
    from repro_torch.models.model import _xent
    logits = np.random.default_rng(4).normal(size=(2, 3, 8)).astype(
        np.float32)
    labels = np.array([[0, 1, x], [2, 3, 4]], np.int32)
    want = float(ref_xent(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(_xent(torch.from_numpy(logits), torch.from_numpy(labels)))
    assert np.isnan(want) == (x != -1)
    np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)


@pytest.mark.parametrize("ids", ["wrapped", "out_of_range"])
def test_loss_fn_takes_token_ids_as_the_reference(ids):
    """``loss_fn`` on token ids out of range, where the embedding reads
    as JAX's ``table[ids]`` and the labels as ``_xent``: ids −1, −100
    and −V wrap to valid classes (finite loss within 1e-5 of the
    reference's); an id of V or −V − 3 among the labels makes the loss
    NaN in both packages."""
    c = case("smollm-135m")
    V = c["cfg"].vocab_size
    tokens = c["batch"]["tokens"].copy()
    tokens[0, 3], tokens[1, 5], tokens[1, 9] = -1, -100, -V
    if ids == "out_of_range":
        tokens[0, 7], tokens[1, 2] = V, -V - 3
    want, _ = ref_loss_fn(_ref_params("smollm-135m"),
                          {"tokens": jnp.asarray(tokens)}, c["ref_cfg"])
    got, _ = loss_fn(c["params"], {"tokens": torch.from_numpy(tokens)},
                     c["cfg"])
    assert np.isnan(float(want)) == (ids == "out_of_range")
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                               equal_nan=True)


def _ref_params(arch: str):
    return ref_init_params(jax.random.PRNGKey(0),
                           ref_reduced(ref_load_config(arch)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_grads_match_reference(arch):
    """Every grad leaf by name within rtol 1e-4 plus 1e-4 of the leaf's
    largest |grad| (measured: under 1e-5 of it); leaves the loss does not
    read (a parallel block's norm2, unused input embeddings) are zero in
    both."""
    c = case(arch)
    _leaves_close(interop.lm_params_to_numpy(c["grads"], c["cfg"]),
                  c["ref_grads"], rtol=1e-4, scale_atol=1e-4)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_apply_updates_matches_reference(arch):
    """One AdamW step on the same params, grads and non-zero moments
    (the reference's after its first step, so count goes 1 → 2) against
    the reference's jitted ``apply_updates``: params within 1e-7 plus
    1e-6 relative (a few fp32 ulps), mu and nu within rtol 1e-5 plus 1e-6
    of the leaf's largest value, count equal, grad_norm rtol 1e-5, lr
    equal.  A leaf decayed on one side only would be off by lr·wd·|p|."""
    c = case(arch)
    cfg = c["cfg"]
    p1, s1 = c["step1"]
    p2, s2, info2 = c["step2"]
    carry = lambda t: interop.lm_params_to_torch(t, cfg, "cpu")  # noqa: E731
    state = {"mu": carry(s1["mu"]), "nu": carry(s1["nu"]),
             "count": torch.tensor(int(s1["count"]), dtype=torch.int32)}
    params, new_state, info = adamw.apply_updates(
        carry(p1), carry(c["ref_grads"]), state, adamw.AdamWConfig())
    to_ref = lambda t: interop.lm_params_to_numpy(t, cfg)  # noqa: E731
    _leaves_close(to_ref(params), p2, rtol=1e-6, atol=1e-7)
    for k in ("mu", "nu"):
        _leaves_close(to_ref(new_state[k]), s2[k], rtol=1e-5,
                      scale_atol=1e-6)
    assert new_state["count"].dtype == torch.int32
    assert int(new_state["count"]) == int(s2["count"]) == 2
    np.testing.assert_allclose(float(info["grad_norm"]),
                               float(info2["grad_norm"]), rtol=1e-5)
    assert float(info["lr"]) == float(info2["lr"])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decay_mask_is_the_reference_layouts(arch):
    """The port's decay mask on its unstacked tree equals the reference's
    on its stacked tree, leaf by leaf; the 1-D per-layer leaves the
    reference decays because they are 2-D stacked (Qwen2.5's b_q, b_k,
    b_v; Jamba's conv_b; RWKV-6's mu_*) are decayed by name."""
    c = case(arch)
    ref_params = ref_init_params(jax.random.PRNGKey(0), c["ref_cfg"])
    want = {jax.tree_util.keystr(p): ref_adamw._decay_mask(p, leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(
                ref_params)[0]}
    got = {}
    for path, leaf in tree.flatten_with_paths(c["params"]):
        name = _ref_name(path)
        got.setdefault(name, set()).add(adamw._decay_mask(path, leaf))
    assert got.keys() == want.keys()
    for name, mask in want.items():
        assert got[name] == {mask}, name
    named = {"qwen2.5-14b": ("b_q", "b_k", "b_v"),
             "jamba-1.5-large-398b": ("conv_b",),
             "rwkv6-1.6b": ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g")}
    for leaf_name in named.get(arch, ()):
        hits = [n for n in want if n.endswith(f"['{leaf_name}']")]
        assert hits and all(got[n] == {True} for n in hits), leaf_name
    if arch == "rwkv6-1.6b":     # the channel mix's mu_k too
        assert got["['segment_0'][0]['mlp']['mu_k']"] == {True}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_gives_the_same_grads(arch):
    """``cfg.remat`` (activation checkpointing per repeat) changes what
    backward keeps, not what it computes: loss and grads bit for bit."""
    c = case(arch)
    cfg = dataclasses.replace(c["cfg"], remat=True)
    (loss, _), grads = steps.loss_and_grads(c["params"],
                                            _to_torch(c["batch"]), cfg)
    assert torch.equal(loss, c["loss"])
    for a, b in zip(tree.leaves(grads), tree.leaves(c["grads"])):
        assert torch.equal(a, b)


def test_three_train_steps_match_reference():
    """Three ``make_train_step`` steps on reduced smollm (warmup 1 of 3
    steps: LR scales 0, 1, 0.55) from the same params and the stream's
    first three batches: loss and grad_norm each step within rtol 1e-4,
    and after the last step params within 0.1·lr (Adam's step is
    g/(|g|+eps), so a grad's rounding moves leaves whose grads are near
    eps by up to that), mu and nu within rtol 1e-3 plus 1e-4 of the
    leaf's largest value."""
    ref_cfg = ref_reduced(ref_load_config("smollm-135m"))
    cfg = reduced(load_config("smollm-135m"))
    opt_cfg = adamw.AdamWConfig()
    ref_params = ref_init_params(jax.random.PRNGKey(0), ref_cfg)
    ref_step = jax.jit(ref_steps.make_train_step(
        ref_cfg, ref_adamw.AdamWConfig(), total_steps=3, warmup_steps=1))
    step = steps.make_train_step(cfg, opt_cfg, total_steps=3,
                                 warmup_steps=1)
    ref_state = ref_steps.TrainState(
        ref_params, ref_adamw.init_opt_state(ref_params,
                                             ref_adamw.AdamWConfig()),
        jnp.zeros((), jnp.int32))
    params = interop.lm_params_to_torch(
        jax.tree_util.tree_map(np.asarray, ref_params), cfg, "cpu")
    state = steps.TrainState(params, adamw.init_opt_state(params, opt_cfg),
                             torch.zeros((), dtype=torch.int32))
    stream = ref_synthetic_stream(RefDataConfig(
        batch_size=B, seq_len=S, vocab_size=cfg.vocab_size, seed=0))
    for i in range(3):
        tokens = next(stream)["tokens"]
        ref_state, ref_m = ref_step(ref_state,
                                    {"tokens": jnp.asarray(tokens)})
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(ref_m[k]),
                                       rtol=1e-4, err_msg=f"{k} step {i}")
    assert int(state.step) == int(ref_state.step) == 3
    assert int(state.opt["count"]) == 3
    to_ref = lambda t: interop.lm_params_to_numpy(t, cfg)  # noqa: E731
    _leaves_close(to_ref(state.params), ref_state.params, rtol=0,
                  atol=0.1 * opt_cfg.lr)
    for k in ("mu", "nu"):
        _leaves_close(to_ref(state.opt[k]), ref_state.opt[k], rtol=1e-3,
                      scale_atol=1e-4)


def test_train_step_leaves_its_input_state_alone():
    """The step is pure: the state that goes in keeps its values."""
    cfg = reduced(load_config("smollm-135m"))
    c = case("smollm-135m")
    opt_cfg = adamw.AdamWConfig()
    state = steps.TrainState(c["params"],
                             adamw.init_opt_state(c["params"], opt_cfg),
                             torch.ones((), dtype=torch.int32))
    before = [t.clone() for t in tree.leaves(state)]
    new, metrics = steps.make_train_step(cfg, opt_cfg)(
        state, _to_torch(c["batch"]))
    for a, b in zip(tree.leaves(state), before):
        assert torch.equal(a, b)
    assert int(new.step) == 2 and not metrics["loss"].requires_grad
    assert not any(t.requires_grad for t in tree.leaves(new))


# ---------------------------------------------------------------------------
# input_specs and the abstract train state
# ---------------------------------------------------------------------------

def _spec_pairs(port_specs, ref_specs):
    """(name, shape, port tensor, reference ShapeDtypeStruct) for every
    leaf, the port's decode cache named and shaped in the reference's
    layout (one leaf per unit layer, its repeats on a leading axis)."""
    for key, want in ref_specs.items():
        got = port_specs[key]
        if key != "cache":
            yield key, tuple(got.shape), got, want
            continue
        by_name: dict[str, list[torch.Tensor]] = {}
        for path, t in tree.flatten_with_paths(got):
            by_name.setdefault(_ref_name(path), []).append(t)
        want = {jax.tree_util.keystr(p): w for p, w in
                jax.tree_util.tree_flatten_with_path(want)[0]}
        assert by_name.keys() == want.keys()
        for name, w in want.items():
            t, *more = by_name[name]
            assert all(m.shape == t.shape and m.dtype == t.dtype
                       for m in more), name
            yield f"cache{name}", (1 + len(more), *t.shape), t, w


_DTYPES = {"int32": torch.int32, "float32": torch.float32,
           "bfloat16": torch.bfloat16, "int8": torch.int8,
           "float16": torch.float16}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_abstract_state_match_reference(arch):
    """``input_specs`` for every shape kind (train, prefill, decode with
    its cache) and ``abstract_train_state``, both of the full config:
    ``meta`` tensors whose shapes and dtypes are the reference's
    ``ShapeDtypeStruct``s (bf16 params, fp32 moments and routers)."""
    cfg, ref_cfg = load_config(arch), ref_load_config(arch)
    for name in REF_SHAPES:
        got = input_specs(cfg, name)
        want = ref_input_specs(ref_cfg, name)
        assert set(got) == set(want), name
        for leaf, shape, t, w in _spec_pairs(got, want):
            assert t.device.type == "meta", (name, leaf)
            assert shape == tuple(w.shape), (name, leaf)
            assert t.dtype == _DTYPES[str(w.dtype)], (name, leaf)
    st = steps.abstract_train_state(cfg, adamw.AdamWConfig())
    ref_st = ref_steps.abstract_train_state(ref_cfg, ref_adamw.AdamWConfig())
    assert all(t.device.type == "meta" for t in tree.leaves(st))
    assert st.step.dtype == st.opt["count"].dtype == torch.int32
    for part, got, want in (("params", st.params, ref_st.params),
                            ("mu", st.opt["mu"], ref_st.opt["mu"]),
                            ("nu", st.opt["nu"], ref_st.opt["nu"])):
        by_name: dict[str, list] = {}
        for path, t in tree.flatten_with_paths(got):
            by_name.setdefault(_ref_name(path), []).append((path, t))
        want = {jax.tree_util.keystr(p): w for p, w in
                jax.tree_util.tree_flatten_with_path(want)[0]}
        assert by_name.keys() == want.keys(), part
        for name, w in want.items():
            (path, t), *more = by_name[name]
            shape = tuple(t.shape)
            if str(path[0]).startswith("segment_"):
                shape = (1 + len(more), *shape)
            assert all(m.shape == t.shape for _, m in more), (part, name)
            assert shape == tuple(w.shape), (part, name)
            assert t.dtype == _DTYPES[str(w.dtype)], (part, name)


# ---------------------------------------------------------------------------
# the hand-written kernels under autograd
# ---------------------------------------------------------------------------

def _kernel_calls():
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    vals, cols = t(2, 2, 8, 8), torch.tensor([[0, 1], [1, -1]],
                                             dtype=torch.int32)
    idx = torch.tensor([0, 3, 1], dtype=torch.int32)
    return {
        "matmul": (lambda a, b: ops.matmul(a, b), (t(4, 8), t(8, 8))),
        "flash_attention": (lambda q, k, v: ops.flash_attention(q, k, v),
                            (t(1, 2, 8, 8), t(1, 1, 8, 8), t(1, 1, 8, 8))),
        "decode_attention": (
            lambda q, k, v: ops.decode_attention(
                q, k, v, torch.tensor([5], dtype=torch.int32)),
            (t(1, 2, 8), t(1, 1, 8, 8), t(1, 1, 8, 8))),
        "rmsnorm": (lambda x, w: ops.rmsnorm(x, w), (t(3, 8), t(8))),
        "spmv": (lambda v, x: ops.spmv(v, cols, x), (vals, t(16))),
        "decoupled_gather": (lambda tab: decoupled_gather(idx, tab),
                             (t(4, 8),)),
    }


@pytest.mark.parametrize("name", ["matmul", "flash_attention",
                                  "decode_attention", "rmsnorm", "spmv",
                                  "decoupled_gather"])
def test_kernel_wrappers_raise_under_autograd(name):
    """Each wrapper that launches a hand kernel raises NotImplementedError
    under grad mode with an input that requires grad (on the CPU too, as
    the reference's Pallas kernels fail under ``jax.grad`` in interpret
    mode), and does not fall back to its plain version; under
    ``torch.no_grad()`` and ``inference_mode`` it runs as before."""
    fn, args = _kernel_calls()[name]
    want = fn(*args)
    with pytest.raises(NotImplementedError, match="reference cannot "
                                                  "differentiate"):
        fn(*[a.clone().requires_grad_() for a in args])
    with torch.no_grad():
        got = fn(*[a.clone().requires_grad_() for a in args])
    with torch.inference_mode():
        again = fn(*args)
    assert torch.equal(got, want) and torch.equal(again, want)


def test_loss_fn_with_the_attention_kernels_raises_under_grad():
    """``attn_impl="pallas"`` reaches the hand attention kernel, which
    cannot be trained through: a train step raises, naming the
    reference's limit; the same loss under ``torch.no_grad()`` runs and
    equals the plain ``"full"`` path's."""
    c = case("smollm-135m")
    cfg = dataclasses.replace(c["cfg"], attn_impl="pallas")
    opt_cfg = adamw.AdamWConfig()
    state = steps.TrainState(c["params"],
                             adamw.init_opt_state(c["params"], opt_cfg),
                             torch.zeros((), dtype=torch.int32))
    batch = _to_torch(c["batch"])
    with pytest.raises(NotImplementedError, match="reference cannot"):
        steps.make_train_step(cfg, opt_cfg)(state, batch)
    with torch.no_grad():
        loss, _ = loss_fn(c["params"], batch, cfg)
    np.testing.assert_allclose(float(loss), float(c["loss"]), rtol=1e-5)


@pytest.mark.cuda
def test_kernel_guard_on_the_card():
    """On the card: a train step through the attention kernel raises, and
    the same loss under ``torch.no_grad()`` launches ``flash_attention``
    and equals the ``"full"`` path within 1e-4 (fp32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    dev = torch.device("cuda")
    c = case("smollm-135m")
    cfg = dataclasses.replace(c["cfg"], attn_impl="pallas")
    params = tree.tree_map(lambda t: t.to(dev), c["params"])
    batch = {k: v.to(dev) for k, v in _to_torch(c["batch"]).items()}
    opt_cfg = adamw.AdamWConfig()
    state = steps.TrainState(params, adamw.init_opt_state(params, opt_cfg),
                             torch.zeros((), dtype=torch.int32, device=dev))
    with pytest.raises(NotImplementedError, match="reference cannot"):
        steps.make_train_step(cfg, opt_cfg)(state, batch)
    before = _lib.counts()["flash_attention"]
    with torch.no_grad():
        loss, _ = loss_fn(params, batch, cfg)
    assert _lib.counts()["flash_attention"] > before
    np.testing.assert_allclose(float(loss), float(c["loss"]), rtol=1e-4)
