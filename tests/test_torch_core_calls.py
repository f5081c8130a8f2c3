"""The port's core conveniences against the JAX reference: ``decoupled_call``,
``ChannelSpec.from_example`` and ``CDFG.from_function`` with keyword
examples, on the same seeded numpy inputs, and the core's public names.

``decoupled_call`` runs the random programs of
``tests/test_core_cdfg.py`` (``_random_program``) under the four
policies: each program's stage count must be the reference's, and its
output the direct call's bit for bit.  Against the reference's output it
is bit for bit where the program is exact arithmetic; ``tanh`` and
``exp`` are torch's and XLA's own approximations on the CPU, which may
differ in the last place, so a program holding one is held to 2e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings  # noqa: E402 — skips when hypothesis is missing
from test_core_cdfg import _random_program

import repro.core as ref_core
import repro_torch
import repro_torch.core as port_core
from repro.core import CDFG as RefCDFG
from repro.core import ChannelSpec as RefSpec
from repro.core import decoupled_call as ref_decoupled_call
from repro_torch.core import CDFG, ChannelSpec, decoupled_call
from repro_torch.core.cdfg import trace

POLICIES = ("paper", "fused", "maximal", "cost_aware")


@pytest.fixture(autouse=True)
def _port_on_cpu():
    repro_torch.set_device("cpu")
    yield
    repro_torch.set_device(None)


def test_core_names_are_the_reference_s():
    """Every public name of ``repro.core`` in the same order, less the
    JAX shim ``shard_map_compat``."""
    assert port_core.__all__ == [n for n in ref_core.__all__
                                 if n != "shard_map_compat"]
    for name in port_core.__all__:
        assert hasattr(port_core, name), name


# -- decoupled_call --------------------------------------------------------------

def _program(ops, lib):
    """``tests/test_core_cdfg.py``'s random program over ``ops``, in
    ``jnp`` or in ``torch``."""
    if lib == "jax":
        def fn(table, idx):
            v = table[idx].astype(jnp.float32)
            for op in ops:
                if op == "gather":
                    j = jnp.clip(jnp.abs(v).astype(jnp.int32) % 32, 0, 31)
                    v = table[j]
                elif op == "mul":
                    v = v * 1.5
                elif op == "tanh":
                    v = jnp.tanh(v)
                elif op == "add":
                    v = v + 0.25
                elif op == "exp":
                    v = jnp.exp(jnp.clip(v, -5, 5))
                elif op == "sub":
                    v = v - 0.125
            return v
        return fn

    def fn(table, idx):
        v = table[idx].to(torch.float32)
        for op in ops:
            if op == "gather":
                j = torch.clamp(torch.abs(v).to(torch.int32) % 32, 0, 31)
                v = table[j]
            elif op == "mul":
                v = v * 1.5
            elif op == "tanh":
                v = torch.tanh(v)
            elif op == "add":
                v = v + 0.25
            elif op == "exp":
                v = torch.exp(torch.clamp(v, -5, 5))
            elif op == "sub":
                v = v - 0.125
        return v
    return fn


def _check_decoupled(ops, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(32,)).astype(np.float32)
    idx = rng.integers(0, 32, size=(8,)).astype(np.int32)
    rt, ri = jnp.asarray(table), jnp.asarray(idx)
    pt, pi = torch.from_numpy(table), torch.from_numpy(idx)
    ref_fn, port_fn = _program(ops, "jax"), _program(ops, "torch")
    direct = port_fn(pt, pi)
    exact = not {"tanh", "exp"} & set(ops)
    for policy in POLICIES:
        ref = ref_decoupled_call(ref_fn, rt, ri, policy=policy)
        port = decoupled_call(port_fn, pt, pi, policy=policy)
        assert len(port.program) == len(ref.program.stages), (ops, policy)
        got = port(pt, pi)
        assert torch.equal(got, direct), (ops, policy)
        want = np.asarray(ref(rt, ri))
        if exact:
            np.testing.assert_array_equal(got.numpy(), want)
        else:
            np.testing.assert_allclose(got.numpy(), want, rtol=2e-6,
                                       atol=2e-6)


@pytest.mark.parametrize("ops", [
    ("gather",), ("mul", "add", "sub"), ("gather", "gather", "mul"),
    ("tanh", "exp"), ("gather", "exp", "sub", "tanh"),
    ("sub", "gather", "add", "mul", "gather", "tanh", "exp", "add"),
])
def test_decoupled_call_equals_reference(ops):
    """Pinned programs: every op, two gathers in a row, and the longest."""
    _check_decoupled(list(ops), seed=len(ops))


@given(_random_program())
@settings(max_examples=10, deadline=None, derandomize=True)
def test_decoupled_call_equals_reference_random(prog_spec):
    ops, seed = prog_spec
    _check_decoupled(ops, seed)


def test_decoupled_call_returns_several_outputs_as_a_tuple():
    def ref_fn(x, i):
        return x[i] * 2.0, jnp.tanh(x)

    def port_fn(x, i):
        return x[i] * 2.0, torch.tanh(x)

    x = np.linspace(-1, 1, 16, dtype=np.float32)
    i = np.asarray([3, -1, 7], np.int32)
    ref = ref_decoupled_call(ref_fn, jnp.asarray(x), jnp.asarray(i))
    port = decoupled_call(port_fn, torch.from_numpy(x), torch.from_numpy(i))
    got = port(torch.from_numpy(x), torch.from_numpy(i))
    want = ref(jnp.asarray(x), jnp.asarray(i))
    assert isinstance(got, tuple) and len(got) == len(want) == 2
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert len(port.program) == len(ref.program.stages)


# -- ChannelSpec.from_example -------------------------------------------------------

class _Both:
    """One leaf already made for each package."""

    def __init__(self, ref, port):
        self.ref, self.port = ref, port


def _bf16(bits):
    """The same bf16 values for each package, from 16-bit patterns."""
    return _Both(
        jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16),
        torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16))


def _split(tree):
    """A numpy tree (arrays, Python and numpy scalars, ``None``,
    :class:`_Both`) as the reference's payload (``jnp`` arrays) and the
    port's: tensors, but Python scalars, numpy scalars and int64 /
    float64 arrays as they are, to meet the port's own conversion."""
    if tree is None:
        return None, None
    if isinstance(tree, _Both):
        return tree.ref, tree.port
    if isinstance(tree, dict):
        pairs = {k: _split(v) for k, v in tree.items()}
        return ({k: a for k, (a, _) in pairs.items()},
                {k: b for k, (_, b) in pairs.items()})
    if isinstance(tree, (list, tuple)):
        pairs = [_split(v) for v in tree]
        return (type(tree)(a for a, _ in pairs),
                type(tree)(b for _, b in pairs))
    if isinstance(tree, np.ndarray) and tree.dtype not in (np.int64,
                                                           np.float64):
        return jnp.asarray(tree), torch.from_numpy(tree.copy())
    return jnp.asarray(tree), tree


def _numpy_tree(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree(v) for v in tree)
    if tree.dtype == torch.bfloat16:
        return np.asarray(jax.lax.bitcast_convert_type(
            jnp.asarray(tree.view(torch.int16).numpy()), jnp.bfloat16))
    return tree.numpy()


def _example(case, rng):
    f32 = rng.normal(size=(3, 4)).astype(np.float32)
    if case == "tuple":
        return (f32, rng.integers(0, 9, 5).astype(np.int32),
                rng.integers(0, 255, 7).astype(np.uint8))
    if case == "list":
        return [rng.normal(size=3).astype(np.float16),
                rng.integers(-9, 9, (2, 2)).astype(np.int16)]
    if case == "unsorted_dict":
        return {"z": f32, "a": rng.integers(0, 9, 3).astype(np.int32),
                "m": {"y": np.float32(2.5), "b": f32[0]}}
    if case == "none":
        return {"b": None, "a": (None, f32), "c": [f32[:, 0], None]}
    if case == "python_scalars":
        # int -> int32, float and float64 -> float32, int64 -> int32
        return (3, 2.5, np.float64(-1.25), np.arange(5, dtype=np.int64),
                rng.normal(size=3))
    if case == "bf16_int8":
        bits = rng.integers(0, 1 << 16, 7).astype(np.uint16)
        bits[(bits & 0x7F80) == 0x7F80] = 0x3F80     # no NaN / inf
        return {"h": _bf16(bits),
                "q": rng.integers(-128, 128, (3, 3)).astype(np.int8),
                "s": rng.integers(-128, 128, 1).astype(np.int8)}
    raise ValueError(case)


def _compare_specs(ref_example, port_example):
    ref = RefSpec.from_example(ref_example)
    port = ChannelSpec.from_example(port_example)
    assert port.width == ref.width
    assert [(l.shape, l.words) for l in port.leaves] == \
        [(l.shape, l.words) for l in ref.leaves]
    ref_word = np.asarray(ref.pack(ref_example, pad_to=ref.width + 3))
    port_word = port.pack(port_example, pad_to=port.width + 3)
    assert port_word.dtype == torch.int32
    np.testing.assert_array_equal(port_word.numpy().view(np.uint32),
                                  ref_word)
    got = _numpy_tree(port.unpack(port_word))
    want = ref.unpack(ref_word)
    assert jax.tree_util.tree_structure(got) == \
        jax.tree_util.tree_structure(want)
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert g.dtype == np.asarray(w).dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("case", ["tuple", "list", "unsorted_dict", "none",
                                  "python_scalars", "bf16_int8"])
def test_from_example_equals_reference(case):
    """``width``, leaf layout and packed bytes are the reference's, and
    ``unpack`` returns the example's structure (dict keys sorted, as
    ``jax.tree_util`` rebuilds them)."""
    example = _example(case, np.random.default_rng(7))
    ref_ex, port_ex = _split(example)
    _compare_specs(ref_ex, port_ex)


def test_from_example_int64_leaves_under_x64():
    """int64 leaves (two words each, low word first), as the reference
    packs them with 64-bit types on; a tensor keeps its dtype."""
    vals = np.asarray([2 ** 40 + 3, -7, 2 ** 62, -(2 ** 63)], np.int64)
    f32 = np.asarray([1.5, -2.0, 3.25], np.float32)
    with jax.enable_x64(True):
        ref_ex = {"w": jnp.asarray(vals), "a": (jnp.asarray(f32), None)}
        port_ex = {"w": torch.from_numpy(vals.copy()),
                   "a": (torch.from_numpy(f32.copy()), None)}
        _compare_specs(ref_ex, port_ex)
    spec = ChannelSpec.from_example(port_ex)
    back = spec.unpack(spec.pack(port_ex))
    assert back["w"].dtype == torch.int64
    assert torch.equal(back["w"], port_ex["w"])


def test_from_avals_keeps_the_flat_tuple():
    """``from_avals`` and its callers' flat tuple stay as they were; an
    8-byte leaf after an odd number of words unpacks (it raised: F12)."""
    xs = (torch.arange(3, dtype=torch.float32), torch.tensor(2 ** 40 + 7))
    spec = ChannelSpec.from_avals(xs)
    assert spec.treedef is None
    back = spec.unpack(spec.pack(xs))
    assert isinstance(back, tuple) and len(back) == 2
    assert torch.equal(back[0], xs[0]) and torch.equal(back[1], xs[1])


# -- CDFG.from_function with keyword examples -------------------------------------

def _graph_key(cdfg, avals):
    return {
        "prims": [n.prim for n in cdfg.nodes],
        "edges": [(e.src, e.dst, e.kind) for e in cdfg.edges],
        "regions": [n.region for n in cdfg.nodes],
        "inputs": avals,
        "memory": [n.id for n in cdfg.memory_nodes],
        "long": [n.id for n in cdfg.long_nodes],
    }


def _ref_avals(cdfg):
    return [(tuple(v.aval.shape), str(v.aval.dtype)) for v in cdfg.invars]


def _port_avals(cdfg):
    return [(v.aval.shape, str(v.aval.dtype).removeprefix("torch."))
            for v in cdfg.invars]


def _spmv_body(acc, j, vals, cols, xv):
    c = cols[j]
    v = vals[j]
    xx = xv[c]
    return acc + v * xx


@pytest.mark.parametrize("keywords", [("vals", "cols", "xv"),
                                      ("xv", "cols"), ("xv",)])
def test_from_function_keyword_examples_equal_reference(keywords):
    """The SpMV body with some arrays passed by keyword: the keyword
    examples become graph inputs after the positional ones, by sorted
    name (``make_jaxpr``'s order, not the signature's), with the
    reference's nodes, primitives, edges and memory regions."""
    rng = np.random.default_rng(3)
    arrays = {"vals": rng.normal(size=24).astype(np.float32),
              "cols": rng.integers(0, 16, 24).astype(np.int32),
              "xv": rng.normal(size=16).astype(np.float32)}
    positional = [k for k in ("vals", "cols", "xv") if k not in keywords]
    ref = RefCDFG.from_function(
        _spmv_body, jnp.float32(0), jnp.int32(0),
        *(jnp.asarray(arrays[k]) for k in positional),
        **{k: jnp.asarray(arrays[k]) for k in keywords})
    port = CDFG.from_function(
        _spmv_body, torch.zeros(()), torch.zeros((), dtype=torch.int32),
        *(torch.from_numpy(arrays[k]) for k in positional),
        **{k: torch.from_numpy(arrays[k]) for k in keywords})
    assert _graph_key(port, _port_avals(port)) == _graph_key(
        ref, _ref_avals(ref))
    # the order itself: positional leaves, then keywords by name
    names = ["acc", "j", *positional, *sorted(keywords)]
    shapes = {"acc": (), "j": (), **{k: arrays[k].shape for k in arrays}}
    assert [a for a, _ in _port_avals(port)] == [shapes[n] for n in names]


def test_trace_keyword_tuple_example_flattens_after_positionals():
    """A tuple passed by keyword gives one input per leaf, after the
    positional ones, as ``make_jaxpr`` flattens ``(args, kwargs)``."""
    def ref_fn(x, pair, scale):
        return (pair[0][x] + pair[1][x]) * scale

    def port_fn(x, pair, scale):
        return (pair[0][x] + pair[1][x]) * scale

    rng = np.random.default_rng(4)
    a, b = (rng.normal(size=8).astype(np.float32) for _ in range(2))
    s = np.float32(0.5) * np.ones((3,), np.float32)
    x = np.asarray([1, 5, -2], np.int32)
    ref = RefCDFG.from_function(ref_fn, jnp.asarray(x),
                                scale=jnp.asarray(s),
                                pair=(jnp.asarray(a), jnp.asarray(b)))
    graph, _ = trace(port_fn, torch.from_numpy(x),
                     scale=torch.from_numpy(s),
                     pair=(torch.from_numpy(a), torch.from_numpy(b)))
    port = CDFG.from_graph(graph)
    assert _graph_key(port, _port_avals(port)) == _graph_key(
        ref, _ref_avals(ref))
