"""The train cells' dataflow census (``launch/dryrun.train_compiled``,
``core/autodiff.py``) against the reference's, on the CPU.

The reference's train step (``make_train_step(cfg, AdamWConfig())`` on
the abstract train state, ``value_and_grad`` and AdamW inlined) is
compiled by ``repro.dataflow`` at ``train_4k`` and published widths; the
port's by ``train_compiled``.  Both equation lists split into four
sections: (1) what comes before the first segment (the token slices and
the embedding's read), (2) from there to the last forward ``scan`` (the
segments' hoisted loop invariants, their forward scans), (3) the loss
tail and the backward, (4) the schedule and AdamW (from the first
equation that reads the step).  For all ten architectures, SmolLM-135M
under remat and Jamba-1.5-Large with the chunked Mamba scan (ROADMAP
"Decisions": each segment's body a ``cdfg.scan`` partially evaluated as
JAX does, its attention scan, WKV recurrence or Mamba scans nested in
it; under remat one ``remat2`` equation) all four must be equal
equation by equation — primitive, ``jit`` name, output avals, and where
each operand comes from (a scan's operands by count) — and the census
is the reference's (``chip_smoke.REF_TRAIN_CENSUS``).  DeepSeek-V3's
section 3 also holds its MTP head's layer, lowered inline on both
sides.  A two-level scan alone (a scan whose body holds the chunked
attention's), and one reduced RWKV-6 layer, one reduced Mamba layer
(either scan) and one reduced SmolLM layer under ``jax.checkpoint`` as
the body of a scan, are held against ``jax.make_jaxpr`` equation by
equation, nested bodies included.

The lowered step also runs: on a reduced SmolLM through the
``sequential`` backend, its gradients, loss, metrics, params and
moments are those of ``steps.loss_and_grads`` / ``make_train_step``;
and each JVP rule's transpose is held to ``torch.autograd`` on a small
input.  The recurrences, a ``cdfg.scan`` each, equal on tensors the
Python loops they replace, bit for bit.
"""

import dataclasses
import functools
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

import repro_torch
from repro.configs import load_config as ref_load_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.dataflow import compile as ref_compile
from repro.launch import steps as ref_steps
from repro.models import model as ref_M
from repro.optim import adamw as ref_adamw
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, load_config, reduced
from repro_torch.configs.base import InputShape
from repro_torch.core import autodiff, cdfg
from repro_torch.dataflow import compile as dataflow_compile
from repro_torch.launch import dryrun, steps
from repro_torch.models import attention, layers, model as M, moe, ssm
from repro_torch.optim import adamw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: the architectures held section by section, one for each mechanism:
#: tied embeddings and RMSNorm; LayerNorm (``jit _var``, split where the
#: segment's loop invariants are hoisted); embeddings in (a zero carry
#: tangent, an unread ``embed``) and the tanh GELU; stacked leaves the
#: body never reads (Command-R's ``ln2``: no cotangent out of the
#: transposed scan); the MoE load balance's cotangent into the scan's
#: ``ys``, and the router's softmax (``stop_gradient``); the MTP head and
#: two segments; RWKV-6 (the WKV recurrence nested in the segment's scan,
#: the token shifts' zero tangents, ``jit relu`` and ``square``); Jamba
#: (seven Mamba scans and an attention scan nested in one body, ``jit
#: softplus`` split where the loop invariants are hoisted)
SECTION_ARCHS = ("smollm-135m", "olmo-1b", "musicgen-large",
                 "command-r-plus-104b", "llama4-scout-17b-a16e",
                 "deepseek-v3-671b", "rwkv6-1.6b", "jamba-1.5-large-398b")


@pytest.fixture(autouse=True)
def _port_on_cpu():
    repro_torch.set_device("cpu")
    yield
    repro_torch.set_device(None)


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    import chip_smoke
    return chip_smoke


def _census(compiled) -> dict:
    """``dryrun.census_of`` (of either package's ``Compiled``)."""
    return dict(dryrun.census_of(compiled))


#: the cells held beyond the published configs (``chip_smoke.
#: TRAIN_VARIANTS``): SmolLM-135M under remat, Jamba-1.5-Large with the
#: chunked Mamba scan
VARIANTS = ("smollm-135m+remat", "jamba-1.5-large-398b+chunked")


@functools.lru_cache(maxsize=None)
def _ref(arch: str) -> tuple:
    """The reference's census, equations and step input (as
    ``dataflow_census`` compiles it)."""
    cfg = _chip_smoke().train_config(arch, ref_load_config)
    opt = ref_adamw.AdamWConfig()
    specs = ref_M.input_specs(cfg, REF_SHAPES["train_4k"])
    c = ref_compile(ref_steps.make_train_step(cfg, opt),
                    ref_steps.abstract_train_state(cfg, opt), specs,
                    backend="xla", use_cache=False)
    j = c.closed_jaxpr.jaxpr
    step_in = j.invars[-len(jax.tree_util.tree_leaves(specs)) - 1]
    eqns = [("jit " + e.params["name"] if e.primitive.name == "jit"
             else e.primitive.name, e.invars, e.outvars) for e in j.eqns]
    return _census(c), eqns, (j.invars, j.constvars), \
        step_in


@functools.lru_cache(maxsize=None)
def _port_compiled(arch: str):
    """The port's compiled train step (as ``dataflow_census`` compiles
    it)."""
    return dryrun.train_compiled(_chip_smoke().train_config(arch),
                                 "train_4k")


@functools.lru_cache(maxsize=None)
def _port(arch: str) -> tuple:
    cfg = _chip_smoke().train_config(arch)
    c = _port_compiled(arch)
    g = c.graph
    step_in = g.invars[-(2 if cfg.frontend_stub else 1) - 1]
    eqns = [("jit " + e.name if e.prim == "jit" else e.prim, e.invars,
             e.outvars) for e in g.eqns]
    return _census(c), eqns, (g.invars, g.constvars), \
        step_in


def _sections(eqns: list, step_in, s1: int | None, invars=()
              ) -> tuple[int, int, int]:
    """(end of section 1, end of section 2, start of section 4).  Section
    1 ends at the first equation that reads only constants (the first
    segment's hoisted loop invariants) or at the first forward ``scan``,
    whichever comes first: ``s1`` gives the port's end to the
    reference."""
    names = [n for n, _, _ in eqns]
    fwd = [i for i in range(names.index("jit log_softmax"))
           if names[i] == "scan"]
    s4 = next(i for i, (_, ins, _) in enumerate(eqns)
              if any(v is step_in for v in ins))
    if s1 is None:
        made, invars = set(), set(invars)
        s1 = fwd[0]
        for i, (name, ins, outs) in enumerate(eqns[:fwd[0]]):
            if all(type(v).__name__ == "Literal" or v not in made
                   and v not in invars for v in ins):
                s1 = i
                break
            made.update(outs)
    return s1, fwd[-1] + 1, s4


def _aval(v) -> tuple:
    dt = str(v.aval.dtype).replace("torch.", "")
    return tuple(v.aval.shape), dt


def _rows(eqns: list, inputs: tuple, bounds: tuple) -> list:
    """Each equation as (name, output avals, operand origins): an input's
    index, a constant's (numbered by its first use), a literal's fp32
    value, or (section, offset, output) of the equation that made it."""
    s1, s2, s4 = bounds
    invars, constvars = inputs
    where = {v: ("in", i) for i, v in enumerate(invars)}
    consts = set(constvars)
    rank: dict = {}
    rows = []
    for k, (name, ins, outs) in enumerate(eqns):
        ops = []
        for v in ins:
            if type(v).__name__ == "Literal":
                ops.append(("lit", float(np.float32(np.asarray(v.val)))))
            elif v in consts:
                rank.setdefault(v, len(rank))
                ops.append(("const", rank[v]))
            else:
                ops.append(where[v])
        rows.append((name, tuple(map(_aval, outs)), tuple(ops)))
        for o, v in enumerate(outs):
            if k < s1:
                where[v] = (1, k, o)
            elif k < s2:
                where[v] = (2, k - s1, o)
            elif k < s4:
                where[v] = (3, k - s2, o)
            else:
                where[v] = (4, k - s4, o)
    return rows


def _segments_scanned(arch: str) -> bool:
    """Whether every scan of ``arch``'s lowered step replays a lowered
    body (each segment one ``cdfg.scan`` over its stacked leaves)."""
    return all(getattr(e.impl, "func", None) is cdfg._run_loop
               for e in _port_compiled(arch).graph.eqns if e.prim == "scan")


def _split(arch: str, side, s1: int | None = None) -> tuple:
    """The census and the four sections' rows of ``side(arch)``."""
    census, eqns, inputs, step_in = side(arch)
    bounds = _sections(eqns, step_in, s1, inputs[0])
    rows = _rows(eqns, inputs, bounds)
    s1, s2, s4 = bounds
    return census, rows[:s1], rows[s1:s2], rows[s2:s4], rows[s4:]


@pytest.mark.parametrize("arch", (*SECTION_ARCHS, *VARIANTS))
def test_train_census_sections_equal_the_reference(arch):
    """All four sections equal equation by equation, operands included
    (a scan's by count: its operand order is not held) — section 2's
    hoisted loop invariants (RoPE tables, the split ``jit`` equations,
    the zero carries and zero tangents, the ``jit`` equations left with
    no output, the hoisted mask ``scan``, under remat the hoisted mask
    ``closed_call``) among them — and the census the reference's; every
    segment is one scan of a lowered body."""
    census, *port = _split(arch, _port)
    ref_census, *ref = _split(arch, _ref, len(port[0]))
    assert _segments_scanned(arch)
    assert not any(r[0] == "checkpoint" for sec in port for r in sec)
    for sec in range(4):
        assert len(port[sec]) == len(ref[sec]), (arch, sec + 1)
        for k, (a, b) in enumerate(zip(port[sec], ref[sec])):
            if a[0] == "scan":
                a, b = (*a[:2], len(a[2])), (*b[:2], len(b[2]))
            assert a == b, (arch, sec + 1, k)
    assert census == ref_census


@pytest.mark.parametrize("arch", (*ARCH_IDS, *VARIANTS))
def test_pinned_train_census_is_the_live_reference(arch):
    """``chip_smoke.REF_TRAIN_CENSUS`` (all ten and the two options,
    ``channel_bytes`` included) is the live reference's census, and the
    port's census equals it outright; every scan of the port's step
    replays a lowered body, and the segment scan that transposed under
    ``torch.autograd`` is gone."""
    cs = _chip_smoke()
    assert cs.TRAIN_VARIANTS == VARIANTS
    ref_census = _ref(arch)[0]
    assert cs.REF_TRAIN_CENSUS[arch] == ref_census
    assert _port(arch)[0] == ref_census
    assert not hasattr(cs, "TRAIN_SECTION2")
    assert _segments_scanned(arch)
    assert not any(hasattr(autodiff, name) for name in (
        "_scan_fwd", "_read_by_body", "_scan_vjp", "_View"))
    assert not hasattr(M.transformer, "body_traced")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_decay_mask_on_the_stacked_census_leaves(arch):
    """``_decay_mask`` on the census's stacked leaves (which carry the
    repeats axis) is the reference's on its own, leaf by leaf."""
    ref_params = ref_steps.abstract_train_state(
        ref_load_config(arch), ref_adamw.AdamWConfig()).params
    want = [(jax.tree_util.keystr(p), ref_adamw._decay_mask(p, leaf))
            for p, leaf in jax.tree_util.tree_flatten_with_path(
                ref_params)[0]]
    state = steps.stack_train_state(steps.abstract_train_state(
        load_config(arch), adamw.AdamWConfig()))
    got = [("".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                    for k in path), adamw._decay_mask(path, leaf))
           for path, leaf in tree.flatten_with_paths(state.params)]
    assert got == want


# -- the lowered step runs ---------------------------------------------------

B, S = 2, 16
SHAPE = InputShape("train_4k", S, B, "train")


def _close(got, want, *, rtol, atol=0.0, scale_atol=0.0, what=""):
    for (path, a), b in zip(tree.flatten_with_paths(got), tree.leaves(want),
                            strict=True):
        tol = atol + scale_atol * float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=rtol, atol=tol,
                                   msg=lambda m: f"{what} {path}: {m}")


def _smollm(arch="smollm-135m"):
    cfg = reduced(load_config(arch))
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    rng = np.random.default_rng(0)
    batches = [{"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32))} for _ in range(3)]
    return cfg, params, batches


#: the reduced DeepSeek-V3 that takes the chunked attention route: one
#: sequence of 2,100 tokens (the MTP layer's 2,099 keys: three chunks of
#: 1,024, the last padded)
CHUNKED_B, CHUNKED_S = 1, 2100


def _deepseek_chunked():
    cfg = dataclasses.replace(reduced(load_config("deepseek-v3-671b")),
                              attn_impl="chunked")
    params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (CHUNKED_B, CHUNKED_S + 1)).astype(np.int32))}
    return cfg, params, [batch]


def _no_autograd_transpose(graph):
    """Every segment's transpose replays its transposed body's equations
    (a reverse scan of a lowered body), none runs ``torch.autograd``."""
    assert all(getattr(e.impl, "func", None) is cdfg._run_loop
               for e in graph.eqns if e.prim == "scan")
    assert _chip_smoke().transposes_replayed(graph) > 0


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v3-671b",
                                  "rwkv6-1.6b", "jamba-1.5-large-398b",
                                  "smollm-135m+remat",
                                  "jamba-1.5-large-398b+chunked"])
def test_lowered_grads_equal_loss_and_grads(arch):
    """The ``grad`` leaf alone, lowered and run by the ``sequential``
    backend on a reduced SmolLM, a reduced DeepSeek-V3 (MLA, MoE, its
    MTP layer inline, 2,100 tokens: every attention takes the chunked
    route, the MTP layer's as the lowered scan and its transpose), a
    reduced RWKV-6 (the WKV recurrence a scan nested in the segment's)
    and a reduced Jamba (Mamba's selective scans, attention and MoE in
    one unit): loss, metrics and every gradient leaf (stacked) those of
    ``steps.loss_and_grads`` (autograd) — loss rtol 1e-4, grads rtol
    1e-4 + 1e-4·max|g| (PERF.md §2); each segment's transpose replays its
    transposed body's equations, none runs ``torch.autograd`` — under
    ``cfg.remat`` too (SmolLM's: the reverse scan's body one ``remat2``
    equation) and with a Mamba mixer under ``scan_impl="chunked"``
    (Jamba's: the chunk scan nested in the segment's)."""
    base, _, variant = arch.partition("+")
    cfg, params, batches = (_deepseek_chunked() if arch == "deepseek-v3-671b"
                            else _smollm(base))
    cfg = dataclasses.replace(cfg, remat=variant == "remat")
    if variant == "chunked":
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, scan_impl="chunked", chunk=4))
    stacked = M.transformer.stack_repeats(params)

    def value_and_grads(p_leaves, b_leaves):
        (loss, metrics), grads = steps.loss_and_grads(
            tree.unflatten(stacked, list(p_leaves)),
            tree.unflatten(batches[0], list(b_leaves)), cfg)
        return (loss, *tree.leaves(metrics), *tree.leaves(grads))

    with cdfg.leaves(index=[(layers, "take")],
                     scan=[(M.transformer, "_segment_forward")],
                     grad=[(steps, "loss_and_grads")]):
        comp = dataflow_compile(value_and_grads, tuple(tree.leaves(stacked)),
                                tuple(tree.leaves(batches[0])),
                                backend="sequential", device="cpu",
                                use_cache=False)
    if arch == "deepseek-v3-671b":      # each segment's hoisted mask scan,
        # forward and reverse scans; the MTP attention's two
        assert sum(e.prim == "scan" for e in comp.graph.eqns) == 3 * len(
            cfg.segments) + 2
    _no_autograd_transpose(comp.graph)
    if variant == "remat":
        assert [q.prim for q in [e for e in comp.graph.eqns if e.prim ==
                                 "scan"][-1].impl.args[0].eqns] == ["remat2"]
    out = comp(tuple(tree.leaves(stacked)), tuple(tree.leaves(batches[0])))
    (loss, metrics), grads = steps.loss_and_grads(params, batches[0], cfg)
    want = [loss, *tree.leaves(metrics)]
    for a, b in zip(out[:len(want)], want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=0)
    _close(tree.unflatten(stacked, list(out[len(want):])),
           M.transformer.stack_repeats(grads), rtol=1e-4, scale_atol=1e-4,
           what="grad")


def _change_err(got, want, before) -> float:
    """The largest, over leaves, of ``‖(got − before) − (want −
    before)‖₂ / ‖want − before‖₂``: how far one step's change of the
    params is from another's."""
    worst = 0.0
    for a, b, p in zip(tree.leaves(got), tree.leaves(want),
                       tree.leaves(before), strict=True):
        d = (b.double() - p.double()).norm()
        assert d > 0
        worst = max(worst, float((a.double() - b.double()).norm() / d))
    return worst


def test_lowered_step_equals_make_train_step():
    """``train_compiled`` on a reduced SmolLM, run three steps by the
    ``sequential`` backend from step 200 (past the 200-step warmup: LR
    scale ~1), against ``make_train_step`` from the same state and
    batches: loss, metrics each step rtol 1e-4; after the last, params
    within 0.1·lr and each leaf's change within 1e-3 of its L2 norm,
    mu and nu rtol 1e-3 + 1e-4·max, count and step equal (PERF.md §2's
    three-step bars)."""
    cfg, params, batches = _smollm()
    opt_cfg = adamw.AdamWConfig()
    state = steps.TrainState(params, adamw.init_opt_state(params, opt_cfg),
                             torch.tensor(200, dtype=torch.int32))
    comp = dryrun.train_compiled(cfg, SHAPE, device="cpu",
                                 backend="sequential")
    _no_autograd_transpose(comp.graph)
    step = steps.make_train_step(cfg, opt_cfg)
    lowered = before = steps.stack_train_state(state)
    n = len(tree.leaves(lowered))
    for i, batch in enumerate(batches):
        state, metrics = step(state, batch)
        out = comp(tuple(tree.leaves(lowered)), tuple(tree.leaves(batch)))
        lowered = tree.unflatten(lowered, list(out[:n]))
        got = dict(zip(metrics, out[n:]))
        assert float(metrics["lr"]) > 0.99 * opt_cfg.lr
        for k, v in metrics.items():
            torch.testing.assert_close(got[k], v, rtol=1e-4, atol=0,
                                       msg=lambda m: f"{k} step {i}: {m}")
    want = steps.stack_train_state(state)
    assert int(lowered.step) == int(want.step) == 203
    assert int(lowered.opt["count"]) == 3
    _close(lowered.params, want.params, rtol=0, atol=0.1 * opt_cfg.lr,
           what="params")
    assert _change_err(lowered.params, want.params, before.params) <= 1e-3
    for k in ("mu", "nu"):
        _close(lowered.opt[k], want.opt[k], rtol=1e-3, scale_atol=1e-4,
               what=k)


@pytest.mark.parametrize("stack_below", [0, steps.STACK_BELOW])
def test_train_step_stacks_small_segment_leaves_only(stack_below,
                                                     monkeypatch):
    """``make_train_step`` stacks a segment's repeats for AdamW only when
    its leaves average under ``STACK_BELOW`` elements (the reduced
    SmolLM's do); either way one step equals ``apply_updates`` on the
    per-repeat tree (params rtol 1e-6 + 1e-7, mu/nu rtol 1e-5)."""
    cfg, params, batches = _smollm()
    opt_cfg = adamw.AdamWConfig()
    monkeypatch.setattr(steps, "STACK_BELOW", stack_below)
    calls = []
    stack = M.transformer.stack_repeats
    monkeypatch.setattr(M.transformer, "stack_repeats",
                        lambda t: calls.append(1) or stack(t))
    state = steps.TrainState(params, adamw.init_opt_state(params, opt_cfg),
                             torch.tensor(200, dtype=torch.int32))
    new, metrics = steps.make_train_step(cfg, opt_cfg)(state, batches[0])
    assert bool(calls) == (stack_below > 0)
    (_, _), grads = steps.loss_and_grads(params, batches[0], cfg)
    lr_scale = float(metrics["lr"]) / opt_cfg.lr
    want, opt, _ = adamw.apply_updates(params, grads, state.opt, opt_cfg,
                                       lr_scale)
    _close(new.params, want, rtol=1e-6, atol=1e-7, what="params")
    for k in ("mu", "nu"):
        _close(new.opt[k], opt[k], rtol=1e-5, what=k)


# -- each rule's transpose against torch.autograd ----------------------------

_NS = types.SimpleNamespace()


def _toy_segment(p, x, *, remat=False):
    """A ``cdfg.scan`` over a segment's stacked leaves: a tanh layer, and
    each repeat's mean square as its ``ys``; ``v`` is never read (with
    ``remat``, the body under ``cdfg.checkpoint``)."""
    def body(consts, carry, row):
        v, w = row
        h = torch.tanh(carry[0] @ w) * 1.5
        return (h,), ((h * h).mean(),)
    if remat:
        body = cdfg.checkpoint(body)
    (h,), (ys,) = cdfg.scan(body, (x,), (p["v"], p["w"]))
    return h.sum() + 3 * ys.sum()


def _rng(*shape, seed=0):
    g = torch.Generator().manual_seed(seed + 7 * len(shape))
    return torch.rand(*shape, generator=g) + 0.5


_IDX = torch.tensor([3, 0, 5], dtype=torch.int32)


def _split_case(p, x, i):
    """Three pieces, the middle one unread (a zero cotangent)."""
    a, b, c = p["w"].split([1, 2, 1], -1)
    return (a * x[:, :1]).sum() + (c * c * x[:, 3:]).sum()

#: rule -> (value function (params, x, idx), params, x)
RULE_CASES = {
    "neg": (lambda p, x, i: (-p["w"] * x).sum(), {"w": _rng(3, 4)}),
    "convert_element_type": (lambda p, x, i: (p["w"].to(torch.float64)
                                              * x.to(torch.float64)).sum(),
                             {"w": _rng(3, 4)}),
    "reduce_sum": (lambda p, x, i: (p["w"].sum(-1, keepdim=True)
                                    * x).sum(), {"w": _rng(3, 4)}),
    "broadcast_in_dim": (lambda p, x, i: (x * p["v"]).sum(),
                         {"v": _rng(4)}),
    "squeeze and slice": (lambda p, x, i: (p["w"][:, 0] * x[:, 1]).sum(),
                          {"w": _rng(3, 4)}),
    "add": (lambda p, x, i: ((p["w"] + p["w"] * x) * x).sum(),
            {"w": _rng(3, 4)}),
    "sub": (lambda p, x, i: ((x - p["w"]) * (p["w"] - p["w"] * x)).sum(),
            {"w": _rng(3, 4)}),
    "mul": (lambda p, x, i: (p["w"] * p["w"] * x).sum(), {"w": _rng(3, 4)}),
    "div": (lambda p, x, i: (p["w"] / x + x / (p["w"] * p["v"])).sum(),
            {"w": _rng(3, 4), "v": _rng(3, 1, seed=1)}),
    "rsqrt": (lambda p, x, i: (torch.rsqrt(p["w"] * p["w"] + 1.0)
                               * x).sum(), {"w": _rng(3, 4)}),
    "dot_general": (lambda p, x, i: (torch.einsum(
        "bd,vd->bv", p["u"] * x, p["w"]) * p["w"][:, 0]).sum(),
        {"u": _rng(3, 4), "w": _rng(5, 4, seed=1)}),
    "gather": (lambda p, x, i: (layers.take(p["w"], i) * x).sum(),
               {"w": _rng(6, 4)}),
    "jit log_softmax": (lambda p, x, i: (torch.log_softmax(
        p["w"] * x, -1)[..., 0] * x[:, 1]).sum(), {"w": _rng(3, 4)}),
    "jit take_along_axis": (lambda p, x, i: M.take_along_axis(
        torch.log_softmax(p["w"], -1), (i[:, None] % 4)).sum(),
        {"w": _rng(3, 4)}),
    "jit _var": (lambda p, x, i: (p["w"].var(dim=-1, keepdim=True,
                                             unbiased=False)
                                  * x[:, :1]).sum(), {"w": _rng(3, 4)}),
    "concatenate": (lambda p, x, i: (torch.cat([p["w"] * x, x], -1)
                                     @ p["u"]).sum(),
                    {"u": _rng(8, 5), "w": _rng(3, 4, seed=1)}),
    "reshape and transpose": (lambda p, x, i: (p["w"].reshape(4, 3).transpose(
        0, 1) * x + p["u"].permute(1, 0) * x).sum(),
        {"w": _rng(3, 4), "u": _rng(4, 3, seed=1)}),
    "split": (_split_case, {"w": _rng(3, 4)}),
    "jit _pad": (lambda p, x, i: (torch.nn.functional.pad(
        p["w"] * p["w"], (0, 0, 0, 1))[1:] * x).sum(), {"w": _rng(3, 4)}),
    "integer_pow": (lambda p, x, i: (p["w"] ** 3 * x).sum(),
                    {"w": _rng(3, 4)}),
    "pow": (lambda p, x, i: (p["w"] ** 1.5 * x + 2.0 ** (p["w"] * x)).sum(),
            {"w": _rng(3, 4)}),
    "logistic": (lambda p, x, i: (torch.sigmoid(p["w"]) * x).sum(),
                 {"w": _rng(3, 4)}),
    "exp": (lambda p, x, i: (torch.exp(p["w"]) * x).sum(), {"w": _rng(3, 4)}),
    "max": (lambda p, x, i: (torch.maximum(p["w"], x) * x
                             + torch.maximum(p["w"], p["u"] * x)
                             + p["w"].clamp_min(1.0) * x).sum(),
            {"w": _rng(3, 4), "u": _rng(3, 4, seed=1)}),
    "reduce_max": (lambda p, x, i: (p["w"].amax(-1) * x[:, 0]).sum(),
                   {"w": _rng(3, 4)}),
    "top_k": (lambda p, x, i: (moe._top_k(p["w"] * x, 2)[0] ** 2).sum(),
              {"w": _rng(3, 4)}),
    "scatter-add": (lambda p, x, i: (lambda y: (y * y).sum())(cdfg.at_add(
        p["v"] * 1.5, i + 3, p["w"] * x) + cdfg.at_add(torch.zeros(
            (6, 4), device=x.device), i, p["w"])), {"v": _rng(6, 4),
                                                    "w": _rng(3, 4)}),
    "jit softmax": (lambda p, x, i: (torch.softmax(p["w"] * x, -1)
                                     * x).sum(), {"w": _rng(3, 4)}),
    "tanh": (lambda p, x, i: (torch.tanh(p["w"] * x) * x
                              + torch.nn.functional.gelu(
                                  p["w"] - x, approximate="tanh")).sum(),
             {"w": _rng(3, 4)}),
    "stop_gradient": (lambda p, x, i: (p["w"] * p["w"].detach() * x
                                       + moe._softmax(p["w"] * x)).sum(),
                      {"w": _rng(3, 4)}),
    "jit silu": (lambda p, x, i: (torch.nn.functional.silu(p["w"]) * x).sum(),
                 {"w": _rng(3, 4)}),
    "jit _where": (lambda p, x, i: (torch.where(x > 1.0, p["w"], 0) * x
                                    + torch.where(x < 1.0, p["w"], p["w"] * x)
                                    + torch.where(x[:, :1] > 1.0, 2.0,
                                                  p["w"] * p["w"])
                                    + p["w"].masked_fill(x > 1.2, -3.0)
                                    ).sum(),
                   {"w": _rng(3, 4)}),
    "square": (lambda p, x, i: (torch.square(p["w"] * x) * x).sum(),
               {"w": _rng(3, 4)}),
    "jit relu": (lambda p, x, i: (torch.nn.functional.relu(p["w"] - x)
                                  * x).sum(), {"w": _rng(3, 4)}),
    "jit softplus": (lambda p, x, i: (torch.nn.functional.softplus(
        p["w"] * x - 1.5) * x).sum(), {"w": _rng(3, 4)}),
    "scan and jit _pad": (lambda p, x, i: (attention._chunked_attention(
        p["q"], p["k"], p["v"], causal=True, chunk=2) ** 2).sum() * x.sum(),
        {"q": _rng(1, 2, 5, 6), "k": _rng(1, 2, 5, 6, seed=1),
         "v": _rng(1, 2, 5, 3, seed=2)}),
    "scan": (lambda p, x, i: _toy_segment(p, x),
             {"v": _rng(3, 3, 4), "w": _rng(3, 4, 4, seed=2) / 4}),
    "remat2": (lambda p, x, i: _toy_segment(p, x, remat=True),
               {"v": _rng(3, 3, 4), "w": _rng(3, 4, 4, seed=2) / 4}),
    "jit cumsum": (lambda p, x, i: (torch.cumsum(p["w"] * x, dim=1)
                                    * x).sum(), {"w": _rng(3, 4)}),
    "dynamic_slice": (lambda p, x, i: (p["w"][:, -1] * x[:, 0]).sum()
                      + (p["w"][-1] * x[0]).sum(), {"w": _rng(3, 4)}),
}


def test_rules_cover_every_jvp_rule():
    named = {n for case in RULE_CASES for n in case.split(" and ")}
    assert named == set(autodiff.JVP_RULES)


@pytest.mark.parametrize("rule", sorted(RULE_CASES))
def test_transpose_rule_matches_autograd(rule):
    """A value function through the rule, lowered by a ``grad`` leaf and
    run by the ``sequential`` backend: value and gradients those of
    ``torch.autograd`` on the same inputs (rtol 1e-5), an unread leaf's
    gradient zero."""
    fn, params = RULE_CASES[rule]
    x = _rng(3, 4, seed=5)

    def value_and_grad(p, *args):
        raise AssertionError("traced only")

    value_and_grad.value_fn = lambda p, x, i: (fn(p, x, i), {})
    value_and_grad.unstacked = lambda p, *args: p
    _NS.grad = value_and_grad

    def traced(p_leaves, x, idx):
        (v, _), g = _NS.grad(tree.unflatten(params, list(p_leaves)), x, idx)
        return (v, *tree.leaves(g))

    with cdfg.leaves(index=[(layers, "take")], grad=[(_NS, "grad")]):
        comp = dataflow_compile(traced, tuple(tree.leaves(params)), x, _IDX,
                                backend="sequential", device="cpu",
                                use_cache=False)
    out = comp(tuple(tree.leaves(params)), x, _IDX)
    leaves = [t.detach().clone().requires_grad_() for t in
              tree.leaves(params)]
    want = fn(tree.unflatten(params, leaves), x, _IDX)
    grads = torch.autograd.grad(want, leaves, allow_unused=True)
    torch.testing.assert_close(out[0], want.detach(), rtol=1e-5, atol=1e-6)
    for got, g, p in zip(out[1:], grads, leaves, strict=True):
        torch.testing.assert_close(
            got, torch.zeros_like(p) if g is None else g, rtol=1e-5,
            atol=1e-6)


# -- the attention scan's partial evaluation, alone, against the reference ----

#: a chunked attention at a small size: 5 keys in chunks of 2 (3 chunks, the
#: last padded), bf16 as MLA's, 2 heads of 6 (values 4)
ATT_B, ATT_H, ATT_S, ATT_D, ATT_DV, ATT_CHUNK = 1, 2, 5, 6, 4, 2


def _att_inputs(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((ATT_B, ATT_H, ATT_S, n)).astype(np.float32)
            for n in (ATT_D, ATT_D, ATT_DV)]


def _ref_att_jaxpr(q, k, v, chunk, causal=True):
    import jax.numpy as jnp
    from repro.models.attention import _chunked_attention as ref_att

    def loss(q, k, v):
        return ref_att(q, k, v, causal=causal, chunk=chunk).astype(
            jnp.float32).sum()
    args = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    return jax.make_jaxpr(jax.value_and_grad(loss, argnums=(0, 1, 2)))(
        *args), args, loss


def _port_att(q, k, v, chunk, causal=True, backend="sequential"):
    def value_and_grad(p):
        raise AssertionError("traced only")
    value_and_grad.value_fn = lambda p: (attention._chunked_attention(
        p["q"], p["k"], p["v"], causal=causal, chunk=chunk).float().sum(), {})
    value_and_grad.unstacked = lambda p: p
    _NS.att = value_and_grad

    def traced(p_leaves):
        (val, _), g = _NS.att(dict(zip("qkv", p_leaves)))
        return (val, *tree.leaves(g))
    leaves = tuple(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    with cdfg.leaves(grad=[(_NS, "att")]):
        comp = dataflow_compile(traced, leaves, backend=backend,
                                device="cpu", use_cache=False)
    return comp, leaves


def _jaxpr_rows(jaxpr) -> list:
    j = jaxpr.jaxpr
    eqns = [("jit " + e.params["name"] if e.primitive.name == "jit"
             else e.primitive.name, e.invars, e.outvars) for e in j.eqns]
    return _rows(eqns, (j.invars, j.constvars), (0, 0, len(eqns)))


def _graph_rows(g) -> list:
    eqns = [("jit " + e.name if e.prim == "jit" else e.prim, e.invars,
             e.outvars) for e in g.eqns]
    return _rows(eqns, (g.invars, g.constvars), (0, 0, len(eqns)))


def test_attention_scan_equals_the_reference():
    """``value_and_grad`` of the chunked attention alone: the port's
    lowered equations are the reference's (``jax.make_jaxpr`` of
    ``repro.models.attention._chunked_attention``'s), equation by
    equation, operands and avals included — the pads, the loop
    invariants hoisted ahead of the forward scan (12 consts, 3 carries,
    15 outputs: the carries and 12 stacked residuals), the carries' zero
    tangents, the reverse scan (2 consts, 4 carries, 6 outputs) and the
    transposes after it; each scan's operand count and, for the forward,
    its body's equations too; and the values: the value and gradients
    equal the reference's (bf16 inputs: rtol 2e-2)."""
    q, k, v = _att_inputs()
    jaxpr, args, loss = _ref_att_jaxpr(q, k, v, ATT_CHUNK)
    comp, leaves = _port_att(q, k, v, ATT_CHUNK)
    ref, port = _jaxpr_rows(jaxpr), _graph_rows(comp.graph)
    assert [r[0] for r in port] == [r[0] for r in ref]
    for k_, (a, b) in enumerate(zip(port, ref)):
        if a[0] == "scan":
            a, b = a[:2], b[:2]
        assert a == b, k_
    ref_scans = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "scan"]
    port_scans = [e for e in comp.graph.eqns if e.prim == "scan"]
    for r, p in zip(ref_scans, port_scans, strict=True):
        body, n_c, n_k = p.impl.args
        assert (r.params["num_consts"], r.params["num_carry"], len(r.invars),
                len(r.outvars)) == (n_c, n_k, len(p.invars), len(p.outvars))
        assert bool(r.params["reverse"]) == p.impl.keywords.get(
            "reverse", False)
    assert [(n.params["num_consts"], n.params["num_carry"], len(n.outvars))
            for n in ref_scans] == [(12, 3, 15), (2, 4, 6)]
    fwd_ref = ref_scans[0].params["jaxpr"].jaxpr
    fwd_port = port_scans[0].impl.args[0]
    assert ([(("jit " + e.params["name"]) if e.primitive.name == "jit"
              else e.primitive.name, tuple(map(_aval, e.outvars)))
             for e in fwd_ref.eqns]
            == [(("jit " + e.name) if e.prim == "jit" else e.prim,
                 tuple(map(_aval, e.outvars))) for e in fwd_port.eqns])
    val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(*args)
    out = comp(leaves)
    torch.testing.assert_close(out[0], torch.tensor(float(val)), rtol=2e-2,
                               atol=0)
    for got, g in zip(out[1:], grads, strict=True):
        want = torch.from_numpy(np.array(g, dtype=np.float32))
        torch.testing.assert_close(got.float(), want, rtol=2e-2, atol=2e-2)


# -- a scan in a scan body, against the reference ------------------------------

#: two repeats of a body that attends in chunks of 2 over 5 positions (2
#: heads of 4): the inner scan's masks read only loop invariants
NEST_R, NEST_SHAPE, NEST_CHUNK = 2, (1, 2, 5, 4), 2


def _nested_inputs(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((NEST_R, 4, 4)).astype(np.float32) / 2
    x = rng.standard_normal(NEST_SHAPE).astype(np.float32)
    return w, x


def _nested_port(w, x):
    """``((h ** 2).sum())`` of ``h`` after the repeats ``h + att(tanh(h @
    w[r]), ·, h)`` — a ``cdfg.scan`` over ``w`` whose body holds the
    chunked attention's scan."""
    def body(consts, carry, row):
        h, = carry
        q = torch.tanh(h @ row[0])
        return (h + attention._chunked_attention(
            q, q, h, causal=True, chunk=NEST_CHUNK),), None
    (h,), _ = cdfg.scan(body, (x,), (w,))
    return (h ** 2).sum()


def test_scan_in_a_scan_equals_the_reference():
    """``value_and_grad`` of a scan whose body holds a scan with a part
    that reads only loop invariants (the chunked attention's masks): the
    port's lowered equations are ``jax.make_jaxpr(jax.value_and_grad)``'s
    of the same function, equation by equation, operands and avals
    included (a scan's operands by count) — the inner scan's invariant
    part hoisted out of both loops as a scan of its own, the forward
    scan, the reverse scan whose body holds the inner transposed scan —
    and its value and gradients ``torch.autograd``'s (rtol 1e-5); the
    transposes run the transposed bodies' equations."""
    import jax.numpy as jnp
    from repro.models.attention import _chunked_attention as ref_att
    w, x = _nested_inputs()

    def ref_f(w, x):
        def body(h, wr):
            q = jnp.tanh(h @ wr)
            return h + ref_att(q, q, h, causal=True, chunk=NEST_CHUNK), None
        h, _ = jax.lax.scan(body, x, w)
        return (h ** 2).sum()
    jaxpr = jax.make_jaxpr(jax.value_and_grad(ref_f, argnums=(0, 1)))(w, x)

    def value_and_grad(p):
        raise AssertionError("traced only")
    value_and_grad.value_fn = lambda p: (_nested_port(p["w"], p["x"]), {})
    value_and_grad.unstacked = lambda p: p
    _NS.nested = value_and_grad

    def traced(p_leaves):
        (val, _), g = _NS.nested(dict(zip("wx", p_leaves)))
        return (val, *tree.leaves(g))
    leaves = (torch.from_numpy(w), torch.from_numpy(x))
    with cdfg.leaves(grad=[(_NS, "nested")]):
        comp = dataflow_compile(traced, leaves, backend="sequential",
                                device="cpu", use_cache=False)
    ref, port = _jaxpr_rows(jaxpr), _graph_rows(comp.graph)
    assert [r[0] for r in port] == [r[0] for r in ref]
    for k, (a, b) in enumerate(zip(port, ref)):
        if a[0] == "scan":
            a, b = (*a[:2], len(a[2])), (*b[:2], len(b[2]))
        assert a == b, k
    _body_rows(jaxpr.jaxpr.eqns, comp.graph.eqns)
    scans = [e for e in comp.graph.eqns if e.prim == "scan"]
    assert len(scans) == 3
    assert all(e.impl.func is cdfg._run_loop for e in scans)
    t_body = scans[-1].impl.args[0]
    assert scans[-1].impl.keywords["reverse"]
    assert sum(e.prim == "scan" for e in t_body.eqns) == 1
    out = comp(leaves)
    p = [t.clone().requires_grad_() for t in leaves]
    want = _nested_port(*p)
    grads = torch.autograd.grad(want, p)
    torch.testing.assert_close(out[0], want.detach(), rtol=1e-5, atol=0)
    for got, g in zip(out[1:], grads, strict=True):
        torch.testing.assert_close(got, g, rtol=1e-5, atol=1e-6)


# -- a recurrent layer in a scan body, against the reference -------------------

#: two repeats of one reduced layer (the unit's first: RWKV-6's time and
#: channel mix, Jamba's Mamba mixer and dense MLP) over 2 sequences of 5
#: tokens
LAYER_R, LAYER_B, LAYER_L = 2, 2, 5


def _sorted_tree(t):
    """A reference tree's leaves as tensors, every dict's keys sorted (the
    order ``jax.tree_util`` flattens them in)."""
    if isinstance(t, dict):
        return {k: _sorted_tree(t[k]) for k in sorted(t)}
    return torch.from_numpy(np.array(t))


def _port_layer_scan(p, x, spec, cfg):
    """``(h ** 2).sum()`` of ``h`` after the repeats of ``_layer_apply``
    over the stacked leaves of ``p``: a ``cdfg.scan`` whose body holds
    the layer's recurrence (a scan of its own)."""
    def body(consts, carry, row):
        return (M.transformer._layer_apply(tree.unflatten(p, list(row)),
                                           carry[0], spec, cfg, {}),), None
    (h,), _ = cdfg.scan(body, (x,), tree.leaves(p))
    return (h ** 2).sum()


def _body_rows(jaxpr_eqns, graph_eqns, where=""):
    """The bodies nested in two equation lists, level by level: each
    ``scan``'s (and ``remat2``'s, ``closed_call``'s) body's rows equal
    (a scan's operands by count; a body's inputs numbered by first use,
    as the scans' operand order is not held), recursively."""
    def ref_body(e):
        for k in ("jaxpr", "call_jaxpr"):
            if k in e.params and e.primitive.name != "jit":
                return getattr(e.params[k], "jaxpr", e.params[k])
    subs = [(e, ref_body(e)) for e in jaxpr_eqns]
    subs = [(e, b) for e, b in subs if b is not None]
    mine = [e for e in graph_eqns if e.prim in ("scan", "remat2",
                                                "closed_call")]
    assert [e.primitive.name for e, _ in subs] == [e.prim for e in mine], \
        where
    for k, ((r, rb), p) in enumerate(zip(subs, mine)):
        pb = (p.impl.args[0] if p.prim == "scan"
              else p.params.get("jaxpr") or p.params["call_jaxpr"])
        ref = _rows([(("jit " + e.params["name"]) if e.primitive.name == "jit"
                      else e.primitive.name, e.invars, e.outvars)
                     for e in rb.eqns], ([], [*rb.invars, *rb.constvars]),
                    (0, 0, len(rb.eqns)))
        port = _rows([("jit " + e.name if e.prim == "jit" else e.prim,
                       e.invars, e.outvars) for e in pb.eqns],
                     ([], pb.invars), (0, 0, len(pb.eqns)))
        at = f"{where}/{r.primitive.name}{k}"
        assert [x[0] for x in port] == [x[0] for x in ref], at
        for i, (a, b) in enumerate(zip(port, ref)):
            if a[0] == "scan":
                a, b = (*a[:2], len(a[2])), (*b[:2], len(b[2]))
            assert a == b, (at, i)
        assert len(pb.invars) == len(rb.invars), at
        assert len(pb.outvars) == len(rb.outvars), at
        _body_rows(rb.eqns, pb.eqns, at)


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "jamba-1.5-large-398b",
                                  "jamba-1.5-large-398b+chunked"])
def test_recurrent_layer_scan_equals_the_reference(arch):
    """``value_and_grad`` of a two-repeat scan whose body is one reduced
    recurrent layer: the port's lowered equations are
    ``jax.make_jaxpr(jax.value_and_grad)``'s of the reference's layer,
    equation by equation, operands and avals included (a scan's operands
    by count) — the token shifts' and ``jit relu``'s zero tangents, the
    ``jit`` equations left with no output (``relu``, ``silu``) and ``jit
    softplus``'s hoisted part ahead of the loop, the forward scan with
    the recurrence nested in it, the reverse scan with its transposed
    scan nested — and the top-level scans' consts, carries, operands
    and outputs; the value and gradients those of ``jax.value_and_grad``
    (rtol 1e-4 + 1e-4·max|g|)."""
    import jax.numpy as jnp
    from repro.configs import reduced as ref_reduced
    from repro.models import transformer as ref_T
    arch, _, variant = arch.partition("+")
    ref_cfg, cfg = ref_reduced(ref_load_config(arch)), reduced(
        load_config(arch))
    if variant:     # the chunked Mamba scan: 2 chunks of 4 tokens
        ref_cfg, cfg = (dataclasses.replace(c, ssm=dataclasses.replace(
            c.ssm, scan_impl="chunked", chunk=4)) for c in (ref_cfg, cfg))
    ref_spec, spec = ref_cfg.segments[0].unit[0], cfg.segments[0].unit[0]
    assert spec.mixer in ("rwkv", "mamba")
    stacked = jax.tree_util.tree_map(
        lambda *r: jnp.stack(r), *(ref_T._layer_init(k, ref_spec, ref_cfg)
                                   for k in jax.random.split(
                                       jax.random.PRNGKey(0), LAYER_R)))
    x = np.random.default_rng(0).standard_normal(
        (LAYER_B, 8 if variant else LAYER_L, cfg.d_model)).astype(np.float32)

    def ref_f(p, x):
        def body(h, rp):
            return ref_T._layer_apply(rp, h, ref_spec, ref_cfg, {}), None
        h, _ = jax.lax.scan(body, x, p)
        return (h ** 2).sum()
    vg = jax.value_and_grad(ref_f, argnums=(0, 1))
    jaxpr = jax.make_jaxpr(vg)(stacked, x)
    params = {"p": _sorted_tree(stacked), "x": torch.from_numpy(x)}

    def value_and_grad(p):
        raise AssertionError("traced only")
    value_and_grad.value_fn = lambda p: (_port_layer_scan(
        p["p"], p["x"], spec, cfg), {})
    value_and_grad.unstacked = lambda p: p
    _NS.layer = value_and_grad

    def traced(p_leaves):
        (val, _), g = _NS.layer(tree.unflatten(params, list(p_leaves)))
        return (val, *tree.leaves(g))
    leaves = tuple(tree.leaves(params))
    with cdfg.leaves(grad=[(_NS, "layer")]):
        comp = dataflow_compile(traced, leaves, backend="sequential",
                                device="cpu", use_cache=False)
    ref, port = _jaxpr_rows(jaxpr), _graph_rows(comp.graph)
    assert [r[0] for r in port] == [r[0] for r in ref]
    for k, (a, b) in enumerate(zip(port, ref)):
        if a[0] == "scan":
            a, b = (*a[:2], len(a[2])), (*b[:2], len(b[2]))
        assert a == b, k
    ref_scans = [e for e in jaxpr.jaxpr.eqns if e.primitive.name == "scan"]
    port_scans = [e for e in comp.graph.eqns if e.prim == "scan"]
    for r, p in zip(ref_scans, port_scans, strict=True):
        body, n_c, n_k = p.impl.args
        assert (r.params["num_consts"], r.params["num_carry"], len(r.invars),
                len(r.outvars)) == (n_c, n_k, len(p.invars), len(p.outvars))
        assert sum(e.primitive.name == "scan"
                   for e in r.params["jaxpr"].jaxpr.eqns) == sum(
            e.prim == "scan" for e in body.eqns) == 1
    _body_rows(jaxpr.jaxpr.eqns, comp.graph.eqns)
    val, (g_p, g_x) = vg(stacked, x)
    out = comp(leaves)
    torch.testing.assert_close(out[0], torch.tensor(float(val)), rtol=1e-4,
                               atol=0)
    want = [*jax.tree_util.tree_leaves(g_p), g_x]
    for got, g in zip(out[1:], want, strict=True):
        g = torch.from_numpy(np.array(g))
        torch.testing.assert_close(got, g, rtol=1e-4,
                                   atol=1e-4 * float(g.abs().max()))


def test_remat_segment_scan_equals_the_reference():
    """``value_and_grad`` of a two-repeat scan whose body, one reduced
    SmolLM layer over 5 tokens (its attention the chunked one: a scan in
    the body), is under ``jax.checkpoint`` (``cdfg.checkpoint``): the
    port's lowered equations are ``jax.make_jaxpr(jax.value_and_grad)``'s
    equation by equation, operands and avals included (a scan's operands
    by count) — the forward scan of the primal alone (the attention's
    scan a ``closed_call``, its masks hoisted as one), its only stacked
    residual the carry, the reverse scan of one ``remat2`` equation —
    and so are the nested bodies, the ``remat2`` body (the recomputed
    primal, the residuals, the transposes) among them; the value and
    gradients those of ``jax.value_and_grad`` (rtol 1e-4 +
    1e-4·max|g|), the transposes replayed, none under autograd."""
    import jax.numpy as jnp
    from repro.configs import reduced as ref_reduced
    from repro.models import transformer as ref_T
    ref_cfg, cfg = (dataclasses.replace(c, attn_impl="chunked",
                                        dtype="float32")
                    for c in (ref_reduced(ref_load_config("smollm-135m")),
                              reduced(load_config("smollm-135m"))))
    ref_spec, spec = ref_cfg.segments[0].unit[0], cfg.segments[0].unit[0]
    stacked = jax.tree_util.tree_map(
        lambda *r: jnp.stack(r), *(ref_T._layer_init(k, ref_spec, ref_cfg)
                                   for k in jax.random.split(
                                       jax.random.PRNGKey(0), LAYER_R)))
    x = np.random.default_rng(0).standard_normal(
        (1, LAYER_L, cfg.d_model)).astype(np.float32)

    def ref_f(p, x):
        def body(h, rp):
            return ref_T._layer_apply(rp, h, ref_spec, ref_cfg, {}), None
        h, _ = jax.lax.scan(jax.checkpoint(body), x, p)
        return (h ** 2).sum()
    vg = jax.value_and_grad(ref_f, argnums=(0, 1))
    jaxpr = jax.make_jaxpr(vg)(stacked, x)
    params = {"p": _sorted_tree(stacked), "x": torch.from_numpy(x)}

    def port_f(p, x):
        def body(consts, carry, row):
            return (M.transformer._layer_apply(tree.unflatten(p, list(row)),
                                               carry[0], spec, cfg, {}),), None
        (h,), _ = cdfg.scan(cdfg.checkpoint(body), (x,), tree.leaves(p))
        return (h ** 2).sum()

    def value_and_grad(p):
        raise AssertionError("traced only")
    value_and_grad.value_fn = lambda p: (port_f(p["p"], p["x"]), {})
    value_and_grad.unstacked = lambda p: p
    _NS.remat = value_and_grad

    def traced(p_leaves):
        (val, _), g = _NS.remat(tree.unflatten(params, list(p_leaves)))
        return (val, *tree.leaves(g))
    leaves = tuple(tree.leaves(params))
    with cdfg.leaves(grad=[(_NS, "remat")]):
        comp = dataflow_compile(traced, leaves, backend="sequential",
                                device="cpu", use_cache=False)
    ref, port = _jaxpr_rows(jaxpr), _graph_rows(comp.graph)
    assert [r[0] for r in port] == [r[0] for r in ref]
    for k, (a, b) in enumerate(zip(port, ref)):
        if a[0] == "scan":
            a, b = (*a[:2], len(a[2])), (*b[:2], len(b[2]))
        assert a == b, k
    _body_rows(jaxpr.jaxpr.eqns, comp.graph.eqns)
    scans = [e for e in comp.graph.eqns if e.prim == "scan"]
    assert [q.prim for q in scans[-1].impl.args[0].eqns] == ["remat2"]
    _no_autograd_transpose(comp.graph)
    val, (g_p, g_x) = vg(stacked, x)
    out = comp(leaves)
    torch.testing.assert_close(out[0], torch.tensor(float(val)), rtol=1e-4,
                               atol=0)
    want = [*jax.tree_util.tree_leaves(g_p), g_x]
    for got, g in zip(out[1:], want, strict=True):
        g = torch.from_numpy(np.array(g))
        torch.testing.assert_close(got, g, rtol=1e-4,
                                   atol=1e-4 * float(g.abs().max()))


def _loop_rwkv_scan(rh, kh, vh, wh, u):
    """The WKV recurrence as a Python loop over time (the port's before
    it was a ``cdfg.scan``)."""
    B, _, H, hd = rh.shape
    S = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=rh.device)
    ys = []
    for r_t, k_t, v_t, w_t in zip(rh.unbind(1), kh.unbind(1), vh.unbind(1),
                                  wh.unbind(1)):
        y, S = ssm._rwkv_step(r_t, k_t, v_t, w_t, u, S)
        ys.append(y)
    return torch.stack(ys, dim=1), S


def _loop_selective_scan(dt, A, Bc, Cc, x):
    """Mamba's sequential scan as a Python loop over time (the port's
    before it was a ``cdfg.scan``)."""
    B, _, dI = x.shape
    h = torch.zeros((B, dI, A.shape[1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for dt_t, x_t, b_t, c_t in zip(dt.unbind(1), x.unbind(1), Bc.unbind(1),
                                   Cc.unbind(1)):
        y, h = ssm._selective_step(dt_t, A, b_t, c_t, x_t, h)
        ys.append(y)
    return torch.stack(ys, dim=1), h


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recurrences_on_tensors_equal_the_loop(dtype, monkeypatch):
    """``ssm.rwkv6_apply`` and ``ssm.mamba_apply`` (the sequential scan,
    and the chunked one over 3 chunks of 4) of the reduced RWKV-6's and
    Jamba's layers on tensors, output and cache, equal bit for bit what
    they give with the recurrence a Python loop over time (over chunks),
    in fp32 and bf16; each scan's outputs also in the loop's memory
    layout (a strided output would send the next product to another
    GEMM on the card, which rounds otherwise)."""
    g = torch.Generator().manual_seed(2)
    B, L, H, hd, N = 3, 7, 2, 4, 5
    r, k, v = (torch.randn((B, L, H, hd), generator=g) for _ in range(3))
    w, u = torch.rand((B, L, H, hd), generator=g), torch.randn((H, hd),
                                                               generator=g)
    dt, x = torch.rand((B, L, H * hd), generator=g), torch.randn(
        (B, L, H * hd), generator=g)
    A = -torch.rand((H * hd, N), generator=g)
    Bc, Cc = (torch.randn((B, L, N), generator=g) for _ in range(2))
    for got, want in ((ssm._rwkv_scan(r, k, v, w, u),
                       _loop_rwkv_scan(r, k, v, w, u)),
                      (ssm._selective_scan_seq(dt, A, Bc, Cc, x),
                       _loop_selective_scan(dt, A, Bc, Cc, x)),
                      (ssm._selective_scan_chunked(
                          dt[:, :6], A, Bc[:, :6], Cc[:, :6], x[:, :6], 3),
                       _chip_smoke().mamba_chunked_loop(
                           dt[:, :6], A, Bc[:, :6], Cc[:, :6], x[:, :6], 3))):
        for a, b in zip(got, want, strict=True):
            assert torch.equal(a, b) and a.stride() == b.stride()
    seen = set()
    for arch in ("rwkv6-1.6b", "jamba-1.5-large-398b",
                 "jamba-1.5-large-398b+chunked"):
        arch, _, variant = arch.partition("+")
        cfg = dataclasses.replace(reduced(load_config(arch)), dtype=dtype)
        if variant:
            cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
                cfg.ssm, scan_impl="chunked", chunk=4))
        params = M.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        x = torch.randn((3, 12 if variant else 7, cfg.d_model),
                        generator=torch.Generator().manual_seed(1)).to(
                            cfg.torch_dtype)
        for spec, layer in zip(cfg.segments[0].unit,
                               params["segment_0"][0]):
            if spec.mixer not in ("rwkv", "mamba"):
                continue
            fn, name, loop = ((ssm.rwkv6_apply, "_rwkv_scan", _loop_rwkv_scan)
                              if spec.mixer == "rwkv" else
                              (ssm.mamba_apply, "_selective_scan_chunked",
                               _chip_smoke().mamba_chunked_loop) if variant
                              else
                              (ssm.mamba_apply, "_selective_scan_seq",
                               _loop_selective_scan))
            got = fn(layer["mixer"], x, cfg, return_cache=True)
            with monkeypatch.context() as m:
                m.setattr(ssm, name, loop)
                want = fn(layer["mixer"], x, cfg, return_cache=True)
            for a, b in zip(tree.leaves(got), tree.leaves(want), strict=True):
                assert a.dtype == b.dtype and torch.equal(a, b), spec.mixer
            seen.add(spec.mixer + variant)
    assert seen == {"rwkv", "mamba", "mambachunked"}


# -- edge inputs of the new lowering, against the reference --------------------

def test_top_k_ties_keep_the_lower_index_first():
    """``moe._top_k`` and its lowered ``top_k`` on rows full of ties (and
    a row all equal): values and indices ``jax.lax.top_k``'s, the lower
    index first among equal values."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, 3, (6, 9)).astype(np.float32)
    x[0] = 1.0
    vals, idx = jax.lax.top_k(x, 4)
    got = moe._top_k(torch.from_numpy(x), 4)
    def top4(t):
        got = moe._top_k(t, 4)
        return got[0], got[1]
    comp = dataflow_compile(top4, torch.from_numpy(x),
                            backend="sequential", device="cpu",
                            use_cache=False)
    assert [e.prim for e in comp.graph.eqns] == ["top_k"]
    for a, b in (got, comp(torch.from_numpy(x))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(vals))
        np.testing.assert_array_equal(b.numpy(), np.asarray(idx))
        assert b.dtype == torch.int32


def test_scatter_add_drops_slots_at_and_past_the_end():
    """``cdfg.at_add`` (the MoE dispatch's ``x.at[slot].add(src)``) on
    slots at and past ``E·cap`` rows, a negative slot that wraps and one
    still out of range after the wrap: the out-of-range rows are dropped,
    as the reference's ``scatter-add``; the same through its lowering
    (five equations, one ``scatter-add``), and the gradient of a loss
    through it (its transpose gathers, out-of-range rows reading 0)
    equal to ``jax.grad``'s."""
    import jax.numpy as jnp
    n, d = 6, 3
    rng = np.random.default_rng(2)
    idx = np.array([5, 6, 0, 9, -1, -7, 5, 2], np.int32)
    src = rng.standard_normal((len(idx), d)).astype(np.float32)
    base = rng.standard_normal((n, d)).astype(np.float32)
    want = np.asarray(jnp.asarray(base).at[idx].add(src))
    got = cdfg.at_add(torch.from_numpy(base), torch.from_numpy(idx),
                      torch.from_numpy(src))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    comp = dataflow_compile(cdfg.at_add, torch.from_numpy(base),
                            torch.from_numpy(idx), torch.from_numpy(src),
                            backend="sequential", device="cpu",
                            use_cache=False)
    assert [e.prim for e in comp.graph.eqns] == [
        "lt", "add", "select_n", "broadcast_in_dim", "scatter-add"]
    np.testing.assert_allclose(comp(*(torch.from_numpy(a) for a in (
        base, idx, src))).numpy(), want, rtol=1e-6)

    def ref_loss(b, s):
        return (b.at[idx].add(s) ** 2).sum()
    ref_g = jax.grad(ref_loss, argnums=(0, 1))(jnp.asarray(base),
                                               jnp.asarray(src))
    fn, params = (lambda p, x, i: (cdfg.at_add(p["b"], i, p["s"]) ** 2).sum(),
                  {"b": torch.from_numpy(base), "s": torch.from_numpy(src)})

    def value_and_grad(p, *args):
        raise AssertionError("traced only")
    value_and_grad.value_fn = lambda p, i: (fn(p, None, i), {})
    value_and_grad.unstacked = lambda p, *args: p
    _NS.at_grad = value_and_grad

    def traced(p_leaves, i):
        (val, _), g = _NS.at_grad(dict(zip("bs", p_leaves)), i)
        return (val, *tree.leaves(g))
    with cdfg.leaves(grad=[(_NS, "at_grad")]):
        comp = dataflow_compile(traced, tuple(params.values()),
                                torch.from_numpy(idx), backend="sequential",
                                device="cpu", use_cache=False)
    out = comp(tuple(params.values()), torch.from_numpy(idx))
    for got, g in zip(out[1:], ref_g, strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(g), rtol=1e-5,
                                   atol=1e-6)


def test_all_masked_causal_row_in_a_padded_last_chunk():
    """5 keys in chunks of 4: the last chunk holds key 4 and 3 padded
    keys, so queries 0-3 see none of it (every entry masked).  The
    port's chunked attention on tensors, and the value and gradients of
    its lowered ``value_and_grad``, equal the reference's (rtol 2e-2,
    bf16)."""
    q, k, v = _att_inputs(seed=3)
    jaxpr, args, loss = _ref_att_jaxpr(q, k, v, 4)
    from repro.models.attention import _chunked_attention as ref_att
    want = np.asarray(ref_att(*args, causal=True, chunk=4).astype(
        np.float32))
    leaves = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = attention._chunked_attention(*leaves, causal=True, chunk=4)
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), torch.from_numpy(want),
                               rtol=2e-2, atol=2e-2)
    comp, leaves = _port_att(q, k, v, 4)
    val, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(*args)
    out = comp(leaves)
    torch.testing.assert_close(out[0], torch.tensor(float(val)), rtol=2e-2,
                               atol=0)
    for got, g in zip(out[1:], grads, strict=True):
        assert torch.isfinite(got.float()).all()
        torch.testing.assert_close(
            got.float(), torch.from_numpy(np.array(g, dtype=np.float32)),
            rtol=2e-2, atol=2e-2)
