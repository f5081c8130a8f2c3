"""The train cells' dataflow census (``launch/dryrun.train_compiled``,
``core/autodiff.py``) against the reference's, on the CPU.

The reference's train step (``make_train_step(cfg, AdamWConfig())`` on
the abstract train state, ``value_and_grad`` and AdamW inlined) is
compiled by ``repro.dataflow`` at ``train_4k`` and published widths; the
port's by ``train_compiled``.  Both equation lists split into four
sections: (1) what comes before the first forward ``scan`` (the token
slices and the embedding's read), (2) from there to the last forward
``scan``, (3) the loss tail and the backward, (4) the schedule and
AdamW (from the first equation that reads the step).  Sections 1, 3 and
4 must be equal equation by equation — primitive, ``jit`` name, output
avals, and where each operand comes from.  Section 2 differs by design
(ROADMAP "Decisions", route (b)): the reference's partial evaluation
hoists the segment body's loop invariants out of the scan; the port
emits the forward ``scan`` alone.  ``chip_smoke.TRAIN_SECTION2`` pins
both sides' section 2 and the census difference that follows from it,
and ``REF_TRAIN_CENSUS`` the reference's census of all ten
architectures.  DeepSeek-V3's section 3 also holds its MTP head's layer,
which the port lowers as one ``checkpoint`` equation each way (ROADMAP
"Decisions"): ``chip_smoke.TRAIN_MTP_LAYER`` pins the reference's
windows of that layer's equations and their census difference, and the
rest of section 3 is equal equation by equation around them.

The lowered step also runs: on a reduced SmolLM through the
``sequential`` backend, its gradients, loss, metrics, params and
moments are those of ``steps.loss_and_grads`` / ``make_train_step``;
and each JVP rule's transpose is held to ``torch.autograd`` on a small
input.
"""

import difflib
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
from repro.core.cdfg import LatencyModel as RefLatencyModel
from repro.core.cdfg import MEMORY_PRIMITIVES as REF_MEMORY
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
from repro_torch.models import layers, model as M
from repro_torch.optim import adamw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: the architectures held section by section, one for each mechanism:
#: tied embeddings and RMSNorm; LayerNorm (``jit _var``); embeddings in
#: (a zero carry tangent, an unread ``embed``); stacked leaves the body
#: never reads (Command-R's ``ln2``); the MoE load balance's cotangent
#: into the scan's ``ys``; the MTP head (a ``checkpoint`` layer, a
#: ``concatenate``, a dense segment's constant ``ys``)
SECTION_ARCHS = ("smollm-135m", "olmo-1b", "musicgen-large",
                 "command-r-plus-104b", "llama4-scout-17b-a16e",
                 "deepseek-v3-671b")
_FIELDS = ("ops", "memory_ops", "long_ops", "stages", "channels",
           "pipeline_ii")


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
    """``dryrun.census_of`` less ``channel_bytes`` (of either package's
    ``Compiled``)."""
    return {k: v for k, v in dryrun.census_of(compiled).items()
            if k != "channel_bytes"}


@functools.lru_cache(maxsize=None)
def _ref(arch: str) -> tuple:
    """The reference's census, equations and step input (as
    ``dataflow_census`` compiles it)."""
    cfg = ref_load_config(arch)
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
def _port(arch: str) -> tuple:
    cfg = load_config(arch)
    c = dryrun.train_compiled(cfg, "train_4k")
    g = c.graph
    step_in = g.invars[-(2 if cfg.frontend_stub else 1) - 1]
    eqns = [("jit " + e.name if e.prim == "jit" else e.prim, e.invars,
             e.outvars) for e in g.eqns]
    return _census(c), eqns, (g.invars, g.constvars), \
        step_in


def _sections(eqns: list, step_in, s1: int | None) -> tuple[int, int, int]:
    """(end of section 1, end of section 2, start of section 4).  Section
    1 ends at the first forward ``scan`` of the port's, whose section 2
    starts with its forward scan (the reference's with hoisted loop
    invariants and other scans): ``s1`` gives the port's end to the
    reference."""
    names = [n for n, _, _ in eqns]
    fwd = [i for i in range(names.index("jit log_softmax"))
           if names[i] == "scan"]
    s4 = next(i for i, (_, ins, _) in enumerate(eqns)
              if any(v is step_in for v in ins))
    return fwd[0] if s1 is None else s1, fwd[-1] + 1, s4


def _aval(v) -> tuple:
    dt = str(v.aval.dtype).replace("torch.", "")
    return tuple(v.aval.shape), dt


def _rows(eqns: list, inputs: tuple, bounds: tuple) -> list:
    """Each equation as (name, output avals, operand origins): an input's
    or a constant's index, a literal's fp32 value, or (section, offset,
    output) of the
    equation that made it — section 2's equations, which differ by
    design, only as (2, the output's place among the last forward
    scan's)."""
    s1, s2, s4 = bounds
    invars, constvars = inputs
    where = {v: ("in", i) for i, v in enumerate(invars)}
    where.update({v: ("const", i) for i, v in enumerate(constvars)})
    rows = []
    for k, (name, ins, outs) in enumerate(eqns):
        ops = []
        for v in ins:
            if type(v).__name__ == "Literal":
                ops.append(("lit", float(np.float32(np.asarray(v.val)))))
            else:
                ops.append(where[v])
        rows.append((name, tuple(map(_aval, outs)), tuple(ops)))
        for o, v in enumerate(outs):
            if k < s1:
                where[v] = (1, k, o)
            elif k < s2:
                where[v] = (2, o if k == s2 - 1 else None)
            elif k < s4:
                where[v] = (3, k - s2, o)
            else:
                where[v] = (4, k - s4, o)
    return rows


def _split(arch: str, side, s1: int | None = None) -> tuple:
    """The census and the four sections' rows of ``side(arch)``."""
    census, eqns, inputs, step_in = side(arch)
    bounds = _sections(eqns, step_in, s1)
    rows = _rows(eqns, inputs, bounds)
    s1, s2, s4 = bounds
    return census, rows[:s1], rows[s1:s2], rows[s2:s4], rows[s4:]


def _long(rows: list) -> int:
    lm = RefLatencyModel()
    return sum(lm.is_long(name.split()[0]) for name, _, _ in rows)


def _windows(port3: list, ref3: list) -> tuple[dict, list]:
    """Section 3 of both sides aligned: the port's row index → the
    reference's, and the reference's windows (start, end) that the
    port's ``checkpoint`` rows (or nothing) stand for — the MTP layer's
    forward, the zero tangents of its scan's carries, its transpose."""
    names = [(r[0], r[1]) for r in port3]
    sm = difflib.SequenceMatcher(None, names, [(r[0], r[1]) for r in ref3],
                                 autojunk=False)
    at, windows = {}, []
    for op, i0, i1, j0, j1 in sm.get_opcodes():
        if op == "equal":
            at.update(zip(range(i0, i1), range(j0, j1)))
            continue
        assert op in ("replace", "insert"), (op, names[i0:i1])
        assert [n for n, _ in names[i0:i1]] in ([], ["checkpoint"])
        windows.append((j0, j1))
    return at, windows


def _relocate(rows: list, s3: dict) -> list:
    """``rows`` with each operand made in section 3 at index ``k``
    renamed by ``s3``: its place on the other side, or ``"mtp"`` for a
    value of the MTP layer's windows."""
    def where(o):
        if len(o) == 3 and o[0] == 3:
            k = s3.get(o[1])
            return "mtp" if k is None else (3, k, o[2])
        return o
    return [(n, av, tuple(map(where, ops))) for n, av, ops in rows]


@pytest.mark.parametrize("arch", SECTION_ARCHS)
def test_train_census_sections_equal_the_reference(arch):
    """Sections 1, 3 and 4 equal equation by equation (the transposed
    scan's operands excepted: the reference's read section 2's hoisted
    values; DeepSeek-V3's MTP layer as its pinned windows); section 2
    as pinned; the census equal to the reference's less the pinned
    differences."""
    cs = _chip_smoke()
    census, *port = _split(arch, _port)
    ref_census, *ref = _split(arch, _ref, len(port[0]))
    at, windows = _windows(port[2], ref[2])
    inside = [r for a, b in windows for r in ref[2][a:b]]
    kept = [k for k in range(len(ref[2]))
            if not any(a <= k < b for a, b in windows)]
    port[2:] = [_relocate(rows, at) for rows in port[2:]]
    ref[2:] = [_relocate(rows, {k: k for k in kept}) for rows in ref[2:]]
    ref[2] = [ref[2][k] for k in kept]
    ckpts = sum(r[0] == "checkpoint" for r in port[2])
    port[2] = [r for r in port[2] if r[0] != "checkpoint"]
    for sec in (0, 2, 3):
        assert len(port[sec]) == len(ref[sec]), (arch, sec + 1)
        for k, (a, b) in enumerate(zip(port[sec], ref[sec])):
            if a[0] == "scan":
                a, b = a[:2], b[:2]
            assert a == b, (arch, sec + 1, k)
    # the port's section 2: each segment's forward scan (and what reads
    # one segment's ys before the next: DeepSeek-V3's load balance)
    scans = [k for k, r in enumerate(port[1]) if r[0] == "scan"]
    assert len(scans) == len(load_config(arch).segments)
    assert scans[0] == 0 and scans[-1] == len(port[1]) - 1
    n_ref, n_port, diff = cs.TRAIN_SECTION2[arch]
    assert (len(ref[1]), len(port[1])) == (n_ref, n_port)
    # the census difference follows from section 2 and the MTP windows
    assert diff["ops"] == n_ref - n_port
    assert diff["long_ops"] == _long(ref[1]) - _long(port[1])
    assert diff["stages"] == diff["long_ops"]
    sizes, n_ckpt, mtp = cs.TRAIN_MTP_LAYER.get(arch, ((), 0, {}))
    assert tuple(b - a for a, b in windows) == sizes
    assert n_ckpt == ckpts
    if sizes:
        assert mtp["ops"] == len(inside) - n_ckpt
        assert mtp["long_ops"] == mtp["stages"] == _long(inside)
        assert mtp["memory_ops"] == sum(n.split()[0] in REF_MEMORY
                                        for n, _, _ in inside)
    total = {k: diff.get(k, 0) + mtp.get(k, 0) for k in {*diff, *mtp}}
    assert {k: ref_census[k] - census[k] for k in total} == total
    assert census["pipeline_ii"] == ref_census["pipeline_ii"]
    if "memory_ops" not in total:
        assert census["memory_ops"] == ref_census["memory_ops"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_pinned_train_census_is_the_live_reference(arch):
    """``chip_smoke.REF_TRAIN_CENSUS`` (all ten) is the live reference's
    census, and the pinned differences (``TRAIN_SECTION2``, and
    ``TRAIN_MTP_LAYER`` for DeepSeek-V3) give the port's census from
    it."""
    cs = _chip_smoke()
    ref_census, eqns, _, step_in = _ref(arch)
    assert cs.REF_TRAIN_CENSUS[arch] == ref_census
    census, s1, *_ = _split(arch, _port)
    n_ref, n_port, _ = cs.TRAIN_SECTION2[arch]
    s1, s2, _ = _sections(eqns, step_in, len(s1))
    assert s2 - s1 == n_ref
    diff = cs.train_census_difference(arch)
    assert {k: census[k] + diff.get(k, 0) for k in _FIELDS} == ref_census


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


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v3-671b"])
def test_lowered_grads_equal_loss_and_grads(arch):
    """The ``grad`` leaf alone, lowered and run by the ``sequential``
    backend on a reduced SmolLM and a reduced DeepSeek-V3 (MLA, MoE, its
    MTP layer a ``checkpoint``): loss, metrics and every gradient leaf
    (stacked) those of ``steps.loss_and_grads`` (autograd) — loss rtol
    1e-4, grads rtol 1e-4 + 1e-4·max|g| (PERF.md §2)."""
    cfg, params, batches = _smollm(arch)
    stacked = M.transformer.stack_repeats(params)

    def value_and_grads(p_leaves, b_leaves):
        (loss, metrics), grads = steps.loss_and_grads(
            tree.unflatten(stacked, list(p_leaves)),
            tree.unflatten(batches[0], list(b_leaves)), cfg)
        return (loss, *tree.leaves(metrics), *tree.leaves(grads))

    with cdfg.leaves(index=[(layers, "take")],
                     scan=[(M.transformer, "_segment_forward")],
                     grad=[(steps, "loss_and_grads")],
                     remat=[(M, "_mtp_layer")]):
        comp = dataflow_compile(value_and_grads, tuple(tree.leaves(stacked)),
                                tuple(tree.leaves(batches[0])),
                                backend="sequential", device="cpu",
                                use_cache=False)
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


def _toy_segment(x, seg_params, state=(), *, k):
    """A segment's repeats (a scan leaf): a tanh layer, and each repeat's
    mean square as its ``ys``; ``v`` is never read."""
    ys = []
    for rep in seg_params:
        x = torch.tanh(x @ rep[0]["w"]) * k
        ys.append((x * x).mean()[None])
    return x, torch.cat(ys)


_toy_segment.scan_ys = lambda consts, **_: torch.empty(
    len(consts), device="meta")
_NS.segment = _toy_segment


def _toy_layer(params, x):
    """A layer (a remat leaf): ``z`` is never read."""
    return torch.tanh(x @ params["w"]) + x


_NS.layer = _toy_layer


def _rng(*shape, seed=0):
    g = torch.Generator().manual_seed(seed + 7 * len(shape))
    return torch.rand(*shape, generator=g) + 0.5


_IDX = torch.tensor([3, 0, 5], dtype=torch.int32)

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
    "div": (lambda p, x, i: (p["w"] / x).sum(), {"w": _rng(3, 4)}),
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
    "checkpoint": (lambda p, x, i: (_NS.layer(p["layer"], x * p["v"])
                                    * x).sum(),
                   {"layer": {"w": _rng(4, 4) / 4, "z": _rng(2)},
                    "v": _rng(3, 4, seed=1)}),
    "scan": (lambda p, x, i: (lambda y, ys: y.sum() + 3 * ys.sum())(
        *_NS.segment(x, p["segment_0"], (), k=1.5)),
        {"segment_0": [{"v": _rng(3, 4), "w": _rng(3, 4, 4, seed=2)
                        / 4}]}),
}


def _unstacked(p, *args):
    if "segment_0" not in p:
        return p
    return {"segment_0": [tree.tree_map(lambda t, r=r: t[r], p["segment_0"])
                          for r in range(3)]}


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
    value_and_grad.unstacked = _unstacked
    _NS.grad = value_and_grad

    def traced(p_leaves, x, idx):
        (v, _), g = _NS.grad(tree.unflatten(params, list(p_leaves)), x, idx)
        return (v, *tree.leaves(g))

    with cdfg.leaves(index=[(layers, "take")], scan=[(_NS, "segment")],
                     grad=[(_NS, "grad")], remat=[(_NS, "layer")]):
        comp = dataflow_compile(traced, tuple(tree.leaves(params)), x, _IDX,
                                backend="sequential", device="cpu",
                                use_cache=False)
    out = comp(tuple(tree.leaves(params)), x, _IDX)
    leaves = [t.detach().clone().requires_grad_() for t in
              tree.leaves(params)]
    want = fn(_unstacked(tree.unflatten(params, leaves)), x, _IDX)
    grads = torch.autograd.grad(want, leaves, allow_unused=True)
    torch.testing.assert_close(out[0], want.detach(), rtol=1e-5, atol=1e-6)
    for got, g, p in zip(out[1:], grads, leaves, strict=True):
        torch.testing.assert_close(
            got, torch.zeros_like(p) if g is None else g, rtol=1e-5,
            atol=1e-6)
