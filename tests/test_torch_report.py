"""The decode-step dataflow report (``BatchedServer.dataflow_report``)
against the reference's, on all ten architectures.

Both servers are built on abstract parameters — the reference's
``jax.eval_shape`` of its init, the port's ``init_params(None, cfg,
"meta")`` — at the reduced configs (batch 2, ``max_len`` 32) and at full
width (batch 8, ``max_len`` 552).  The comparison is exact on what
Algorithm 1 decides: the header's op, stage, channel and byte counts,
the pipeline line, every stage line (ops, II, latency, channel bytes,
flags, regions) and the verifier's findings.  The pass times, the
``backend=`` / ``device=`` fields and the verifier's hint text are left
out (``chip_smoke.report_key``).  ``chip_smoke.REF_REPORTS``, which phase
12a holds the card's reports to, must be the reference's full-width
reports.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
import repro_torch
from repro.configs import load_config as ref_load_config
from repro.configs import reduced as ref_reduced
from repro.launch.serve import BatchedServer as RefServer
from repro.launch.serve import Request as RefRequest
from repro.models import init_params as ref_init_params
from repro_torch import tree
from repro_torch.configs import ARCH_IDS, load_config, reduced
from repro_torch.kernels import _lib
from repro_torch.launch import serve as port_serve
from repro_torch.models import decode_step, init_params, prefill

SIZES = {"reduced": (2, 32), "full": (8, 552)}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    repro_torch.set_device("cpu")
    _lib.reset_counts()
    yield
    repro_torch.set_device(None)


def _ref_report(arch: str, size: str, batch: int | None = None) -> str:
    cfg = ref_load_config(arch)
    if size == "reduced":
        cfg = ref_reduced(cfg)
    B, max_len = SIZES[size]
    params = jax.eval_shape(lambda: ref_init_params(jax.random.PRNGKey(0),
                                                    cfg))
    reqs = [RefRequest(i, np.zeros(4, np.int32), 2)
            for i in range(B if batch is None else batch)]
    return RefServer(cfg, params, max_len=max_len).dataflow_report(reqs)


def _port_report(arch: str, size: str, batch: int | None = None) -> str:
    cfg = load_config(arch)
    if size == "reduced":
        cfg = reduced(cfg)
    B, max_len = SIZES[size]
    reqs = [port_serve.Request(i, np.zeros(4, np.int32), 2)
            for i in range(B if batch is None else batch)]
    return port_serve.BatchedServer(
        cfg, init_params(None, cfg, "meta"), max_len=max_len
    ).dataflow_report(reqs)


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_report_is_the_reference(arch, size):
    want = _ref_report(arch, size)
    got = _port_report(arch, size)
    assert want.startswith("dataflow program:"), want
    assert chip_smoke.report_key(got) == chip_smoke.report_key(want)
    assert "backend='eager', device=meta" in got.splitlines()[0]


def test_chip_smoke_reports_are_the_reference():
    """Phase 12a's constants: the reference's full-width reports."""
    assert set(chip_smoke.REF_REPORTS) == set(ARCH_IDS)
    for arch in ARCH_IDS:
        assert chip_smoke.REF_REPORTS[arch] == chip_smoke.report_key(
            _ref_report(arch, "full")), arch


def test_empty_request_list_is_unavailable():
    """With no request the reference's analysis fails and says so; so
    does the port's, without raising."""
    assert _ref_report("smollm-135m", "reduced", batch=0).startswith(
        "(dataflow analysis unavailable:")
    got = _port_report("smollm-135m", "reduced", batch=0)
    assert got.startswith("(dataflow analysis unavailable: ValueError:")


def test_report_of_served_params_reads_no_weight_and_launches_nothing():
    """On the served (real) parameters the report is the abstract one's:
    the trace runs on ``meta`` copies, so the params are left alone and
    no kernel is launched; serving afterwards is unchanged."""
    cfg = reduced(load_config("smollm-135m"))
    params = init_params(torch.Generator().manual_seed(0), cfg)
    before = tree.tree_map(torch.clone, params)
    server = port_serve.BatchedServer(cfg, params, max_len=32)
    reqs = [port_serve.Request(i, np.arange(1, 5, dtype=np.int32) + i, 3)
            for i in range(2)]
    got = server.dataflow_report(reqs)
    assert chip_smoke.report_key(got) == chip_smoke.report_key(
        _port_report("smollm-135m", "reduced"))
    assert sum(_lib.counts().values()) == 0
    for a, b in zip(tree.leaves(params), tree.leaves(before)):
        assert torch.equal(a, b)
    assert [r.tokens for r in server.serve(reqs)] == [
        r.tokens for r in port_serve.BatchedServer(
            cfg, params, max_len=32).serve(reqs)]


def test_reference_order_numbers_leaves_as_jax():
    """``reference_order`` lists the leaves as ``jax`` flattens the
    reference's tree (dict keys sorted, a segment's repeats stacked): the
    port's leaf names in that order, repeats dropped, are the reference's
    leaf names in order, each once per repeat."""
    for arch in ("smollm-135m", "deepseek-v3-671b", "jamba-1.5-large-398b"):
        ref_cfg = ref_reduced(ref_load_config(arch))
        cfg = reduced(load_config(arch))
        abstract = jax.eval_shape(
            lambda: ref_init_params(jax.random.PRNGKey(0), ref_cfg))
        want = [jax.tree_util.keystr(p) for p, _ in
                jax.tree_util.tree_flatten_with_path(abstract)[0]]
        order = port_serve.reference_order(init_params(None, cfg, "meta"))
        names = []
        for path in order:
            key, rest = path[0], path[1:]
            if key.startswith("segment_"):
                rest = rest[1:]
            name = "".join(f"[{k!r}]" for k in (key, *rest))
            if not names or names[-1] != name:
                names.append(name)
        assert names == want, arch
        assert order[0] == ("embed", "table")


def test_traced_scan_runs_the_segments():
    """The lowered program runs: its ``scan`` equation calls the
    segment's loop, and the stage programs give ``decode_step``'s logits
    on the reduced model (1e-5)."""
    from repro_torch.dataflow import compile as dataflow_compile
    from repro_torch.launch.serve import decode_step_leaves
    cfg = reduced(load_config("smollm-135m"))
    params = init_params(torch.Generator().manual_seed(0), cfg)
    tokens = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    _, cache = prefill(params, tokens, cfg, 16)
    token = torch.tensor([3, 7], dtype=torch.int32)

    def step(p, tok, c):
        return decode_step(p, tok, c, 4, cfg)[0]

    leaves_p = tuple(tree.leaves(params))
    leaves_c = tuple(tree.leaves(cache))

    def flat(p_leaves, tok, c_leaves):
        p = tree.unflatten(params, list(p_leaves))
        c = tree.unflatten(cache, list(c_leaves))
        return step(p, tok, c)

    with decode_step_leaves():
        compiled = dataflow_compile(flat, leaves_p, token, leaves_c,
                                    device="cpu", use_cache=False)
    assert [s.prims for s in compiled.schedule.stages][1] == ("scan",)
    want = step(params, token, tree.tree_map(torch.clone, cache))
    got = compiled(leaves_p, token,
                   tuple(torch.clone(t) for t in leaves_c),
                   backend="sequential")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
