"""The port's analytic cost model (``repro_torch.runtime.cost_model``)
against the reference's (``repro.runtime.cost_model``).

The module reads the model configs only, so the port's copy must give
the reference's numbers exactly: ``cost_for_cell`` on every config and
input shape, field for field (no tolerance), and the reference's own
unit tests (``tests/test_cost_model.py``), each knob moving exactly the
term it targets, on the port's configs.
"""

import dataclasses

import pytest

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import load_config as ref_load_config
from repro.runtime import cost_model as ref_cost_model
from repro_torch.configs import ARCH_IDS, SHAPES, load_config
from repro_torch.runtime import cost_model
from repro_torch.runtime.cost_model import (ShardingAssumptions,
                                            cost_for_cell, step_cost)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cost_for_cell_is_the_reference(arch, shape):
    """Every cell of the ten configs × the four input shapes: the same
    flops, HBM bytes, collective bytes and breakdown, and the same
    roofline, exactly."""
    got = cost_for_cell(load_config(arch), SHAPES[shape])
    want = ref_cost_model.cost_for_cell(ref_load_config(arch),
                                        REF_SHAPES[shape])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.roofline() == want.roofline()


def test_module_is_the_reference_one():
    """The copy's public names are the reference's."""
    names = {n for n in dir(ref_cost_model) if not n.startswith("_")}
    assert names <= set(dir(cost_model))


# -- the reference's unit tests, on the port ---------------------------------

def _sh(**kw):
    base = dict(dp=16, tp=16)
    base.update(kw)
    return ShardingAssumptions(**base)


def test_train_flops_match_6nd_dense():
    cfg = load_config("olmo-1b")
    c = step_cost(cfg, SHAPES["train_4k"], _sh())
    model = 6 * cfg.param_count() * 256 * 4096 / 256
    assert 0.5 < c.flops / model < 2.5


def test_moe_flops_use_active_params():
    cfg = load_config("deepseek-v3-671b")
    c = step_cost(cfg, SHAPES["train_4k"], _sh())
    active = 6 * cfg.active_param_count() * 256 * 4096 / 256
    total = 6 * cfg.param_count() * 256 * 4096 / 256
    assert c.flops < 0.5 * total        # NOT charged for all experts
    assert c.flops > 0.5 * active       # but at least the active ones


def test_int8_kv_halves_cache_term():
    cfg = load_config("qwen2.5-14b")
    bf = step_cost(cfg, SHAPES["decode_32k"], _sh(fsdp_params=False))
    q8 = step_cost(cfg, SHAPES["decode_32k"], _sh(fsdp_params=False,
                                                  kv_bytes=1))
    assert q8.breakdown["cache_bytes_chip"] == pytest.approx(
        bf.breakdown["cache_bytes_chip"] / 2)
    assert q8.hbm_bytes < bf.hbm_bytes


def test_int8_a2a_halves_dispatch_term():
    cfg = load_config("deepseek-v3-671b")
    bf = step_cost(cfg, SHAPES["train_4k"], _sh())
    q8 = step_cost(cfg, SHAPES["train_4k"], _sh(a2a_bytes=1))
    assert q8.breakdown["moe_a2a_bytes"] == pytest.approx(
        bf.breakdown["moe_a2a_bytes"] / 2)


def test_seq_parallel_halves_tp_ar():
    cfg = load_config("qwen2.5-14b")
    bf = step_cost(cfg, SHAPES["train_4k"], _sh())
    sp = step_cost(cfg, SHAPES["train_4k"], _sh(seq_parallel=True))
    assert sp.breakdown["tp_allreduce_bytes"] == pytest.approx(
        bf.breakdown["tp_allreduce_bytes"] / 2)


def test_ep_serve_removes_weight_gather():
    cfg = load_config("deepseek-v3-671b")
    two_d = step_cost(cfg, SHAPES["decode_32k"], _sh(fsdp_params=True))
    ep = step_cost(cfg, SHAPES["decode_32k"],
                   _sh(fsdp_params=True, ep_serve=True))
    assert "serve_weight_ag_bytes" in two_d.breakdown
    assert "serve_weight_ag_bytes" not in ep.breakdown
    assert ep.coll_bytes < 0.05 * two_d.coll_bytes
    assert ep.hbm_bytes < two_d.hbm_bytes


def test_device_limited_routing_scales_a2a():
    cfg = load_config("deepseek-v3-671b")
    full = step_cost(cfg, SHAPES["train_4k"], _sh())
    lim = step_cost(cfg, SHAPES["train_4k"], _sh(k_eff=4.0))
    assert lim.breakdown["moe_a2a_bytes"] == pytest.approx(
        full.breakdown["moe_a2a_bytes"] * 4 / 8)


def test_decode_dominated_by_memory_for_dense():
    cfg = load_config("qwen2.5-14b")
    r = cost_for_cell(cfg, SHAPES["decode_32k"]).roofline()
    assert r["dominant"] == "memory"


def test_train_dominated_by_collective_on_fixed_mesh():
    cfg = load_config("deepseek-v3-671b")
    r = cost_for_cell(cfg, SHAPES["train_4k"]).roofline()
    assert r["dominant"] == "collective"


def test_long500k_clamps_dp_to_batch():
    cfg = load_config("rwkv6-1.6b")
    c = cost_for_cell(cfg, SHAPES["long_500k"])
    assert c.flops > 0  # batch=1 must not divide away to zero work
