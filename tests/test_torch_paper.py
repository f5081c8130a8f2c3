"""The paper's other evaluations and the examples on the port
(``repro_torch.workloads.{fig2_schedule,table2,sweep}``,
``repro_torch.examples``) against the reference's
(``benchmarks/{fig2_schedule,paper_table2,sweep}.py``, ``examples/``).

Exact where the reference's output is text or integers: the Fig. 2 text,
every Table II field, the ``--smoke`` sweep grid's cycles (numpy engine,
rescache off, against the reference's ``_sweep_task``), and what the
examples print of their simulations.  ``chip_smoke.py`` holds the card
to recorded constants; they must be what the reference computes here.
The examples run with ``--device cpu`` at their own (small) sizes, and
nothing they or the modules write may land outside ``build/``.
"""

import contextlib
import hashlib
import io
import os
import re

import numpy as np
import pytest
import torch

import chip_smoke
import repro_torch
from benchmarks import fig2_schedule as ref_fig2
from benchmarks import paper_table2 as ref_table2
from benchmarks import sweep as ref_sweep
from benchmarks.paper_kernels import ALL_KERNELS as REF_KERNELS
from repro.core import engine as ref_engine
from repro.core import rescache as ref_rescache
from repro.dataflow import TransformConfig as RefTransformConfig
from repro_torch.core import engine as port_engine
from repro_torch.core import rescache as port_rescache
from repro_torch.examples import (quickstart, serve_decode, spmv_dataflow,
                                  train_lm)
from repro_torch.workloads import ALL_KERNELS, fig2_schedule, sweep, table2

#: a row's fields that are wall-clock seconds (not compared)
_TIMES = ("wall_s", "resolve_s", "solve_s")


@pytest.fixture(autouse=True)
def _port_on_cpu(monkeypatch):
    """The port on the CPU with one intra-op thread (the training
    example's small ops thrash when the suite's workers each spin a full
    thread pool), both resolution caches off for the test, and the
    environment and cache settings the entry points change put back."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    repro_torch.set_device("cpu")
    monkeypatch.setenv("REPRO_RESCACHE", "0")
    # set (empty) through monkeypatch, so that the sweep CLI's own setting
    # of it is undone after the test
    monkeypatch.setenv("REPRO_RESCACHE_DIR", "")
    saved = [(c, c.enabled, c.directory)
             for c in (ref_rescache._cfg, port_rescache._cfg)]
    for c, _, _ in saved:
        c.enabled = False
    yield
    for c, enabled, directory in saved:
        c.enabled, c.directory = enabled, directory
    repro_torch.set_device(None)
    torch.set_num_threads(threads)


def _stdout(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


# -- Fig. 2 ------------------------------------------------------------------

def test_fig2_text_is_the_reference():
    _, want = _stdout(ref_fig2.main)
    text, printed = _stdout(fig2_schedule.main, ["--device", "cpu"])
    assert printed == want
    assert text == want.rstrip("\n")
    assert hashlib.sha256(text.encode()).hexdigest() == "".join(
        chip_smoke.REF_FIG2_SHA256)
    assert f"{chip_smoke.REF_FIG2_CONVENTIONAL_CYCLES} cycles" in text


# -- Table II ----------------------------------------------------------------

@pytest.mark.parametrize("name", list(ALL_KERNELS))
def test_table2_row_is_the_reference(name):
    want = ref_table2.analyze_kernel(name, REF_KERNELS[name])
    got = table2.analyze_kernel(name, ALL_KERNELS[name], "cpu")
    assert got == want
    assert chip_smoke.REF_TABLE2[name] == (
        want["nodes"], want["stages_dataflow"], want["stages_conventional"],
        want["channels"], want["channel_bytes_per_token"],
        want["duplicated_ops"], want["ops_per_stage"],
        want["op_instances_conventional"], want["op_instances_dataflow"])


def test_table2_prints_the_reference_table(tmp_path):
    _, want = _stdout(ref_table2.main, None)
    out, got = _stdout(table2.main, ["--device", "cpu", "--out",
                                     str(tmp_path / "t2.json")])
    assert got == want
    assert len(out["rows"]) == 4 and (tmp_path / "t2.json").exists()


# -- the sweep -----------------------------------------------------------------

def _smoke_tasks() -> list[tuple]:
    """The ``--smoke`` grid's tasks, as ``run_sweep(smoke=True)`` builds
    them."""
    return sweep._tasks(True, tuple(ALL_KERNELS)[:2], (0.5, 1.0), None,
                        None, None)


def _ref_task(task: tuple) -> list[dict]:
    tf = task[9]
    if tf is not None:
        tf = RefTransformConfig(unroll=tf.unroll, coalesce=tf.coalesce)
    with ref_engine.use("numpy"):
        return ref_sweep._sweep_task(task[:9] + (tf,))


@pytest.mark.parametrize("engine", ["numpy", "torch"])
@pytest.mark.parametrize("i", range(6))
def test_sweep_smoke_task_is_the_reference(i, engine):
    """Each task of the ``--smoke`` grid: every row field the reference
    computes (cycles, CPI, speedups, FIFO bits, stalls) equal, on both
    port engines (on the CPU the torch engine's running max is the
    kernel's plain version); times are not compared."""
    task = _smoke_tasks()[i]
    want = _ref_task(task)
    with port_engine.use(engine):
        got = sweep._sweep_task(task)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert {k: v for k, v in g.items() if k not in _TIMES} == \
            {k: v for k, v in w.items() if k not in _TIMES}


def test_sweep_smoke_grid_is_the_chip_smoke_constant():
    rows = sweep.run_tasks(_smoke_tasks())
    assert tuple((r["kernel"], r["mem"], r.get("transform") or "none",
                  r["words_per_cycle"], r["dataflow_cycles"],
                  r["conventional_cycles"]) for r in rows) == \
        chip_smoke.REF_SWEEP_SMOKE
    ref_rows = [r for t in _smoke_tasks() for r in _ref_task(t)]
    assert sorted(r["dataflow_cycles"] for r in rows) == \
        sorted(r["dataflow_cycles"] for r in ref_rows)


def test_measure_perf_agrees_with_the_scalar_reference():
    """``measure_perf``: the vectorized simulator against the scalar
    reference simulator at 8,192 iterations, cycles asserted equal inside;
    and the same cycles as the reference package's simulators."""
    from repro.core.simulator import (simulate_conventional,
                                      simulate_dataflow)
    out = sweep.measure_perf(8192)
    stages = ref_sweep._perf_pipeline(8192)
    from repro.core.simulator import acp
    assert out["ACP"]["dataflow_cycles"] == simulate_dataflow(
        stages, acp(), 8192, fifo_depth=32).cycles
    assert out["ACP"]["conventional_cycles"] == simulate_conventional(
        stages, acp(), 8192).cycles


# -- everything under build/ -------------------------------------------------

def test_entry_points_write_only_under_build(tmp_path, monkeypatch):
    """Run from an empty directory, the modules and the training example
    write their outputs (JSON, the resolved-trace store, checkpoints)
    under ``build/`` and nowhere else."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("REPRO_RESCACHE", "1")
    port_rescache._cfg.enabled = True
    # the scaling probe (8 x 2^20 iterations over every core) takes
    # minutes on a CPU; it writes into the same JSON as the rest
    monkeypatch.setattr(sweep, "measure_worker_scaling",
                        lambda n=None: {"workers1_s": 0.0,
                                        "workers_all_s": 0.0,
                                        "workers_all": 2, "speedup": 1.0,
                                        "identical": True, "cpus": 1})
    _stdout(table2.main, ["--device", "cpu"])
    out, _ = _stdout(sweep.main, ["--smoke", "--device", "cpu",
                                  "--kernels", "knapsack"])
    _stdout(train_lm.main, ["--device", "cpu", "--steps", "6"])
    _stdout(fig2_schedule.main, ["--device", "cpu"])
    assert os.listdir(tmp_path) == ["build"]
    built = set(os.listdir(tmp_path / "build"))
    assert {"paper_table2_torch.json", "sweep_torch.json",
            "rescache_torch"} <= built
    assert any(n.startswith("train_lm_") for n in built)
    assert {"sweep", "perf", "worker_scaling"} <= set(
        __import__("json").load(open(tmp_path / "build" /
                                     "sweep_torch.json")))
    assert len(out["rows"]) == 4


# -- the examples --------------------------------------------------------------

def test_quickstart_example():
    _, text = _stdout(quickstart.main, ["--device", "cpu"])
    assert text.count("OK (== direct call)") == 3
    assert "backend systolic  : unavailable" in text
    assert "systolic stream (4 stages, 6 microbatches): OK" in text
    assert all(f"({n} cycles)" in text
               for n in chip_smoke.REF_QUICKSTART_CYCLES)


def test_quickstart_cycles_are_the_reference(monkeypatch):
    """The constant is what ``examples/quickstart.py`` prints of its
    simulation: conventional and dataflow cycles.  ``XLA_FLAGS`` is held
    as it is, so the example's eight host devices do not outlive it."""
    import runpy
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(os.path.join(os.path.dirname(__file__), os.pardir,
                                    "examples", "quickstart.py"),
                       run_name="__main__")
    conv, df = chip_smoke.REF_QUICKSTART_CYCLES
    text = buf.getvalue()
    assert re.search(rf"conventional.*\({conv} cycles\)", text), text
    assert re.search(rf"dataflow +\(decoupled\).*\({df} cycles\)", text), \
        text


def test_spmv_dataflow_example_prints_the_reference_simulation():
    """The main path's example: its report has the reference example's
    five stages, and its simulation line is the one the reference's
    example prints."""
    _, text = _stdout(spmv_dataflow.main, ["--device", "cpu"])
    assert chip_smoke.REF_SPMV_EXAMPLE_LINE in text
    assert "17 ops -> 5 stages" in text
    assert "BSR SpMV" in text and "OK" in text.splitlines()[-1]


def test_spmv_example_line_is_the_reference():
    """The constant is what ``examples/spmv_dataflow.py`` prints."""
    import runpy
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(os.path.join(os.path.dirname(__file__), os.pardir,
                                    "examples", "spmv_dataflow.py"),
                       run_name="__main__")
    assert chip_smoke.REF_SPMV_EXAMPLE_LINE in buf.getvalue()


def test_serve_decode_example():
    tokens, text = _stdout(serve_decode.main, ["--device", "cpu"])
    assert set(tokens) == {"bf16", "int8"}
    assert all(len(t) == 16 for kv in tokens.values() for t in kv)
    assert text.count("tok/s") == 2


def test_train_lm_example_loss_falls(tmp_path):
    out, text = _stdout(train_lm.main, ["--device", "cpu", "--steps", "20",
                                        "--ckpt-dir", str(tmp_path)])
    assert len(out["losses"]) == 20
    assert np.mean(out["losses"][-10:]) < np.mean(out["losses"][:10])
    assert "checkpoints in" in text and os.listdir(tmp_path)
