"""The port stands alone: no JAX and no reference package inside it, and
its entry points run on the card unless the caller asks for the CPU."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import load_config, reduced
from repro_torch.core import DeviceFIFO
from repro_torch.core import engine as port_engine
from repro_torch.dataflow.options import CompileOptions
from repro_torch.dataflow.passes import CompileContext
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import init_cache, init_params
from repro_torch.workloads import make_spmv

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"] + sorted((ROOT / "scripts").glob("*.py"))


@pytest.fixture(autouse=True)
def _default_policy():
    repro_torch.set_device(None)
    port_engine.select(None)
    yield
    repro_torch.set_device(None)
    port_engine.select(None)


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def test_import_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.kernels, "
            "repro_torch.workloads, repro_torch.interop, "
            "repro_torch.models, repro_torch.configs, "
            "repro_torch.launch.serve; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_compile_without_cuda_raises_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_spmv(0.125)
    w = make_spmv(0.125, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        repro_torch.compile(w.loop_body, w.carry_example, *w.body_args,
                            loop=True)
    c = repro_torch.compile(w.loop_body, w.carry_example, *w.body_args,
                            loop=True, device="cpu")
    assert c.device == torch.device("cpu")
    repro_torch.set_device("cpu")
    assert repro_torch.compile(w.loop_body, w.carry_example, *w.body_args,
                               loop=True) is c


def test_engine_never_falls_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    assert repro_torch.get_device("cpu") == torch.device("cpu")
    assert port_engine.current() == "numpy"      # auto: no card, no torch
    big = np.arange(port_engine.JIT_MIN_ELEMS, dtype=np.int64)
    with port_engine.use("torch"):
        with pytest.raises(RuntimeError, match="CUDA"):
            port_engine.running_max(big)
    repro_torch.set_device("cpu")
    with port_engine.use("torch"):
        np.testing.assert_array_equal(port_engine.running_max(big.copy()),
                                      big)


def test_model_and_server_without_cuda_raise_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cfg = reduced(load_config("smollm-135m"))
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(gen, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_main(["--arch", "smollm-135m", "--reduced"])
    params = init_params(gen, cfg, device="cpu")
    assert params["embed"]["table"].device == torch.device("cpu")
    repro_torch.set_device("cpu")
    assert init_cache(cfg, 1, 8)["segment_0"][0][0]["mixer"]["k"].device \
        == torch.device("cpu")


def test_device_fifo_without_cuda_raises_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceFIFO(2, 3)
    assert DeviceFIFO(2, 3, device="cpu").init().buf.device \
        == torch.device("cpu")
    repro_torch.set_device("cpu")
    state = DeviceFIFO(2, 3).init()
    assert {state.buf.device, state.head.device, state.count.device} \
        == {torch.device("cpu")}


def test_compile_context_follows_the_device_policy():
    """A CompileContext built without a device takes the port's default —
    the card unless the CPU is asked for — never the CPU on its own."""
    def ctx():
        return CompileContext(fn=abs, example_args=(),
                              options=CompileOptions())
    repro_torch.set_device("cpu")
    assert ctx().device == torch.device("cpu")
    repro_torch.set_device(None)
    if torch.cuda.is_available():
        assert ctx().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ctx()
