"""The port stands alone: no JAX and no reference package inside it, and
its entry points run on the card unless the caller asks for the CPU."""

import ast
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time

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


#: a ``-m`` argument naming the reference package inside one string
_DASH_M = re.compile(r"(^|\s)-m\s+repro(\.|\s|$)")


def _leading_text(node: ast.AST) -> str | None:
    """The text a string expression starts with: a literal's value, or an
    f-string's leading literal parts (None for anything else)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        lead = ""
        for part in node.values:
            if not (isinstance(part, ast.Constant)
                    and isinstance(part.value, str)):
                break
            lead += part.value
        return lead
    return None


def _names_reference(text: str | None) -> bool:
    return text is not None and text.strip().split(".")[0] == "repro"


def _executed_reference_strings(source: str) -> list[str]:
    """String literals that would run a module of the reference package:
    the argument of ``importlib.import_module`` / ``__import__``, the
    element after ``"-m"`` in a command list, or ``-m repro...`` inside
    one string."""
    bad = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Call) and node.args:
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) \
                else getattr(f, "id", None)
            if name in ("import_module", "__import__") \
                    and _names_reference(_leading_text(node.args[0])):
                bad.append(f"{name}({_leading_text(node.args[0])!r})")
        elif isinstance(node, (ast.List, ast.Tuple)):
            texts = [_leading_text(e) for e in node.elts]
            for a, b in zip(texts, texts[1:]):
                if a == "-m" and _names_reference(b):
                    bad.append(f"-m {b}")
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and _DASH_M.search(node.value):
            bad.append(node.value)
    return bad


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_import(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_string_runs_a_reference_module(path):
    """No port file names a module of ``repro`` in a string that it
    executes: ``python -m``, ``importlib.import_module``, ``__import__``."""
    assert not _executed_reference_strings(path.read_text()), path


@pytest.mark.parametrize("snippet", [
    'cmd = [sys.executable, "-m", "repro.launch.serve", "daemon"]',
    'cmd = (exe, "-m", f"repro.launch.{name}")',
    'importlib.import_module("repro.core.engine")',
    'import_module(f"repro.configs.{arch}")',
    '__import__("repro")',
    'os.system("python -m repro.launch.serve stats")',
])
def test_string_scan_catches_reference_modules(snippet):
    assert _executed_reference_strings(snippet), snippet


def test_string_scan_passes_the_ports_modules():
    for snippet in ('cmd = [exe, "-m", "repro_torch.launch.serve"]',
                    'importlib.import_module(f"repro_torch.configs.{a}")',
                    '"python -m repro_torch.workloads.fig5"'):
        assert not _executed_reference_strings(snippet), snippet


def test_import_leaves_jax_out():
    code = ("import sys, repro_torch, repro_torch.kernels, "
            "repro_torch.workloads, repro_torch.interop, "
            "repro_torch.models, repro_torch.configs, "
            "repro_torch.launch.serve, repro_torch.serve, "
            "repro_torch.runtime, repro_torch.core.chunkgraph, "
            "repro_torch.dataflow.dse; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_daemon_process_leaves_jax_and_the_reference_out(tmp_path):
    """``python -m repro_torch.launch.serve daemon --device cpu`` serves a
    request and shuts down without loading ``jax`` or ``repro``: the
    process writes what it holds of them to a file at exit."""
    from repro_torch.core import rescache
    from repro_torch.core import simulator as sim
    from repro_torch.serve import client
    sock = str(pathlib.Path(tempfile.mkdtemp(prefix="iso-")) / "d.sock")
    dump = tmp_path / "modules.json"
    store = tmp_path / "store"
    code = (
        "import atexit, json, runpy, sys\n"
        "def dump():\n"
        f"    with open({str(dump)!r}, 'w') as f:\n"
        "        json.dump(sorted(m for m in sys.modules\n"
        "                         if m.split('.')[0] in ('jax', 'repro')), f)\n"
        "atexit.register(dump)\n"
        "sys.argv = ['serve', 'daemon', '--socket', "
        f"{sock!r}, '--workers', '1', '--store-dir', {str(store)!r}, "
        "'--device', 'cpu']\n"
        "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "REPRO_CHUNK_ITERS": str(rescache.CHUNK_ITERS)}
    proc = subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True)
    timeouts = client.ServeTimeouts(max_wait_s=2.0, backoff_cap_s=0.1)
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not client.ping(sock):
            assert proc.poll() is None, proc.stderr.read()
            time.sleep(0.2)
        rescache.configure(enabled=True, directory=str(store))
        rng = np.random.default_rng(0)
        stages = [sim.SimStage("ld", ii=1, latency=2, accesses=[
            sim.MemAccess("x", rng.integers(0, 1 << 16, 2000) * 4)])]
        served = client.simulate_dataflow_served(
            stages, {"ACPC": sim.acp_cache()}, 2000, fifo_depths=(8,),
            address=sock, timeouts=timeouts)
        assert served[("ACPC", 8)].cycles > 0
        assert client.shutdown(sock)
        assert proc.wait(timeout=30) == 0
    finally:
        rescache.configure(enabled=False)
        if proc.poll() is None:
            proc.kill()
    assert json.loads(dump.read_text()) == []


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
