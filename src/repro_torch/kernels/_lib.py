"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface and loaded with ``ctypes`` — no PyTorch headers, so a
build takes seconds.  Libraries go under ``build/repro_torch/<hash>/`` at
the repository root (``.gitignore`` lists ``build/``), keyed by a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, and are
built at first use.  :func:`build_all`
starts one ``nvcc`` per source at once.

Every C entry point takes device pointers and a stream as ``c_void_p``
and returns the ``cudaGetLastError()`` after its launches; :func:`check`
raises on anything but 0.  ``LAUNCHES`` counts wrapper calls that launch
a kernel, one entry per kernel, and ``ROUTES`` the same launches by the
design they took, for the kernels with more than one (``dataflow_matmul``:
``"wgmma+tma"`` or ``"cuda-core fp32"``; ``flash_attention``:
``"mma.sync"`` or ``"cuda-core fp32"``; ``spmv_bsr``: ``"bulk-copy ring"``
or ``"scalar loads"``; ``decoupled_gather``: ``"bulk-copy ring"`` or
``"cp.async ring"``; ``decode_attention``: ``"cluster split-S ×C"``, C
CTAs per cluster).  One source may hold several
kernels (``flash_attention.cu`` holds prefill and decode attention).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from collections import Counter
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: kernel name -> C entry points with their argument types
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_PREFILL = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P]
_DECODE = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P]
_SPMV = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
SIGNATURES: dict[str, dict[str, list]] = {
    "spmv_bsr": {"spmv_bsr_f32": _SPMV, "spmv_bsr_ring_f32": _SPMV},
    "running_max": {
        **{f"running_max_{t}": [_P, _P, _P, _P, _L, _L, _P]
           for t in ("i64", "i32")},
        **{f"running_max_round_trip_{t}": [_P, _P, _P, _P, _P, _L, _L, _L, _P,
                                           _P, _P, _P, _P,
                                           ctypes.POINTER(_I)]
           for t in ("i64", "i32")}},
    "flash_attention": {"flash_attention_bf16": _PREFILL,
                        "flash_attention_f32": _PREFILL},
    "decode_attention": {"decode_attention_bf16": _DECODE,
                         "decode_attention_f32": _DECODE},
    "rmsnorm": {f"rmsnorm_{x}_{w}": [_P, _P, _P, _I, _I, _F, _P]
                for x in ("f32", "bf16") for w in ("f32", "bf16")},
    "dataflow_matmul": {
        **{f"dataflow_matmul_{a}_{o}": [_P, _P, _P, _I, _I, _I, _P]
           for a in ("f32", "bf16") for o in ("f32", "bf16")},
        **{f"dataflow_matmul_wgmma_bf16_{o}": [_P, _P, _P, _I, _I, _I, _I, _P]
           for o in ("f32", "bf16")}},
    "decoupled_gather": {f"decoupled_gather_{r}_{t}": [_P, _P, _P, _I, _I,
                                                         _I, _I, _P]
                         for r in ("bulk", "cp_async")
                         for t in ("f32", "bf16")},
}

#: kernel name -> its source in ``csrc/`` where the two differ
SOURCES: dict[str, str] = {"decode_attention": "flash_attention"}

#: launches per kernel since the last :func:`reset_counts`
LAUNCHES: dict[str, int] = dict.fromkeys(SIGNATURES, 0)
#: the same launches by design, for the kernels with more than one
ROUTES: dict[str, Counter[str]] = {
    k: Counter() for k in ("dataflow_matmul", "flash_attention",
                           "decode_attention", "spmv_bsr",
                           "decoupled_gather")}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def forbid_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise when ``name``'s kernel would run under autograd: grad mode on
    and an input that requires grad.  The kernels have no backward, and
    the ``ctypes`` launch returns a tensor with no ``grad_fn``, so a
    gradient through one would silently be zero.  The reference cannot
    differentiate its Pallas kernels either; every device raises, and
    ``torch.no_grad()`` / ``torch.inference_mode()`` run as before."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the hand-written kernel has no backward, as the "
            f"reference cannot differentiate its Pallas kernels either "
            f"(jax.grad through them fails); call it under torch.no_grad(), "
            f"or train with attn_impl 'auto', 'full' or 'chunked'")


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for by_design in ROUTES.values():
        by_design.clear()


def counts() -> dict[str, int]:
    return dict(LAUNCHES)


def routes() -> dict[str, dict[str, int]]:
    return {k: dict(v) for k, v in ROUTES.items()}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _source(name: str) -> str:
    return SOURCES.get(name, name)


def _lib_path(source: str) -> Path:
    # the headers every source may include (csrc/*.cuh) are part of the key
    src = b"".join(p.read_bytes() for p in [CSRC / f"{source}.cu",
                                            *sorted(CSRC.glob("*.cuh"))])
    key = hashlib.blake2b(src + " ".join(NVCC_FLAGS).encode(),
                          digest_size=8).hexdigest()
    return BUILD_ROOT / key / f"lib{source}.so"


def _start_build(source: str) -> tuple[Path, subprocess.Popen | None]:
    out = _lib_path(source)
    if out.exists():
        return out, None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{source}.cu")]
    return out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _finish_build(source: str, out: Path,
                  proc: subprocess.Popen | None) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {source}.cu:\n{log}")
    os.replace(tmp, out)


def build_all() -> None:
    """Compile every kernel source, one ``nvcc`` per source in parallel."""
    with _lock:
        sources = {_source(n) for n in SIGNATURES if n not in _libs}
        started = {s: _start_build(s) for s in sorted(sources)}
        for s, (out, proc) in started.items():
            _finish_build(s, out, proc)


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _lock:
        if name not in _libs:
            out, proc = _start_build(_source(name))
            _finish_build(_source(name), out, proc)
            cdll = ctypes.CDLL(str(out))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(cdll, fn).argtypes = argtypes
                getattr(cdll, fn).restype = ctypes.c_int
            _libs[name] = cdll
        return _libs[name]


def stream() -> int:
    """PyTorch's current CUDA stream, as the kernels take it."""
    return torch.cuda.current_stream().cuda_stream


def check(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
