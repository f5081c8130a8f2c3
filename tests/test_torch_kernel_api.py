"""The port's kernel API (repro_torch.kernels: matmul, rmsnorm,
decoupled_gather, decoupled_gather_staged) against the JAX reference's
(repro.kernels).

On the CPU each wrapper runs its plain PyTorch version, held here against
the reference's Pallas kernels in interpret mode on the same numpy
inputs, at the tolerances of tests/test_kernels.py: matmul fp32
rtol 2e-5 / atol 3e-4 and bf16 2e-2 / 2e-1 (fp32 sums in another order;
bf16 rounds the output), rmsnorm 1e-5 fp32 and 2e-2 bf16, the gather
1e-6 (one tanh, two implementations).  The compiler-derived gather is
held against the reference's on the sequential and emulated backends,
and bit for bit against the port's own plain version.  The tests marked
``cuda`` hold each CUDA kernel against its plain version and skip where
there is no card.  There both sides accumulate in fp32 and round once, so
a bf16 result may differ by one bf16 unit in the last place: the gather
is held at that (rtol 2**-7), the products at rtol 1e-2 / atol 5e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as ref_api
import repro_torch
from repro.kernels.decoupled_gather import \
    decoupled_gather as ref_gather_kernel
from repro_torch.kernels import (_lib, decoupled_gather, decoupled_gather_ref,
                                 decoupled_gather_staged, matmul, ops, ref,
                                 rmsnorm)
from repro_torch.kernels import dataflow_matmul as dm
from repro_torch.kernels.decoupled_gather import BULK, CP_ASYNC, gather_route

_RNG = np.random.default_rng(42)
_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}
MATMUL_TOL = {"f32": dict(rtol=2e-5, atol=3e-4),
              "bf16": dict(rtol=2e-2, atol=2e-1)}
RMSNORM_TOL = {"f32": 1e-5, "bf16": 2e-2}
GATHER_TOL = dict(rtol=1e-6, atol=1e-6)
#: a CUDA kernel against its plain version on the card
KERNEL_MATMUL_BF16_TOL = dict(rtol=1e-2, atol=5e-2)
KERNEL_GATHER_TOL = {"f32": GATHER_TOL, "bf16": dict(rtol=2 ** -7, atol=0.0)}


def _identity(row):
    return row


#: the row functions by the name each package takes them under
GATHER_FNS = {"default": (None, None), "identity": (_identity, "identity")}


@pytest.fixture(autouse=True)
def _port_on_cpu():
    repro_torch.set_device("cpu")
    _lib.reset_counts()
    yield
    repro_torch.set_device(None)


def _pair(shape, dtype, rng=_RNG):
    """One numpy draw as a (jax, torch) pair of ``dtype``."""
    a = rng.normal(size=shape).astype(np.float32)
    jt, tt = _DTYPES[dtype]
    return jnp.asarray(a).astype(jt), torch.from_numpy(a).to(tt)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# The API on the CPU against the reference
# ---------------------------------------------------------------------------

def test_the_port_exports_the_reference_names():
    assert set(ref_api.__all__) <= set(repro_torch.kernels.__all__)
    assert repro_torch.kernels.flash_attention is ops.flash_attention
    assert repro_torch.kernels.decode_attention is ops.decode_attention
    assert {"running_max", "spmv_bsr"} <= set(repro_torch.kernels.__all__)


@pytest.mark.parametrize("M,K,N", [(128, 256, 128), (100, 300, 200),
                                   (8, 128, 128), (257, 129, 511)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_matmul_matches_reference(M, K, N, dtype):
    (xj, xt), (wj, wt) = _pair((M, K), dtype), _pair((K, N), dtype)
    got = matmul(xt, wt)
    assert got.dtype == xt.dtype and got.shape == (M, N)
    np.testing.assert_allclose(_np(got), _np(ref_api.matmul(xj, wj)),
                               **MATMUL_TOL[dtype])


def test_matmul_out_dtype_matches_reference():
    (xj, xt), (wj, wt) = _pair((64, 128), "bf16"), _pair((128, 64), "bf16")
    got = matmul(xt, wt, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        got.numpy(), _np(ref_api.matmul(xj, wj, out_dtype=jnp.float32)),
        **MATMUL_TOL["f32"])


@pytest.mark.parametrize("shape", [(4, 64), (3, 7, 128), (1, 1, 1, 256),
                                   (5, 96)])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_matches_reference(shape, dtype):
    xj, xt = _pair(shape, dtype)
    wj, wt = _pair(shape[-1:], "f32")
    got = rmsnorm(xt, wt)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    tol = RMSNORM_TOL[dtype]
    np.testing.assert_allclose(_np(got), _np(ref_api.rmsnorm(xj, wj)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("N,R,D", [(8, 32, 128), (16, 64, 128), (5, 7, 256)])
@pytest.mark.parametrize("fn", sorted(GATHER_FNS))
def test_decoupled_gather_matches_reference(N, R, D, fn):
    tj, tt = _pair((R, D), "f32")
    idx = _RNG.integers(0, R, N).astype(np.int32)
    ref_fn, port_fn = GATHER_FNS[fn]
    want = ref_gather_kernel(jnp.asarray(idx), tj, fn=ref_fn, interpret=True)
    got = decoupled_gather(torch.from_numpy(idx), tt, fn=port_fn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GATHER_TOL)


@pytest.mark.parametrize("fn", sorted(GATHER_FNS))
def test_decoupled_gather_repeated_indices_match_reference(fn):
    """Ring-buffer correctness when one row is fetched back to back."""
    tj, tt = _pair((16, 128), "f32")
    idx = np.asarray([3, 3, 3, 5, 3, 5, 5, 0], np.int32)
    ref_fn, port_fn = GATHER_FNS[fn]
    want = ref_gather_kernel(jnp.asarray(idx), tj, fn=ref_fn, interpret=True)
    got = decoupled_gather(torch.from_numpy(idx), tt, fn=port_fn)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GATHER_TOL)


#: indices past both ends of a 4-row table: ≥ R, −1 and < −R
OUT_OF_RANGE = np.asarray([0, 3, 5, -1, -6, 9, -4, 2, -100, 4], np.int32)


@pytest.mark.parametrize("fn", sorted(GATHER_FNS))
def test_decoupled_gather_out_of_range_indices_match_reference(fn):
    """Negative indices wrap once by R, then every index clamps into
    [0, R): the reference's Pallas kernel (interpret mode) and its oracle
    give rows [0, 3, 3, 3, 0, 3, 0, 2, 0, 3]; so do the port's plain
    version and its staged form on both backends."""
    tj, tt = _pair((4, 8), "f32")
    ij = jnp.asarray(OUT_OF_RANGE)
    it = torch.from_numpy(OUT_OF_RANGE)
    ref_fn, port_fn = GATHER_FNS[fn]
    want = ref_gather_kernel(ij, tj, fn=ref_fn, interpret=True)
    np.testing.assert_array_equal(
        np.asarray(want), np.asarray(ref_api.decoupled_gather_ref(
            ij, tj, fn=ref_fn)))
    rows = torch.tensor([0, 3, 3, 3, 0, 3, 0, 2, 0, 3])
    plain = decoupled_gather(it, tt, fn=port_fn)
    assert torch.equal(plain, decoupled_gather_ref(it, tt, fn=port_fn))
    assert torch.equal(plain, decoupled_gather_ref(rows, tt, fn=port_fn))
    np.testing.assert_allclose(plain.numpy(), np.asarray(want), **GATHER_TOL)
    for backend in ("sequential", "emulated"):
        staged = decoupled_gather_staged(it, tt, fn=port_fn, backend=backend)
        assert torch.equal(staged, plain), backend
        np.testing.assert_allclose(
            staged.numpy(), np.asarray(ref_api.decoupled_gather_staged(
                ij, tj, fn=ref_fn, backend=backend)), **GATHER_TOL)


def test_decoupled_gather_takes_any_index_dtype_and_callable_on_the_cpu():
    _, tt = _pair((16, 32), "f32")
    idx = torch.tensor([1, -1, 15, 0])                 # int64, one negative
    want = torch.tanh(tt[idx] * 2.0)
    assert torch.equal(decoupled_gather(idx, tt), want)
    assert torch.equal(decoupled_gather_ref(idx, tt), want)
    assert torch.equal(decoupled_gather(idx, tt, fn=torch.sigmoid),
                       torch.sigmoid(tt[idx]))
    with pytest.raises(ValueError, match="unknown row function"):
        decoupled_gather(idx, tt, fn="tanh")


@pytest.mark.parametrize("backend", ["sequential", "emulated"])
@pytest.mark.parametrize("fn", sorted(GATHER_FNS))
def test_staged_gather_matches_reference(backend, fn):
    """The compiler-derived gather: the reference's on the same backend,
    and bit for bit the port's plain version."""
    tj, tt = _pair((64, 128), "f32")
    idx = _RNG.integers(0, 64, 8).astype(np.int32)
    ref_fn, port_fn = GATHER_FNS[fn]
    want = ref_api.decoupled_gather_staged(jnp.asarray(idx), tj, fn=ref_fn,
                                           backend=backend)
    got = decoupled_gather_staged(torch.from_numpy(idx), tt, fn=port_fn,
                                  backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GATHER_TOL)
    assert torch.equal(got, decoupled_gather_ref(torch.from_numpy(idx), tt,
                                                 fn=port_fn))


def test_staged_gather_lowers_to_the_program_it_runs():
    _, tt = _pair((64, 128), "f32")
    idx = torch.from_numpy(_RNG.integers(0, 64, 8).astype(np.int32))
    prog = decoupled_gather_staged.lower(idx, tt)
    assert (prog.num_stages, prog.schedule.num_channels) == (3, 2)
    assert torch.equal(prog(idx, tt), decoupled_gather_staged(idx, tt))


def test_cpu_calls_never_touch_the_kernel_library():
    _, x = _pair((8, 64), "f32")
    matmul(x, x.T)
    rmsnorm(x, x[0])
    decoupled_gather(torch.tensor([0, 7]), x)
    assert _lib.counts() == dict.fromkeys(_lib.SIGNATURES, 0)
    assert {"dataflow_matmul", "rmsnorm", "decoupled_gather"} \
        <= set(_lib.counts())
    assert _lib._libs == {}


def test_api_keeps_the_reference_attention_policy():
    """The exported attention entry points are the ops wrappers: they
    refuse non-causal attention that needs padded keys, as the
    reference's ops do, and take int64 lengths."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.normal(size=(1, 2, 37, 16)).astype(np.float32))
    with pytest.raises(ValueError, match="non-causal padding"):
        repro_torch.kernels.flash_attention(q, q, q, causal=False)
    out = repro_torch.kernels.decode_attention(q[:, :, 0], q, q,
                                               torch.tensor([5]))
    want = ref.decode_attention_ref(q[:, :, 0], q, q, torch.tensor([5]))
    assert torch.equal(out, want)


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        matmul(torch.zeros(4, 3), torch.zeros(4, 3))
    with pytest.raises(ValueError):
        rmsnorm(torch.zeros(4, 3), torch.zeros(4))
    with pytest.raises(ValueError):
        decoupled_gather(torch.zeros(2, 2, dtype=torch.int32),
                         torch.zeros(4, 3))


def _misaligned(rows, cols, dtype):
    """A contiguous (rows, cols) view whose base is one element past 16
    bytes."""
    return torch.empty(rows * cols + 1, dtype=dtype)[1:].view(rows, cols)


@pytest.mark.parametrize("shape,dtype,misaligned,want", [
    ((49152, 576), torch.bfloat16, False, BULK),   # phase 7: smollm's table
    ((4, 8192), torch.float32, False, BULK),       # 32 KB rows: in pieces
    ((9, 8), torch.bfloat16, False, BULK),         # one 16-byte word a row
    ((50, 7), torch.float32, False, CP_ASYNC),     # 28-byte rows
    ((9, 6), torch.bfloat16, False, CP_ASYNC),     # 12-byte rows
    ((64, 8), torch.float32, True, CP_ASYNC),      # base 4 bytes past 16
], ids=["phase7", "wide", "narrow", "28B", "12B", "misaligned"])
def test_gather_route_is_chosen_from_row_width_and_alignment(
        shape, dtype, misaligned, want):
    table = (_misaligned(*shape, dtype) if misaligned
             else torch.empty(shape, dtype=dtype))
    assert gather_route(table) == want


@pytest.mark.parametrize("x,w,want", [
    # phase 7 of chip_smoke.py: smollm-135m's two MLP products; 4096 rows
    # in 32 tiles, so N = 1536 in 192-wide tiles is 256 tiles (2 waves of
    # 132) and N = 576 is 96 (one wave)
    ((4096, 576, "bf16"), (576, 1536, "bf16"), (dm.WGMMA, 192)),
    ((4096, 1536, "bf16"), (1536, 576, "bf16"), (dm.WGMMA, 192)),
    ((128, 128, "bf16"), (128, 128, "bf16"), (dm.WGMMA, 64)),
    ((4096, 576, "f32"), (576, 1536, "f32"), (dm.CUDA_CORE, None)),
    ((257, 129, "bf16"), (129, 512, "bf16"), (dm.CUDA_CORE, None)),
    ((257, 128, "bf16"), (128, 511, "bf16"), (dm.CUDA_CORE, None)),
    ((3, 0, "bf16"), (0, 8, "bf16"), (dm.CUDA_CORE, None)),
    ("misaligned", (128, 256, "bf16"), (dm.CUDA_CORE, None)),
], ids=["phase7-in", "phase7-out", "one-tile", "fp32", "K=129", "N=511",
        "K=0", "misaligned-x"])
def test_matmul_route_is_chosen_from_shape_dtype_and_alignment(x, w, want):
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}
    xt = (_misaligned(64, 128, torch.bfloat16) if x == "misaligned"
          else torch.empty(x[:2], dtype=dtype[x[2]]))
    wt = torch.empty(w[:2], dtype=dtype[w[2]])
    assert dm.route(xt, wt) == dm.Route(*want)


def test_matmul_route_fills_whole_waves():
    """The wgmma tile width is the one with the fewest waves x width; the
    widest wins a tie, and fewer SMs take fewer, wider tiles."""
    x = torch.empty(4096, 576, dtype=torch.bfloat16)
    w = torch.empty(576, 1536, dtype=torch.bfloat16)
    assert dm.route(x, w).block_n == 192        # 256 tiles: 2 waves of 132
    assert dm.route(x, w, sms=384).block_n == 128   # 384 tiles: 1 wave
    assert dm.route(x, w, sms=1).block_n == 256


# ---------------------------------------------------------------------------
# The CUDA kernels against their plain versions (skip without a card)
# ---------------------------------------------------------------------------

def _cuda_pair(dev, shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        dev, _DTYPES[dtype][1])


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [
    (4096, 576, 1536),   # smollm-135m's MLP input product
    (128, 1536, 576),    # its output product (fewer rows)
    (100, 300, 200),     # ragged: the register-staged ring
    (257, 129, 511),
    (8, 128, 128),
    (3, 0, 5),           # empty contraction: zeros
])
@pytest.mark.parametrize("dtype,out", [("f32", None), ("bf16", None),
                                       ("bf16", torch.float32),
                                       ("f32", torch.bfloat16)])
def test_matmul_kernel_matches_plain(M, K, N, dtype, out):
    dev = _needs_card()
    torch.backends.cuda.matmul.allow_tf32 = False
    x = _cuda_pair(dev, (M, K), dtype, M + K)
    w = _cuda_pair(dev, (K, N), dtype, K + N)
    got = matmul(x, w, out_dtype=out)
    want = ref.matmul_ref(x, w, out)
    tol = (MATMUL_TOL["f32"] if dtype == "f32" and out is None
           else KERNEL_MATMUL_BF16_TOL)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    assert got.dtype == want.dtype
    assert _lib.counts()["dataflow_matmul"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("block_n", dm.BLOCK_NS)
@pytest.mark.parametrize("M,K", [(64, 64), (64, 128), (128, 64), (128, 128)])
@pytest.mark.parametrize("tiles", [1, 2])
def test_matmul_wgmma_selects_columns_bit_for_bit(block_n, M, K, tiles):
    """w selects columns of x (one 1 per column), x is an integer ramp
    exact in bf16: out is x[:, sel] bit for bit, so a wrong shared-memory
    descriptor or swizzle shows as a permutation, not as noise."""
    dev = _needs_card()
    N = block_n * tiles
    rng = np.random.default_rng(block_n + M + K + tiles)
    sel = torch.from_numpy(rng.integers(0, K, N)).to(dev)
    ramp = torch.arange(M * K, device=dev).reshape(M, K) % 241 - 120
    x = ramp.to(torch.bfloat16)
    w = torch.zeros(K, N, dtype=torch.bfloat16, device=dev)
    w[sel, torch.arange(N, device=dev)] = 1
    for out in (torch.bfloat16, torch.float32):
        got = dm._launch(x, w, out, dm.Route(dm.WGMMA, block_n))
        assert torch.equal(got, x[:, sel].to(out))
    assert _lib.routes()["dataflow_matmul"] == {dm.WGMMA: 2}


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,dtype", [
    (4096, 576, 1536, "bf16"), (4096, 1536, 576, "bf16"),
    (100, 72, 200, "bf16"), (4096, 576, 1536, "f32"),
    (257, 129, 511, "bf16"), (3, 0, 8, "bf16")])
def test_matmul_kernel_takes_its_route(M, K, N, dtype):
    dev = _needs_card()
    x = _cuda_pair(dev, (M, K), dtype, M)
    w = _cuda_pair(dev, (K, N), dtype, N)
    got = matmul(x, w)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    want_route = dm.route(x, w, sms=sms)
    assert _lib.routes()["dataflow_matmul"] == {want_route.design: 1}
    assert (want_route.design == dm.WGMMA) == (
        dtype == "bf16" and K % 8 == 0 and N % 8 == 0 and K > 0)
    tol = (MATMUL_TOL["f32"] if dtype == "f32" else KERNEL_MATMUL_BF16_TOL)
    torch.testing.assert_close(got.float(), ref.matmul_ref(x, w).float(),
                               **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4096, 576), (3, 7, 128), (5, 96),
                                   (2, 1025), (3, 4096), (1, 1)])
@pytest.mark.parametrize("xd,wd", [("f32", "f32"), ("bf16", "bf16"),
                                   ("bf16", "f32"), ("f32", "bf16")])
def test_rmsnorm_kernel_matches_plain(shape, xd, wd):
    dev = _needs_card()
    x = _cuda_pair(dev, shape, xd, shape[-1])
    w = _cuda_pair(dev, shape[-1:], wd, 1)
    got = rmsnorm(x, w)
    want = ref.rmsnorm_ref(x, w)
    tol = RMSNORM_TOL[xd]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert got.dtype == x.dtype
    assert _lib.counts()["rmsnorm"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("N,R,D,dtype", [
    (4096, 49152, 576, "bf16"),  # smollm-135m's embedding lookup
    (4096, 49152, 576, "f32"),
    (8, 32, 128, "f32"), (5, 7, 256, "bf16"),
    (1000, 50, 7, "f32"),        # 28-byte rows: 4-byte copies
    (33, 9, 6, "bf16"),          # 12-byte rows: 4-byte copies
])
@pytest.mark.parametrize("fn", [None, "identity"])
def test_decoupled_gather_kernel_matches_plain(N, R, D, dtype, fn):
    dev = _needs_card()
    table = _cuda_pair(dev, (R, D), dtype, R + D)
    idx = torch.from_numpy(np.random.default_rng(N).integers(
        -R, R, N).astype(np.int32)).to(dev)         # negatives wrap
    got = decoupled_gather(idx, table, fn=fn)
    want = decoupled_gather_ref(idx, table, fn=fn)
    if fn == "identity":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   **KERNEL_GATHER_TOL[dtype])
    assert _lib.counts()["decoupled_gather"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["last_column", "every_other"])
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64])
def test_decoupled_gather_kernel_takes_strided_indices(view, index_dtype):
    dev = _needs_card()
    table = _cuda_pair(dev, (300, 128), "bf16", 5)
    rng = np.random.default_rng(6)
    base = torch.from_numpy(rng.integers(-300, 300, (64, 9))).to(
        dev, index_dtype)
    idx = base[:, -1] if view == "last_column" else base.flatten()[::2]
    assert not idx.is_contiguous()
    assert torch.equal(decoupled_gather(idx, table, fn="identity"),
                       table[idx])
    torch.testing.assert_close(decoupled_gather(idx, table).float(),
                               decoupled_gather_ref(idx, table).float(),
                               **KERNEL_GATHER_TOL["bf16"])


@pytest.mark.cuda
def test_decoupled_gather_kernel_reports_rows_too_wide_for_its_ring():
    """The bulk-copy ring takes rows of any width, in 2 KB pieces (32 KB
    rows: 16 pieces); the cp.async ring, which takes rows that are not
    16-byte multiples, still reports rows wider than its 8 slots fit in
    shared memory (8191 floats) as a CUDA error, and takes 7263."""
    dev = _needs_card()
    idx = torch.tensor([0, 3, -1, 9], dtype=torch.int32, device=dev)
    wide = _cuda_pair(dev, (4, 8192), "f32", 1)
    assert gather_route(wide) == BULK
    assert torch.equal(decoupled_gather(idx, wide, fn="identity"),
                       wide[[0, 3, 3, 3]])
    with pytest.raises(RuntimeError, match="decoupled_gather"):
        decoupled_gather(idx, torch.zeros(4, 8191, device=dev))
    torch.testing.assert_close(
        decoupled_gather(idx, torch.zeros(4, 7263, device=dev)),
        torch.zeros(4, 7263, device=dev), rtol=0, atol=0)
    assert _lib.routes()["decoupled_gather"] == {BULK: 1, CP_ASYNC: 2}


@pytest.mark.cuda
@pytest.mark.parametrize("design", [BULK, CP_ASYNC])
def test_decoupled_gather_tanh_on_every_bf16_value(design):
    """The bf16 kernels take tanh(2·x) from the hardware's tanh: on every
    finite bf16 value (all 65,536 bit patterns, the others as 0) it is
    within one bf16 ulp of the plain version's fp32 tanh, rounded once."""
    from repro_torch.kernels.decoupled_gather import _launch
    dev = _needs_card()
    bits = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16)
    vals = bits.view(torch.bfloat16)
    vals = torch.where(torch.isfinite(vals.float()), vals,
                       torch.zeros_like(vals))
    table = vals.reshape(8192, 8).to(dev)
    idx = torch.arange(8192, dtype=torch.int32, device=dev)
    got = _launch(idx, table, None, design)
    torch.testing.assert_close(got.float(),
                               decoupled_gather_ref(idx, table).float(),
                               **KERNEL_GATHER_TOL["bf16"])


@pytest.mark.cuda
@pytest.mark.parametrize("design,N,R,D,dtype", [
    (BULK, 5, 7, 64, "bf16"),           # fewer rows than SMs: one a CTA
    (CP_ASYNC, 5, 7, 64, "bf16"),
    (BULK, 4133, 300, 576, "bf16"),     # not a multiple of the 32 slots
    (CP_ASYNC, 4133, 300, 576, "bf16"),
    (BULK, 40_000, 97, 64, "f32"),      # several rounds of the ring a CTA
    (CP_ASYNC, 40_000, 97, 64, "f32"),
    (BULK, 300, 6, 4104, "f32"),        # 16,416-byte rows: 9 pieces
])
def test_decoupled_gather_routes_bit_for_bit(design, N, R, D, dtype):
    """Both designs on repeated and out-of-range indices (≥ R, −1, < −R):
    ``identity`` is bit for bit the table's wrapped-and-clamped rows, and
    tanh(2·row) within one bf16 ulp (fp32: 1e-6) of the plain version."""
    from repro_torch.kernels.decoupled_gather import _launch
    dev = _needs_card()
    table = _cuda_pair(dev, (R, D), dtype, N + D)
    rng = np.random.default_rng(N)
    idx = rng.integers(-2 * R, 2 * R, N).astype(np.int32)
    idx[rng.random(N) < 0.3] = 1                  # runs of one row
    rows = np.clip(np.where(idx < 0, idx + R, idx), 0, R - 1)
    it = torch.from_numpy(idx).to(dev)
    got = _launch(it, table, "identity", design)
    assert torch.equal(got, table[torch.from_numpy(rows).to(dev)])
    got = _launch(it, table, None, design)
    torch.testing.assert_close(got.float(),
                               decoupled_gather_ref(it, table).float(),
                               **KERNEL_GATHER_TOL[dtype])
    assert _lib.routes()["decoupled_gather"] == {design: 2}


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["sequential", "emulated"])
def test_staged_gather_bit_identical_on_the_card(backend):
    dev = _needs_card()
    repro_torch.set_device(dev)
    table = _cuda_pair(dev, (64, 128), "bf16", 3)
    idx = torch.arange(-8, 24, dtype=torch.int32, device=dev)
    got = decoupled_gather_staged(idx, table, backend=backend)
    assert got.device.type == "cuda"
    assert torch.equal(got, decoupled_gather_ref(idx, table))


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take():
    dev = _needs_card()
    t = torch.zeros(4, 6, device=dev)
    with pytest.raises(ValueError, match="named fn"):
        decoupled_gather(torch.zeros(2, dtype=torch.int32, device=dev), t,
                         fn=torch.sigmoid)
    with pytest.raises(ValueError, match="4 bytes"):
        decoupled_gather(torch.zeros(2, dtype=torch.int32, device=dev),
                         torch.zeros(4, 3, dtype=torch.bfloat16, device=dev))
    with pytest.raises(TypeError):
        decoupled_gather(torch.zeros(2, dtype=torch.int32, device=dev),
                         t.half())
    with pytest.raises(TypeError):
        matmul(t, t.T.contiguous().bfloat16())
    with pytest.raises(TypeError):
        rmsnorm(t.half(), t[0])
    assert _lib.counts() == dict.fromkeys(_lib.SIGNATURES, 0)
