"""The port's kernels (repro_torch.kernels) against the JAX reference.

On the CPU every wrapper runs its plain PyTorch version, which is held
against the reference here: ``spmv_bsr`` against the Pallas kernel in
interpret mode, its oracle ``ref.spmv_bsr_ref`` and the dense product
(the tolerances of tests/test_kernels.py: fp32 accumulation in another
order, so 1e-4 against dense and 1e-5 against the oracle), and the
running max bit for bit against the reference engine's numpy form.  The
tests marked ``cuda`` hold each CUDA kernel against its plain version and
skip where there is no card.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.core import engine as ref_engine
from repro.kernels import csr_to_bsr as ref_csr_to_bsr
from repro.kernels import ref as ref_oracles
from repro.kernels import spmv as ref_spmv
from repro_torch import interop
from repro_torch.core import engine as port_engine
from repro_torch.kernels import _lib, csr_to_bsr, ref, running_max, spmv
from repro_torch.kernels.scan import CHUNK, running_max_host
from repro_torch.kernels.spmv import RING, SCALAR, spmv_route

#: the reference's Pallas module (its package exports ``spmv`` from ops)
ref_spmv_mod = importlib.import_module("repro.kernels.spmv")
_RNG = np.random.default_rng(42)


@pytest.fixture(autouse=True)
def _port_on_cpu():
    repro_torch.set_device("cpu")
    port_engine.select(None)
    _lib.reset_counts()
    yield
    port_engine.select(None)
    repro_torch.set_device(None)


def _random_csr(M, K, density, seed=0):
    rng = np.random.default_rng(seed)
    dense = ((rng.random((M, K)) < density)
             * rng.normal(size=(M, K))).astype(np.float32)
    indptr = np.zeros(M + 1, np.int64)
    indptr[1:] = np.cumsum((dense != 0).sum(1))
    indices = np.nonzero(dense)[1].astype(np.int32)
    return dense, indptr, indices, dense[dense != 0]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# spmv_bsr
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,K,density", [
    (64, 256, 0.25),     # the paper's density
    (64, 256, 0.02),     # very sparse
    (16, 128, 0.9),      # nearly dense
])
def test_spmv_plain_matches_reference(M, K, density):
    dense, indptr, indices, data = _random_csr(M, K, density)
    vals, cols = csr_to_bsr(indptr, indices, data, (M, K), bm=8, bk=128)
    x = _RNG.normal(size=(K,)).astype(np.float32)
    got = spmv(torch.from_numpy(vals), torch.from_numpy(cols),
               torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got[:M], dense @ x, rtol=1e-4, atol=1e-4)
    pallas = np.asarray(ref_spmv(jnp.asarray(vals), jnp.asarray(cols),
                                 jnp.asarray(x)))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)
    oracle = np.asarray(ref_oracles.spmv_bsr_ref(
        jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(x), M))
    np.testing.assert_allclose(got[:M], oracle, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", range(4))
def test_spmv_plain_on_any_block_structure(seed):
    """For any BSR structure (padding ids included), plain == oracle."""
    rng = np.random.default_rng(seed)
    nbr, nnz, bm, bk = 1 + seed, 1 + seed % 3, 8, 128
    nbc = nnz + 1
    vals = rng.normal(size=(nbr, nnz, bm, bk)).astype(np.float32)
    cols = rng.integers(-1, nbc, size=(nbr, nnz)).astype(np.int32)
    x = rng.normal(size=(nbc * bk,)).astype(np.float32)
    got = spmv(torch.from_numpy(vals), torch.from_numpy(cols),
               torch.from_numpy(x)).numpy()
    want = np.asarray(ref_oracles.spmv_bsr_ref(
        jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(x), nbr * bm))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("nbr,nnz,bm,bk,nbc", [
    (2, 3, 8, 128, 3),           # ids [[0, 5, -1], [1, 2, -3]] below
    (5, 7, 4, 32, 4),            # random ids up to 3 x nbc
])
def test_spmv_clamps_column_ids_past_the_last_tile(nbr, nnz, bm, bk, nbc):
    """A column id >= n_block_cols reads the last x tile, as the
    reference's oracle (jnp indexing clamps) and its Pallas kernel
    (interpret mode, the block index clamped) do; negative ids stay
    padding."""
    rng = np.random.default_rng(nnz)
    vals = rng.normal(size=(nbr, nnz, bm, bk)).astype(np.float32)
    cols = (np.asarray([[0, 5, -1], [1, 2, -3]], np.int32) if nnz == 3
            else rng.integers(-2, 3 * nbc, size=(nbr, nnz)).astype(np.int32))
    assert (cols >= nbc).any() and (cols < 0).any()
    x = rng.normal(size=(nbc * bk,)).astype(np.float32)
    got = spmv(torch.from_numpy(vals), torch.from_numpy(cols),
               torch.from_numpy(x))
    args = (jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(x))
    oracle = np.asarray(ref_oracles.spmv_bsr_ref(*args, nbr * bm))
    pallas = np.asarray(ref_spmv_mod.spmv_bsr(*args, interpret=True))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-5)
    clamped = np.where(cols >= 0, np.minimum(cols, nbc - 1), cols)
    assert torch.equal(got, spmv(torch.from_numpy(vals),
                                 torch.from_numpy(clamped),
                                 torch.from_numpy(x)))


@pytest.mark.parametrize("M,K,density,bm,bk", [
    (64, 256, 0.25, 8, 128),
    (61, 300, 0.1, 8, 128),      # ragged block row and block column
    (40, 512, 0.0, 8, 128),      # all-empty rows
    (512, 512, 0.25, 8, 128),    # the reference example's size
    (33, 70, 0.5, 4, 32),
])
def test_csr_to_bsr_identical_to_reference(M, K, density, bm, bk):
    _, indptr, indices, data = _random_csr(M, K, density, seed=M + K)
    got_v, got_c = csr_to_bsr(indptr, indices, data, (M, K), bm=bm, bk=bk)
    want_v, want_c = ref_csr_to_bsr(indptr, indices, data, (M, K),
                                    bm=bm, bk=bk)
    assert got_v.dtype == want_v.dtype and got_c.dtype == want_c.dtype
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_v, want_v)


def test_reference_state_carries_across_to_tensors():
    """interop hands the reference's numpy SpMV state to the kernels:
    same values, same dtypes, on the named device."""
    _, indptr, indices, data = _random_csr(64, 256, 0.25)
    vals, cols = ref_csr_to_bsr(indptr, indices, data, (64, 256))
    x = _RNG.normal(size=256).astype(np.float32)
    st = interop.spmv_state_to_torch(
        {"indptr": indptr, "indices": indices, "data": data,
         "bsr_values": vals, "bsr_col_ids": cols, "x": x}, "cpu")
    assert st["bsr_col_ids"].dtype == torch.int32
    assert st["bsr_values"].device == torch.device("cpu")
    np.testing.assert_array_equal(st["indptr"].numpy(), indptr)
    got = spmv(st["bsr_values"], st["bsr_col_ids"], st["x"]).numpy()
    want = np.asarray(ref_spmv(jnp.asarray(vals), jnp.asarray(cols),
                               jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(KeyError):
        interop.spmv_state_to_torch({"csr": indptr}, "cpu")


def _aligned_view(shape, offset_floats):
    """A contiguous float32 tensor of ``shape`` whose data starts
    ``offset_floats`` floats past a 64-byte-aligned base."""
    n = int(np.prod(shape))
    base = torch.zeros(n + 32)
    skip = (-base.data_ptr() // 4) % 16 + offset_floats
    return base[skip:skip + n].view(shape)


@pytest.mark.parametrize("shape,offset,want", [
    ((512, 32, 8, 128), 0, RING),     # Table-I: 4 KB blocks, 16-byte rows
    ((4, 3, 8, 130), 0, SCALAR),      # bk = 130: rows not 16-byte multiples
    ((4, 3, 8, 128), 1, SCALAR),      # a view 4 bytes past an aligned base
    ((2, 2, 64, 32), 0, RING),        # bm > 32
    ((2, 2, 64, 1024), 0, SCALAR),    # a 256 KB block: two do not fit
])
def test_spmv_route(shape, offset, want):
    values = _aligned_view(shape, offset)
    x = _aligned_view((4 * shape[3],), 0)
    assert spmv_route(values, x) == want
    assert spmv_route(values, _aligned_view((4 * shape[3],), 2)) == SCALAR


@pytest.mark.parametrize("nbr,nnz,bm,bk", [
    (3, 5, 64, 8),        # bm = 64, past the old kernel's 32
    (2, 12_300, 1, 4),    # more slots per block row than the old 12,288
])
def test_spmv_takes_any_bm_and_nnz(nbr, nnz, bm, bk):
    """No limit on bm or slots per block row: the wrapper matches the
    reference's Pallas kernel (interpret mode) where it computes."""
    rng = np.random.default_rng(nnz)
    vals = rng.normal(size=(nbr, nnz, bm, bk)).astype(np.float32)
    cols = rng.integers(-1, nnz + 2, size=(nbr, nnz)).astype(np.int32)
    x = rng.normal(size=((nnz + 2) * bk,)).astype(np.float32)
    got = spmv(torch.from_numpy(vals), torch.from_numpy(cols),
               torch.from_numpy(x)).numpy()
    want = np.asarray(ref_spmv_mod.spmv_bsr(
        jnp.asarray(vals), jnp.asarray(cols), jnp.asarray(x),
        interpret=True))
    assert got.shape == (nbr * bm,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# running max
# ---------------------------------------------------------------------------

def _scan_input(n, pattern, dtype, seed):
    rng = np.random.default_rng(seed)
    if pattern == "trending":      # the solver's b - cumsum(c) shape
        a = rng.integers(0, 1000, n) - np.cumsum(rng.integers(1, 9, n))
    elif pattern == "increasing":
        a = np.cumsum(rng.integers(0, 5, n))
    else:                          # "wide": values above 2^31
        a = rng.integers(-(1 << 40), 1 << 40, n)
    return a.astype(dtype)


@pytest.mark.parametrize("n", [1, 1023, 1024, 4097, 1 << 20])
@pytest.mark.parametrize("pattern,dtype", [
    ("trending", np.int64), ("increasing", np.int64), ("wide", np.int64),
    ("trending", np.int32),
])
def test_running_max_plain_bit_identical(n, pattern, dtype):
    a = _scan_input(n, pattern, dtype, seed=n)
    got = running_max(torch.from_numpy(a)).numpy()
    assert got.dtype == a.dtype
    np.testing.assert_array_equal(got, np.maximum.accumulate(a))
    np.testing.assert_array_equal(got, ref_engine._running_max_np(a.copy()))


def test_engine_torch_on_cpu_matches_numpy():
    a = _scan_input(port_engine.JIT_MIN_ELEMS + 17, "wide", np.int64, 3)
    want = ref_engine._running_max_np(a.copy())
    with port_engine.use("torch"):
        got = port_engine.running_max(a.copy())
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_running_max_plain_folds_in_the_carry(dtype):
    """The carry is one value folded in front of x: the scan of
    [carry, *x] without its first value."""
    a = _scan_input(5000, "wide", dtype, 8)
    for c in (a.min() - 1, a[:100].max(), a.max() + 1):
        carry = torch.tensor([c], dtype=torch.from_numpy(a).dtype)
        got = running_max(torch.from_numpy(a), carry=carry).numpy()
        want = np.maximum.accumulate(np.concatenate([[c], a]).astype(dtype))
        np.testing.assert_array_equal(got, want[1:])


@pytest.mark.parametrize("n", [1, CHUNK - 1, CHUNK, CHUNK + 1,
                               (1 << 20) + 12345])
@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_running_max_round_trip_chunks_on_the_cpu(n, dtype):
    """The engine's chunked round trip, each chunk carrying in the last
    value of the one before, on the CPU with the plain version as its
    scan: in place, bit for bit np.maximum.accumulate at every chunk
    edge; int64 values above 2^31."""
    a = _scan_input(n, "wide", dtype, seed=n)
    want = np.maximum.accumulate(a)
    b = a.copy()
    assert running_max_host(b, torch.device("cpu")) is b
    np.testing.assert_array_equal(b, want)
    if n > port_engine.JIT_MIN_ELEMS:
        with port_engine.use("torch"):
            c = a.copy()
            port_engine.running_max(c)
        np.testing.assert_array_equal(c, want)
    if dtype == np.int64 and n > 1:
        assert np.abs(a).max() > 1 << 31


def test_running_max_round_trip_writes_through_a_strided_view():
    base = _scan_input(2 * (port_engine.JIT_MIN_ELEMS + 5), "trending",
                       np.int64, 9)
    want = base.copy()
    want[::2] = np.maximum.accumulate(base[::2])
    with port_engine.use("torch"):
        port_engine.running_max(base[::2])
    np.testing.assert_array_equal(base, want)


def test_cpu_tensors_never_touch_the_kernel_library():
    _, indptr, indices, data = _random_csr(16, 128, 0.5)
    vals, cols = csr_to_bsr(indptr, indices, data, (16, 128))
    spmv(torch.from_numpy(vals), torch.from_numpy(cols),
         torch.zeros(128))
    running_max(torch.arange(5000))
    with port_engine.use("torch"):
        port_engine.running_max(np.arange(1 << 16, dtype=np.int64))
    assert _lib.counts() == dict.fromkeys(_lib.SIGNATURES, 0)
    assert {"spmv_bsr", "running_max"} <= set(_lib.counts())
    assert _lib._libs == {}


def test_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(TypeError):
        running_max(torch.zeros(8))
    with pytest.raises(ValueError, match="carry"):
        running_max(torch.zeros(8, dtype=torch.int64),
                    carry=torch.zeros(2, dtype=torch.int64))
    with pytest.raises(TypeError):
        running_max_host(np.zeros(8, np.float32), torch.device("cpu"))
    with pytest.raises(ValueError):
        spmv(torch.zeros(1, 1, 8, 128), torch.zeros(1, 1, dtype=torch.int32),
             torch.zeros(100))


# ---------------------------------------------------------------------------
# The CUDA kernels against their plain versions (skip without a card)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_spmv_bsr_kernel_matches_plain():
    dev = _needs_card()
    dense, indptr, indices, data = _random_csr(61, 300, 0.25)
    vals, cols = csr_to_bsr(indptr, indices, data, (61, 300))
    x = _RNG.normal(size=(cols.shape[1] + 2) * 128).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (vals, cols, x)]
    got = spmv(*args)
    want = ref.spmv_bsr_ref(*args, vals.shape[0] * 8)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert _lib.counts()["spmv_bsr"] == 1


def _one_hot_bsr(nbr, nnz, bm, bk, seed):
    """BSR blocks with distinct block columns per row, about a fifth of the
    slots padding (−1), and x one-hot on one column: y is exactly that
    column of A."""
    rng = np.random.default_rng(seed)
    nbc = nnz + 3
    vals = rng.normal(size=(nbr, nnz, bm, bk)).astype(np.float32)
    cols = np.stack([rng.permutation(nbc)[:nnz] for _ in range(nbr)])
    cols[rng.random((nbr, nnz)) < 0.2] = -1
    hot = int(rng.integers(0, nbc * bk))
    x = np.zeros(nbc * bk, np.float32)
    x[hot] = 1.0
    column = np.zeros((nbr, bm), np.float32)
    br, slot = np.nonzero(cols == hot // bk)
    column[br] = vals[br, slot, :, hot % bk]
    return vals, cols.astype(np.int32), x, column.reshape(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("design", [RING, SCALAR])
@pytest.mark.parametrize("bm", [1, 8, 32, 64])
@pytest.mark.parametrize("nbr", [5, 1000])
def test_spmv_one_hot_x_bit_for_bit(design, bm, nbr):
    """x one-hot on column c makes y exactly column c of A: a slot lost or
    read twice at a stage, ring-wrap or block-row edge, or a row owned by
    the wrong warp, moves a bit.  37 slots (not a multiple of any ring
    depth) with padding, fewer and far more block rows than SMs."""
    from repro_torch.kernels.spmv import _launch
    dev = _needs_card()
    vals, cols, x, want = _one_hot_bsr(nbr, 37, bm, 32, seed=bm + nbr)
    args = [torch.from_numpy(a).to(dev) for a in (vals, cols, x)]
    got = _launch(*args, design)
    assert torch.equal(got.cpu(), torch.from_numpy(want))
    assert _lib.routes()["spmv_bsr"] == {design: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("nbr,nnz,bm,bk,want", [
    (512, 32, 8, 128, RING),      # the Table-I shape
    (7, 13_000, 2, 8, RING),      # more slots than the old kernel took
    (9, 5, 64, 130, SCALAR),      # bk = 130
])
def test_spmv_bsr_kernel_takes_its_route(nbr, nnz, bm, bk, want):
    dev = _needs_card()
    vals, cols, x, column = _one_hot_bsr(nbr, nnz, bm, bk, seed=nnz)
    args = [torch.from_numpy(a).to(dev) for a in (vals, cols, x)]
    assert torch.equal(spmv(*args).cpu(), torch.from_numpy(column))
    assert _lib.routes()["spmv_bsr"] == {want: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1023, 1025, (1 << 20) + 7])
@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_running_max_kernel_bit_identical(n, dtype):
    dev = _needs_card()
    a = _scan_input(n, "wide" if dtype == np.int64 else "trending", dtype, n)
    got = running_max(torch.from_numpy(a).to(dev)).cpu().numpy()
    np.testing.assert_array_equal(got, np.maximum.accumulate(a))


@pytest.mark.cuda
@pytest.mark.parametrize("n,dtype", [((1 << 24) + 3, np.int32),
                                     ((1 << 23) + 5, np.int64),
                                     (4097, np.int32), (2049, np.int64)])
@pytest.mark.parametrize("pattern", ["increasing", "wide"])
def test_running_max_look_back_over_many_tiles(n, dtype, pattern):
    """One launch, bit for bit, over one tile and a value (4097 int32,
    2049 int64) and over 4,097 tiles, thirty times the SMs: tiles then
    look back past predecessors still loading, and (increasing values)
    every tile's prefix is its predecessor's last value."""
    dev = _needs_card()
    a = _scan_input(n, pattern, dtype, seed=n)
    got = running_max(torch.from_numpy(a).to(dev))
    assert _lib.counts()["running_max"] == 1
    np.testing.assert_array_equal(got.cpu().numpy(), np.maximum.accumulate(a))


@pytest.mark.cuda
def test_running_max_replays_in_a_cuda_graph():
    """Three calls captured in one CUDA graph and replayed on new inputs:
    the look-back state the kernel leaves zeroed carries across calls and
    replays with no memset between them."""
    dev = _needs_card()
    shapes = [((1 << 20) + 5, np.int32), (3000, np.int64), (1, np.int32)]
    xs = [torch.from_numpy(_scan_input(n, "wide", d, n)).to(dev)
          for n, d in shapes]
    outs = [torch.empty_like(x) for x in xs]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for x, o in zip(xs, outs):
            running_max(x, out=o)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for x, o in zip(xs, outs):
            running_max(x, out=o)
    for rep in range(3):
        fresh = [_scan_input(n, "increasing" if rep % 2 else "wide", d,
                             100 * rep + n) for n, d in shapes]
        for x, o, f in zip(xs, outs, fresh):
            x.copy_(torch.from_numpy(f))
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for o, f in zip(outs, fresh):
            np.testing.assert_array_equal(o.cpu().numpy(),
                                          np.maximum.accumulate(f))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_running_max_kernel_carry_and_unaligned_views(dtype):
    """The carry cell folds in front of x, on 16-byte-aligned tensors
    (vector loads) and on views one value past (scalar loads)."""
    dev = _needs_card()
    a = _scan_input(100_003, "wide", dtype, 4)
    want = np.maximum.accumulate(a)[1:]
    base = torch.from_numpy(a).to(dev)
    x, carry = base[1:], base[:1]
    out = torch.empty(x.shape[0] + 1, dtype=x.dtype, device=dev)[1:]
    for xx, oo in ((x, None), (x.clone(), None), (x.clone(), out)):
        got = running_max(xx, carry=carry, out=oo)
        np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert _lib.counts()["running_max"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, CHUNK - 1, CHUNK, CHUNK + 1,
                               (1 << 20) + 12345])
@pytest.mark.parametrize("dtype", [np.int64, np.int32])
def test_running_max_round_trip_on_the_card(n, dtype):
    """The engine's pinned, chunked round trip on the card: one launch a
    chunk, each carrying in the one before; in place, bit for bit."""
    dev = _needs_card()
    a = _scan_input(n, "wide", dtype, seed=n)
    b = a.copy()
    assert running_max_host(b, dev) is b
    np.testing.assert_array_equal(b, np.maximum.accumulate(a))
    assert _lib.counts()["running_max"] == -(-n // CHUNK)


def _one_hot_clamped(nbr, nnz, bm, bk, seed):
    """BSR blocks whose ids are distinct below the last block column,
    with about half the block rows given one id at or past it (clamped
    to it) and a fifth of the slots padding; x one-hot in the last x tile,
    so y is exactly the clamped slot's column of A."""
    rng = np.random.default_rng(seed)
    nbc = nnz + 3
    vals = rng.normal(size=(nbr, nnz, bm, bk)).astype(np.float32)
    cols = np.stack([rng.permutation(nbc - 1)[:nnz] for _ in range(nbr)])
    rows = np.nonzero(rng.random(nbr) < 0.5)[0]
    cols[rows, rng.integers(0, nnz, rows.size)] = \
        nbc - 1 + rng.integers(0, 5, rows.size)
    cols[rng.random((nbr, nnz)) < 0.2] = -1
    hot = int(rng.integers(0, bk))
    x = np.zeros(nbc * bk, np.float32)
    x[(nbc - 1) * bk + hot] = 1.0
    column = np.zeros((nbr, bm), np.float32)
    br, slot = np.nonzero(cols >= nbc - 1)
    column[br] = vals[br, slot, :, hot]
    return vals, cols.astype(np.int32), x, column.reshape(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("design", [RING, SCALAR])
@pytest.mark.parametrize("nbr", [5, 1000])
def test_spmv_clamps_column_ids_on_the_card(design, nbr):
    """Ids past the last block column read the last x tile on both
    designs (neither reads past x): with x one-hot there, y is exactly
    the clamped slot's column, bit for bit, as the plain version."""
    from repro_torch.kernels.spmv import _launch
    dev = _needs_card()
    vals, cols, x, want = _one_hot_clamped(nbr, 37, 8, 32, seed=nbr)
    args = [torch.from_numpy(a).to(dev) for a in (vals, cols, x)]
    got = _launch(*args, design)
    assert torch.equal(got.cpu(), torch.from_numpy(want))
    assert torch.equal(got, ref.spmv_bsr_ref(*args, nbr * 8))
    assert _lib.routes()["spmv_bsr"] == {design: 1}
