"""The port's torch N-way replay core (``repro_torch.core.engine``) against
the reference's numpy engine.

The same adversarial address streams go through the reference's
``BatchedCacheSim`` on its numpy engine and the port's on the torch
engine selected by name (so every lookup takes the torch core, here on
CPU tensors): hit flags, the exported recency stacks and the largest tag
must be identical — at 3, 4, 8 and 16 ways, and with tags past 2^31
(int64 stacks).  An auto-selected torch engine keeps the numpy core below
``JIT_MIN_SEGMENTS`` segments; the ``cuda`` case holds the core on the
card.
"""

import numpy as np
import pytest
import torch

import repro_torch
from repro.core import engine as ref_engine
from repro.core.simulator import BatchedCacheSim as RefSim
from repro.core.simulator import CacheConfig as RefConfig
from repro_torch.core import engine as port_engine
from repro_torch.core.simulator import BatchedCacheSim as PortSim
from repro_torch.core.simulator import CacheConfig as PortConfig


@pytest.fixture(autouse=True)
def _policy():
    repro_torch.set_device("cpu")
    yield
    port_engine.select(None)
    repro_torch.set_device(None)


def _patterns(n_sets, ways, n, seed, line=32):
    """Single-set thrashing, a cyclic ways+1 working set (LRU's worst
    case), skewed reuse, runs across segment edges, uniform random."""
    rng = np.random.default_rng(seed)
    stride = line * n_sets
    yield "one_set", rng.integers(0, 3 * ways, n) * stride
    yield "cyclic", (np.arange(n) % (ways + 1)) * stride
    yield "skewed", np.minimum(rng.zipf(1.3, n), 4 * ways) * line
    yield "runs", np.repeat(rng.integers(0, 8 * ways, max(1, n // 7)),
                            7)[:n] * line
    yield "uniform", rng.integers(0, 1 << 22, n) * line


def _replay(ways, addrs_list, *, size_bytes):
    """Each address block looked up in turn (the carried state crosses
    calls) by the reference on numpy and the port on its engine."""
    ref = RefSim(RefConfig(size_bytes=size_bytes, line_bytes=32, ways=ways))
    port = PortSim(PortConfig(size_bytes=size_bytes, line_bytes=32,
                              ways=ways))
    with ref_engine.use("numpy"):
        want = [ref.lookup(a) for a in addrs_list]
    got = [port.lookup(a) for a in addrs_list]
    return want, ref.export_stacks(), got, port.export_stacks()


def _same(want, ref_stacks, got, port_stacks, what):
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w, err_msg=str(what))
    np.testing.assert_array_equal(port_stacks[0], ref_stacks[0],
                                  err_msg=str(what))
    assert port_stacks[1] == ref_stacks[1], what


@pytest.mark.parametrize("ways", [3, 4, 8, 16])
def test_torch_core_equals_the_reference(ways):
    """Each pattern twice in a row (the second lookup starts from the
    first's carried stacks), every call through the torch core."""
    size = ways * 16 * 32
    port_engine.select("torch")
    for name, a in _patterns(16, ways, 4000, seed=ways):
        before = port_engine.counts()["nway_core"]
        res = _replay(ways, [a, a[::-1].copy()], size_bytes=size)
        assert port_engine.counts()["nway_core"] - before == 2, name
        _same(*res, (ways, name))


def test_torch_core_with_tags_past_2_31():
    """Tags past 2^31 make the stacks int64; the torch core keeps the
    dtype, and results stay the reference's."""
    size = 4 * 4 * 32
    stride = 32 * 4
    rng = np.random.default_rng(9)
    addrs = rng.integers(1 << 33, 1 << 36, 2000) * stride
    port_engine.select("torch")
    seen = []
    real = port_engine._nway_core_torch

    def spy(T, *args):
        seen.append(T.dtype)
        return real(T, *args)

    port_engine._nway_core_torch = spy
    try:
        res = _replay(4, [addrs, addrs[:700].copy()], size_bytes=size)
    finally:
        port_engine._nway_core_torch = real
    assert seen == [np.int64, np.int64]
    _same(*res, "large tags")
    assert res[3][1] > (1 << 31)


def test_auto_keeps_numpy_below_the_segment_threshold(monkeypatch):
    """``auto`` resolving to torch takes the torch core only at
    ``JIT_MIN_SEGMENTS`` segments or more; an explicit torch at every
    size.  Results are the same either way."""
    monkeypatch.setattr(port_engine, "current", lambda: "torch")
    monkeypatch.setattr(port_engine, "_explicit", lambda: False)
    cfg = PortConfig(size_bytes=8 * 256 * 32, line_bytes=32, ways=8)
    rng = np.random.default_rng(4)
    small = rng.integers(0, 1 << 16, 300) * 32       # < 512 segments
    big = rng.integers(0, 1 << 22, 40_000) * 32      # > 512 segments
    for addrs, launched in ((small, 0), (big, 1)):
        before = port_engine.counts()["nway_core"]
        got = PortSim(cfg).lookup(addrs)
        assert port_engine.counts()["nway_core"] - before == launched
        with ref_engine.use("numpy"):
            want = RefSim(RefConfig(size_bytes=8 * 256 * 32, line_bytes=32,
                                    ways=8)).lookup(addrs)
        np.testing.assert_array_equal(got, want)
    monkeypatch.setattr(port_engine, "_explicit", lambda: True)
    before = port_engine.counts()["nway_core"]
    PortSim(cfg).lookup(small)
    assert port_engine.counts()["nway_core"] - before == 1


def test_explicit_selection_rule():
    """The torch engine asked for by name is explicit; auto is not."""
    assert not port_engine._explicit()
    with port_engine.use("torch"):
        assert port_engine._explicit()
    with port_engine.use("auto"):
        assert not port_engine._explicit()
    port_engine.select("torch")
    assert port_engine._explicit()


def test_nway_core_direct_on_random_segments():
    """``nway_core`` called directly on segment tables cut by hand: the
    torch and numpy forms agree on hits and stacks, int32 and int64."""
    rng = np.random.default_rng(1)
    W, G, ways = 32, 700, 8
    for dtype in (np.int32, np.int64):
        T = rng.integers(0, 24, (W, G)).astype(dtype)
        T[rng.random((W, G)) < 0.2] = -2
        seg_grp = np.sort(rng.integers(0, 90, G)).astype(np.int32)
        seg_first = np.ones(G, dtype=bool)
        seg_first[1:] = seg_grp[1:] != seg_grp[:-1]
        seg_grp = (np.cumsum(seg_first) - 1).astype(np.int32)
        n_sets = int(seg_grp[-1]) + 1
        carried = np.full((n_sets, ways), -1, dtype=dtype)
        for s in range(n_sets):
            k = rng.integers(0, ways + 1)
            carried[s, :k] = rng.permutation(24)[:k]
        run = np.diff(np.append(np.nonzero(seg_first)[0], G)).max()
        want = port_engine._nway_core_np(T, seg_grp, seg_first, carried,
                                         int(run))
        got = port_engine._nway_core_torch(T, seg_grp, seg_first, carried,
                                           int(run))
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].dtype == dtype


@pytest.mark.cuda
@pytest.mark.parametrize("ways", [4, 8])
def test_torch_core_on_the_card_equals_the_reference(ways):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    repro_torch.set_device("cuda")
    port_engine.select("torch")
    size = ways * 64 * 32
    for name, a in _patterns(64, ways, 60_000, seed=ways):
        _same(*_replay(ways, [a, a[::-1].copy()], size_bytes=size),
              (ways, name))
