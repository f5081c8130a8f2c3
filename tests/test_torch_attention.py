"""The port's attention kernels (repro_torch.kernels) against the JAX
reference.

On the CPU ``ops.flash_attention`` and ``ops.decode_attention`` run their
plain versions, and are held here against the reference's
``repro.kernels.ops`` (Pallas in interpret mode) on the same numpy
inputs, at the tolerances of tests/test_kernels.py: fp32 3e-5 (online
softmax over tiles against one contraction), 1e-4 for decode against the
last row of prefill.  The real layout (GQA 9/3, d=64) and the reduced
test configs' (MQA 4/1, d=16) are both covered.  The tests marked
``cuda`` hold each CUDA kernel against its plain version and skip where
there is no card.
"""

import importlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch
from repro.kernels import ops as ref_ops
from repro_torch.kernels import _lib, ops, ref
from repro_torch.kernels.flash_attention import (CUDA_CORE, DECODE_TILE,
                                                MMA, decode_attention,
                                                decode_design, decode_split,
                                                flash_attention,
                                                prefill_route)

#: the reference's Pallas module (its package exports the function under
#: the module's name)
ref_fa = importlib.import_module("repro.kernels.flash_attention")
BF16 = dict(rtol=2e-2, atol=2e-2)

FP32 = dict(rtol=3e-5, atol=3e-5)
#: (B, Hq, Hkv, d): smollm-135m's layout, and reduced smollm's
LAYOUTS = [(2, 9, 3, 64), (2, 4, 1, 16)]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    repro_torch.set_device("cpu")
    _lib.reset_counts()
    yield
    repro_torch.set_device(None)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    return torch.device("cuda")


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _both(fn_port, fn_ref, *arrays, **kw):
    got = fn_port(*(torch.from_numpy(a) for a in arrays), **kw)
    want = fn_ref(*(jnp.asarray(a) for a in arrays), **kw)
    return got.numpy(), np.asarray(want)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS, ids=["9-3-d64", "4-1-d16"])
@pytest.mark.parametrize("Sq", [5, 16, 40])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_reference(layout, Sq, causal):
    B, Hq, Hkv, d = layout
    rng = np.random.default_rng(Sq + d)
    q = _normal(rng, B, Hq, Sq, d)
    k, v = _normal(rng, B, Hkv, Sq, d), _normal(rng, B, Hkv, Sq, d)
    if not causal and Sq % 8:
        # both packages refuse to pad keys for non-causal attention
        with pytest.raises(ValueError, match="non-causal"):
            ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=False)
        with pytest.raises(ValueError, match="non-causal"):
            ref_ops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                    causal=False)
        return
    got, want = _both(ops.flash_attention, ref_ops.flash_attention, q, k, v,
                      causal=causal)
    assert got.shape == (B, Hq, Sq, d) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **FP32)


@pytest.mark.parametrize("Sq,Sk", [(5, 16), (16, 40), (40, 16)])
def test_flash_attention_causal_mask_aligns_from_zero(Sq, Sk):
    """Query i sees keys 0..i whatever Sk is, as the reference's kernel
    does (its oracle would offset by Sk − Sq); with Sq > Sk the queries
    past Sk also see the reference's zero-padded keys."""
    rng = np.random.default_rng(Sq * Sk)
    q = _normal(rng, 1, 9, Sq, 64)
    k, v = _normal(rng, 1, 3, Sk, 64), _normal(rng, 1, 3, Sk, 64)
    got, want = _both(ops.flash_attention, ref_ops.flash_attention, q, k, v)
    np.testing.assert_allclose(got, want, **FP32)


def test_flash_attention_keeps_bf16_and_scale():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_normal(rng, 1, 4, 16, 16)).bfloat16()
    k = torch.from_numpy(_normal(rng, 1, 1, 16, 16)).bfloat16()
    out = flash_attention(q, k, k, scale=0.5)
    assert out.dtype == torch.bfloat16
    want = ref.flash_attention_ref(q.float(), k.float(), k.float(),
                                   scale=0.5)
    torch.testing.assert_close(out.float(), want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, MMA),
                                        (torch.float32, CUDA_CORE)])
def test_prefill_route_is_chosen_from_dtype(dtype, want):
    """bf16 (the serving path's dtype) on the tensor cores, fp32 (the
    exactness check's) on the CUDA cores, for every head dim taken."""
    assert prefill_route(dtype) == want


def _mma_prefill_model(q, k, v, *, causal, tile=64):
    """The tensor-core prefill's arithmetic in plain PyTorch: bf16 inputs,
    S in fp32, KV in 64-key tiles with the online rescale, l summed from
    the fp32 P, P rounded to bf16 before P·V (fp32 sums), the output
    rounded to bf16."""
    B, Hq, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    mask = -0.7 * float(np.finfo(np.float32).max)
    qf = q.float()
    kf, vf = (t.float().repeat_interleave(Hq // Hkv, 1) for t in (k, v))
    m = torch.full((B, Hq, Sq), mask)
    l = torch.zeros(B, Hq, Sq)
    acc = torch.zeros(B, Hq, Sq, d)
    for k0 in range(0, Sk, tile):
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kt) / math.sqrt(d)
        if causal:
            keys = torch.arange(k0, k0 + kt.shape[2])
            s = s.masked_fill(keys[None, :] > torch.arange(Sq)[:, None],
                              mask)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.bfloat16().float(), vt)
        m = m_new
    return (acc / l.clamp_min(1e-20)[..., None]).bfloat16()


@pytest.mark.parametrize("layout", LAYOUTS, ids=["9-3-d64", "4-1-d16"])
@pytest.mark.parametrize("Sq", [5, 16, 40])
@pytest.mark.parametrize("causal", [True, False])
def test_mma_prefill_arithmetic_meets_the_bf16_bar(layout, Sq, causal):
    """Rounding P to bf16 before P·V (the tensor-core kernel's one
    departure from the Pallas kernel, which multiplies P·V in fp32) stays
    within the bf16 bar against the reference's kernel (interpret mode,
    one block) on bf16 inputs."""
    B, Hq, Hkv, d = layout
    rng = np.random.default_rng(100 + Sq + d)
    arrays = [_normal(rng, B, h, Sq, d) for h in (Hq, Hkv, Hkv)]
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrays)
    got = _mma_prefill_model(q, k, v, causal=causal)
    want = ref_fa.flash_attention(
        *(jnp.asarray(a, dtype=jnp.bfloat16) for a in arrays),
        causal=causal, block_q=Sq, block_k=Sq, interpret=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32), **BF16)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS, ids=["9-3-d64", "4-1-d16"])
@pytest.mark.parametrize("S", [40, 300])
def test_decode_attention_matches_reference(layout, S):
    B, Hq, Hkv, d = layout
    rng = np.random.default_rng(S + d)
    q = _normal(rng, B, Hq, d)
    kc, vc = _normal(rng, B, Hkv, S, d), _normal(rng, B, Hkv, S, d)
    lengths = np.array([1, S][:B] if S == 40 else
                       rng.integers(1, S + 1, size=B), np.int32)
    got, want = _both(ops.decode_attention, ref_ops.decode_attention, q, kc,
                      vc, lengths)
    assert got.shape == (B, Hq, d)
    np.testing.assert_allclose(got, want, **FP32)


def test_decode_matches_prefill_last_token():
    """decode(q_last) == prefill(full)[:, :, -1] (tests/test_kernels.py)."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(_normal(rng, 1, 9, 40, 64))
    k = torch.from_numpy(_normal(rng, 1, 3, 40, 64))
    v = torch.from_numpy(_normal(rng, 1, 3, 40, 64))
    full = ops.flash_attention(q, k, v)
    dec = ops.decode_attention(q[:, :, -1], k, v, torch.tensor([40]))
    torch.testing.assert_close(dec, full[:, :, -1], rtol=1e-4, atol=1e-4)


def test_decode_length_zero_gives_zeros():
    """The kernel's semantics, not the oracle's NaN."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(_normal(rng, 2, 4, 16))
    kc = torch.from_numpy(_normal(rng, 2, 1, 24, 16))
    out = decode_attention(q, kc, kc, torch.tensor([0, 7], dtype=torch.int32))
    assert torch.equal(out[0], torch.zeros(4, 16))
    want = ref.decode_attention_ref(q[1:], kc[1:], kc[1:], torch.tensor([7]))
    torch.testing.assert_close(out[1:], want)


def test_wrappers_reject_bad_shapes():
    q = torch.zeros(1, 4, 8, 16)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q, torch.zeros(1, 3, 8, 16), torch.zeros(1, 3, 8, 16))
    with pytest.raises(ValueError, match="do not match"):
        flash_attention(q, torch.zeros(1, 2, 8, 16), torch.zeros(1, 2, 8, 8))
    with pytest.raises(ValueError, match="do not match"):
        decode_attention(q[:, :, 0], torch.zeros(1, 2, 8, 16),
                         torch.zeros(1, 2, 8, 16), torch.zeros(2))
    assert _lib.counts() == dict.fromkeys(_lib.SIGNATURES, 0)
    assert _lib._libs == {}


def _split_decode_model(q, k_cache, v_cache, lengths, C, *, warps=8):
    """The cluster decode kernel's arithmetic in plain PyTorch, fp32: rank r
    of C takes keys [r·chunk, min((r+1)·chunk, len)), chunk = ceil(len / C)
    rounded up to 8 keys; its range streams in tiles of DECODE_TILE keys,
    of which warp w takes keys [8w, 8w+8) and keeps its own online-softmax
    (m, l, acc) across the tiles; a rank combines its warps, and rank 0
    combines the ranks.  Output in q's dtype."""
    B, Hq, d = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G, KW = Hq // Hkv, DECODE_TILE // warps
    mask = -0.7 * float(np.finfo(np.float32).max)
    scale = 1.0 / math.sqrt(d)

    def combine(states):
        ms = torch.stack([st[0] for st in states])          # (n, G)
        mx = torch.maximum(ms.amax(0), torch.tensor(mask))
        f = torch.exp(ms - mx)
        l = (torch.stack([st[1] for st in states]) * f).sum(0)
        acc = (torch.stack([st[2] for st in states]) * f[..., None]).sum(0)
        return mx, l, acc

    out = torch.zeros(B, Hq, d)
    for b in range(B):
        n_len = int(min(max(int(lengths[b]), 0), S))
        chunk = -(-(-(-n_len // C)) // 8) * 8
        for hk in range(Hkv):
            qg = q[b, hk * G:(hk + 1) * G].float()           # (G, d)
            kf, vf = k_cache[b, hk].float(), v_cache[b, hk].float()
            ranks = []
            for r in range(C):
                k0 = min(r * chunk, n_len)
                k1 = min(k0 + chunk, n_len)
                wst = [[torch.full((G,), mask), torch.zeros(G),
                        torch.zeros(G, d)] for _ in range(warps)]
                for t0 in range(k0, k1, DECODE_TILE):
                    for w, st in enumerate(wst):
                        a = t0 + w * KW
                        e = min(a + KW, k1, t0 + DECODE_TILE)
                        if a >= e:
                            continue
                        s = qg @ kf[a:e].T * scale              # (G, keys)
                        m_new = torch.maximum(st[0], s.amax(1))
                        p = torch.exp(s - m_new[:, None])
                        alpha = torch.exp(st[0] - m_new)
                        st[1] = st[1] * alpha + p.sum(1)
                        st[2] = st[2] * alpha[:, None] + p @ vf[a:e]
                        st[0] = m_new
                ranks.append(combine(wst))
            _, l, acc = combine(ranks)
            out[b, hk * G:(hk + 1) * G] = acc / l.clamp_min(1e-20)[:, None]
    return out.to(q.dtype)


@pytest.mark.parametrize("layout", LAYOUTS, ids=["9-3-d64", "4-1-d16"])
@pytest.mark.parametrize("C", [1, 2, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_split_decode_arithmetic_matches_reference(layout, C, dtype):
    """The cluster decode's split (C contiguous key ranges, 64-key tiles,
    8-key warp slices, each with its own (m, l, acc), combined per rank and
    then across ranks) against the reference's Pallas decode kernel
    (interpret mode), at lengths 0, 1, fewer than C, exactly C·64, S and
    ragged: fp32 1e-4, bf16 2e-2."""
    _, Hq, Hkv, d = layout
    S = 552
    lengths = np.array([0, 1, max(C - 1, 1), C * DECODE_TILE, S, 300, 77],
                       np.int32)
    B = len(lengths)
    rng = np.random.default_rng(C * 10 + d)
    arrays = [_normal(rng, B, Hq, d), _normal(rng, B, Hkv, S, d),
              _normal(rng, B, Hkv, S, d)]
    q, kc, vc = (torch.from_numpy(a).to(dtype) for a in arrays)
    got = _split_decode_model(q, kc, vc, torch.from_numpy(lengths), C)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = ref_ops.decode_attention(
        *(jnp.asarray(a, dtype=jdt) for a in arrays), jnp.asarray(lengths))
    tol = BF16 if dtype == torch.bfloat16 else dict(rtol=1e-4, atol=1e-4)
    assert got.dtype == dtype and got.shape == (B, Hq, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, dtype=np.float32), **tol)


@pytest.mark.parametrize("B,Hkv,S,sms,want", [
    (8, 3, 552, 132, 8),        # the serving path: 24 clusters x 8 CTAs
    (40, 3, 552, 132, 2),       # 120 clusters: two CTAs each fill the card
    (66, 2, 552, 132, 1),       # B·Hkv >= the SM count: one CTA a cluster
    (8, 3, 61, 132, 1),         # less than a tile per CTA: no split
    (8, 3, 200, 132, 2),        # three tiles of S at most: two CTAs
    (1, 1, 1 << 20, 132, 8),    # a huge cache: never more than 8
    (8, 3, 552, 24, 1),         # a smaller card already filled
])
def test_decode_split_fills_the_card(B, Hkv, S, sms, want):
    c = decode_split(B, Hkv, S, sms)
    assert c == want
    assert c & (c - 1) == 0 and c * DECODE_TILE <= max(S, DECODE_TILE)
    assert decode_design(c) == f"cluster split-S ×{c}"


# ---------------------------------------------------------------------------
# The CUDA kernels against their plain versions (skip without a card)
# ---------------------------------------------------------------------------

def _cuda_inputs(dev, dtype, seed, *shapes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(_normal(rng, *s)).to(dev, dtype) for s in shapes]


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Sk,d", [
    (2, 9, 3, 512, 512, 64),     # smollm-135m's layout at the path's S
    (2, 4, 1, 40, 40, 16),       # reduced smollm
    (1, 8, 2, 100, 100, 128),    # largest d, ragged S
    (1, 2, 2, 5, 37, 40),        # Sq < Sk, d not a power of two
    (1, 6, 3, 70, 33, 32),       # Sq > Sk
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(B, Hq, Hkv, Sq, Sk, d, causal,
                                              dtype):
    dev = _needs_card()
    q, k, v = _cuda_inputs(dev, dtype, Sq + d, (B, Hq, Sq, d),
                           (B, Hkv, Sk, d), (B, Hkv, Sk, d))
    got = flash_attention(q, k, v, causal=causal)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert got.dtype == dtype
    assert _lib.counts()["flash_attention"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("S,d", [(16, 16), (40, 40), (64, 64),
                                 (128, 128)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_mma_one_hot_values_bit_for_bit(S, d, causal):
    """V one-hot in d (key j writes column perm[j]) and scores that are
    either 0 or -65536·scale (q = 256·e_a, k = -256·e_b), so every weight
    is exactly 0 or 1/n: the bf16 kernel equals its plain version bit for
    bit, and a wrong ldmatrix (transposed) layout shows as moved columns."""
    dev = _needs_card()
    rng = np.random.default_rng(S + d + causal)
    B, Hq, Hkv = 2, 4, 2
    q = torch.zeros(B, Hq, S, d)
    k = torch.zeros(B, Hkv, S, d)
    v = torch.zeros(B, Hkv, S, d)
    for bh in np.ndindex(B, Hq):
        q[bh][torch.arange(S), torch.from_numpy(rng.integers(0, d, S))] = 256
    for bh in np.ndindex(B, Hkv):
        k[bh][torch.arange(S), torch.from_numpy(rng.integers(0, d, S))] = -256
        v[bh][torch.arange(S), torch.from_numpy(rng.permutation(d)[:S])] = 1
    q, k, v = (t.to(dev, torch.bfloat16) for t in (q, k, v))
    got = flash_attention(q, k, v, causal=causal)
    assert torch.equal(got, ref.flash_attention_ref(q, k, v, causal=causal))
    assert _lib.routes()["flash_attention"] == {MMA: 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_takes_its_route(dtype):
    dev = _needs_card()
    q, k, v = _cuda_inputs(dev, dtype, 7, (2, 9, 64, 64), (2, 3, 64, 64),
                           (2, 3, 64, 64))
    flash_attention(q, k, v)
    assert _lib.routes()["flash_attention"] == {
        prefill_route(dtype): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("B,Hq,Hkv,S,d", [
    (8, 9, 3, 552, 64),          # the serving path's cache
    (3, 4, 1, 24, 16),
    (2, 8, 2, 300, 128),
    (2, 2, 1, 61, 40),
    (4, 9, 3, 4096, 64),         # long caches: many tiles per CTA
    (2, 8, 2, 8192, 128),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain(B, Hq, Hkv, S, d, dtype):
    dev = _needs_card()
    q, kc, vc = _cuda_inputs(dev, dtype, S + d, (B, Hq, d), (B, Hkv, S, d),
                             (B, Hkv, S, d))
    lengths = torch.tensor(([0, 1, 17, S, 256 % S + 1, S - 1, 33 % S, 2]
                            )[:B], dtype=torch.int32, device=dev)
    got = decode_attention(q, kc, vc, lengths)
    want = ref.decode_attention_ref(q, kc, vc, lengths)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert _lib.counts()["decode_attention"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("S", [552, 4096, 61])
@pytest.mark.parametrize("d", [16, 40, 64, 128])
@pytest.mark.parametrize("group", [1, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_one_hot_values_bit_for_bit(S, d, group, dtype):
    """K = 0 makes every score 0 and every weight of a valid key exactly 1,
    and V's rows are one-hot: each output is exactly (keys below the
    length hot in that dim) / length, rounded once to the output type.
    A key counted twice across the cluster's ranks, or lost at a range,
    tile or warp edge, moves a bit."""
    dev = _needs_card()
    rng = np.random.default_rng(S + d + group)
    lengths = [min(n, S) for n in (0, 1, 7, 65, 513, S)]
    B, Hkv = len(lengths), 2
    hot = torch.from_numpy(rng.integers(0, d, size=(B, Hkv, S)))
    v = torch.nn.functional.one_hot(hot, d).float()
    q = torch.from_numpy(_normal(rng, B, Hkv * group, d))
    k = torch.zeros(B, Hkv, S, d)
    got = decode_attention(*(t.to(dev, dtype) for t in (q, k, v)),
                           torch.tensor(lengths, dtype=torch.int32,
                                        device=dev))
    counts = torch.stack([v[b, :, :n].sum(1) for b, n in enumerate(lengths)])
    want = counts / torch.tensor(lengths).float().clamp_min(1)[:, None, None]
    want = want.repeat_interleave(group, 1).to(dtype)
    assert torch.equal(got.cpu(), want)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert _lib.routes()["decode_attention"] == {
        decode_design(decode_split(B, Hkv, S, sms)): 1}


@pytest.mark.cuda
def test_kernels_reject_what_they_do_not_take():
    dev = _needs_card()
    q = torch.zeros(1, 4, 8, 64, device=dev)
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros(1, 4, 8, 136, device=dev)
        flash_attention(big, big, big)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(1, 8, 4, 64, device=dev).transpose(1, 2)
        flash_attention(t, t, t)
    with pytest.raises(TypeError, match="int32"):
        decode_attention(q[:, :, 0].contiguous(), q, q,
                         torch.ones(1, dtype=torch.int64, device=dev))
    assert _lib.counts() == dict.fromkeys(_lib.SIGNATURES, 0)
