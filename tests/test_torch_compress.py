"""The port's int8 gradient compression (``repro_torch.optim.compress``)
against the JAX reference's (``repro.optim.compress``).

Quantization is held bit for bit on the reference's sizes (codes,
scales and the dequantized values: the same fp32 division, round half to
even and clip).  ``compressed_psum`` runs on 8 CPU ranks under gloo
(``launch.mesh.spawn``) and the reference's under ``shard_map`` on 8
forced host devices in a subprocess (``tests/test_substrate.py:103``):
the int8 codes are summed exactly in int32 on both sides, so the results
are equal element for element.
"""

import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
import repro_torch
from repro.optim import compress as ref
from repro_torch.launch.mesh import spawn
from repro_torch.optim import compress

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _port_on_cpu():
    repro_torch.set_device("cpu")
    yield
    repro_torch.set_device(None)


@pytest.mark.parametrize("n", [1, 2, 255, 256, 257, 1000, 1999, 2000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_is_the_references(n, dtype):
    """Codes, scales and the dequantized values bit for bit, on the
    reference's sizes 1-2,000 (``tests/test_substrate.py:89``), with a
    zero chunk and values of very different sizes among them."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n,)).astype(np.float32) * rng.choice(
        [1e-6, 1.0, 1e4], size=n).astype(np.float32)
    x[:min(n, 3)] = 0.0
    xj = jnp.asarray(x, dtype=getattr(jnp, dtype))
    xt = torch.tensor(x).to(getattr(torch, dtype))
    q, scale = compress.quantize_int8(xt)
    qr, scale_r = ref.quantize_int8(xj)
    np.testing.assert_array_equal(q.numpy(), np.asarray(qr))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(scale_r))
    back = compress.dequantize_int8(q, scale, (n,))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(ref.dequantize_int8(qr, scale_r, (n,))))
    # half a step, and the fp32 division's rounding of |x/scale| <= 127
    bound = np.repeat(scale.numpy(), 256)[:n] * (0.5 + 127 * 2.0 ** -23)
    assert (np.abs(back.numpy() - xt.float().numpy()) <= bound).all()


def test_dequantize_int8_shape_and_dtype():
    x = np.random.default_rng(0).normal(size=(3, 50, 7)).astype(np.float32)
    q, scale = compress.quantize_int8(torch.tensor(x), chunk=64)
    qr, scale_r = ref.quantize_int8(jnp.asarray(x), chunk=64)
    got = compress.dequantize_int8(q, scale, x.shape, torch.bfloat16)
    want = ref.dequantize_int8(qr, scale_r, x.shape, jnp.bfloat16)
    assert got.shape == x.shape and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, dtype=np.float32))


def _ref_compressed_psum(xs: np.ndarray, tmp_path) -> np.ndarray:
    """The reference's ``compressed_psum`` of ``xs[r]`` over 8 forced host
    devices under ``shard_map``, in a subprocess."""
    np.save(tmp_path / "xs.npy", xs)
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    code = textwrap.dedent(f"""
        import jax, numpy as np
        from jax.sharding import PartitionSpec as P
        from repro.core import shard_map_compat
        from repro.optim.compress import compressed_psum
        xs = np.load({str(tmp_path / "xs.npy")!r})
        mesh = jax.make_mesh((8,), ("pod",))
        f = jax.jit(shard_map_compat(
            lambda x: compressed_psum(x[0], "pod")[None], mesh=mesh,
            in_specs=P("pod"), out_specs=P("pod")))
        np.save({str(tmp_path / "out.npy")!r}, np.asarray(f(xs)))
    """)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return np.load(tmp_path / "out.npy")


def test_compressed_psum_is_the_references_on_8_ranks(tmp_path):
    """8 ranks, each its row of a seeded (8, 1000) array (four chunks, the
    last padded): every rank's result equals the reference's on every
    device element for element, and lies within the reference's bound of
    the exact sum (8 · ½ · the shared scale of each chunk); the tree form
    (one bucket of both leaves' chunks) equals the per-leaf calls."""
    rng = np.random.default_rng(0)
    xs = (rng.normal(size=(8, 1000)) * np.linspace(0.01, 3, 1000)
          ).astype(np.float32)
    want = _ref_compressed_psum(xs, tmp_path)
    res = spawn(ranks.compress, 8, xs, backend="gloo", device="cpu",
                timeout_s=TIMEOUT_S)
    padded = np.abs(np.pad(xs, ((0, 0), (0, 24)))).reshape(8, -1, 256)
    scale = np.repeat(padded.max(axis=(0, 2)) / 127.0, 256)[:1000]
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["got"].numpy(), want[r])
        err = np.abs(out["got"].numpy() - xs.astype(np.float64).sum(0))
        assert (err <= 8 * 0.5 * scale * (1 + 1e-5) + 1e-6).all()
        assert torch.equal(out["tree"]["a"], out["got"])
        assert torch.equal(out["tree"]["b"], out["b"])
        np.testing.assert_allclose(out["plain"].numpy(), xs.sum(0),
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(res[0]["tree"]["b"].numpy(),
                                  res[5]["tree"]["b"].numpy())


def test_compressed_psum_on_one_rank_is_a_round_trip():
    """A group of one rank: the sum is the rank's own quantize →
    dequantize round trip, as the reference's with its own scale."""
    x = np.random.default_rng(1).normal(size=(1, 300)).astype(np.float32)
    got = spawn(ranks.compress, 1, x, backend="gloo", device="cpu",
                timeout_s=TIMEOUT_S)[0]["got"]
    q, s = ref.quantize_int8(jnp.asarray(x[0]))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref.dequantize_int8(q, s, (300,))))


def test_error_feedback_is_the_references():
    rng = np.random.default_rng(3)
    params = {"w": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(3,)).astype(np.float32)}
    grads = {k: (v * 0.5).astype(np.float32) for k, v in params.items()}
    res0 = compress.ErrorFeedback.init(
        {k: torch.tensor(v).bfloat16() for k, v in params.items()})
    res0_ref = ref.ErrorFeedback.init(
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in params.items()})
    for k in params:
        assert res0[k].dtype == torch.float32 and not res0[k].any()
        assert res0_ref[k].shape == tuple(res0[k].shape)
    residual = {k: rng.normal(size=v.shape).astype(np.float32)
                for k, v in params.items()}
    got, new = compress.ErrorFeedback.apply(
        {k: torch.tensor(v).bfloat16() for k, v in grads.items()},
        {k: torch.tensor(v) for k, v in residual.items()})
    want, want_new = ref.ErrorFeedback.apply(
        {k: jnp.asarray(v, jnp.bfloat16) for k, v in grads.items()},
        {k: jnp.asarray(v) for k, v in residual.items()})
    for k in params:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        np.testing.assert_array_equal(new[k].numpy(), np.asarray(want_new[k]))


@pytest.mark.cuda
def test_compress_on_the_card():
    """Quantization on the card bit for bit as on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit")
    x = torch.tensor(np.random.default_rng(4).normal(size=(5000,))
                     .astype(np.float32))
    q, s = compress.quantize_int8(x)
    qc, sc = compress.quantize_int8(x.cuda())
    assert torch.equal(qc.cpu(), q) and torch.equal(sc.cpu(), s)
    assert torch.equal(compress.dequantize_int8(qc, sc, (5000,)).cpu(),
                       compress.dequantize_int8(q, s, (5000,)))
