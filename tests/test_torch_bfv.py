"""The port's BFV main path (ntt_cuda_tpu_torch.models.bfv) against the JAX
package, on the CPU.

1. The reference's embedded golden ciphertext decrypts to i % 10.
2. keygen / encrypt / decrypt / decrypt_batch at 4k_3q are bit-identical to
   `ntt_cuda_tpu` BFVContext.build(p, backend="xla") for nonces 0..3.
3. Keys and ciphertexts cross between the two packages through
   `ntt_cuda_tpu_torch.convert` and still decrypt.
4. An unknown fusion raises, and an L = 3 ciphertext decrypts under the
   stage schedule (uniform_spec="fp64" keygen: tests/test_torch_fp64.py);
   argument errors read as the JAX package's; without a device, build
   goes to the card or raises.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from ntt_cuda_tpu.models import bfv as jbfv
from ntt_cuda_tpu.params import get_bfv_params as jget
from ntt_cuda_tpu_torch import BFVContext, convert, get_bfv_params


FIX = Path(__file__).parent / "fixtures"


@pytest.fixture(scope="module")
def jctx():
    return jbfv.BFVContext.build(jget("4k_3q"), backend="xla")


@pytest.fixture(scope="module")
def ctx():
    return BFVContext.build(get_bfv_params("4k_3q"), device="cpu")


def test_decrypt_reference_golden_vectors(ctx):
    c0 = np.load(FIX / "dec4k_c0.npy")
    c1 = np.load(FIX / "dec4k_c1.npy")
    sk = np.load(FIX / "dec4k_sk_ntt.npy")
    m = ctx.decrypt(sk, np.stack([c0, c1]))
    np.testing.assert_array_equal(m.numpy(), np.arange(ctx.params.n) % 10)


@pytest.mark.parametrize("nonce", [0, 1, 2, 3])
def test_pipeline_matches_jax(ctx, jctx, nonce):
    p = ctx.params
    jsk, jpk = (np.asarray(v) for v in jctx.keygen(nonce))
    sk, pk = ctx.keygen(nonce)
    np.testing.assert_array_equal(convert.to_numpy(sk), jsk)
    np.testing.assert_array_equal(convert.to_numpy(pk), jpk)
    msgs = np.random.default_rng(nonce).integers(0, p.t, (2, p.n),
                                                 dtype=np.uint64)
    jcts = np.stack([np.asarray(jctx.encrypt(jpk, msgs[j], nonce=nonce + j))
                     for j in range(2)])
    cts = torch.stack([ctx.encrypt(pk, msgs[j], nonce=nonce + j)
                       for j in range(2)])
    np.testing.assert_array_equal(convert.to_numpy(cts), jcts)
    for j in range(2):
        m = ctx.decrypt(sk, cts[j])
        np.testing.assert_array_equal(convert.to_numpy(m),
                                      np.asarray(jctx.decrypt(jsk, jcts[j])))
        np.testing.assert_array_equal(convert.to_numpy(m), msgs[j])
    mb = ctx.decrypt_batch(sk, cts)
    np.testing.assert_array_equal(convert.to_numpy(mb),
                                  np.asarray(jctx.decrypt_batch(jsk, jcts)))


def test_interop_through_convert(ctx, jctx):
    """A JAX pk encrypted by the port decrypts in JAX, and the reverse."""
    p = ctx.params
    rng = np.random.default_rng(42)
    m = rng.integers(0, p.t, p.n, dtype=np.uint64)
    jsk, jpk = jctx.keygen(5)
    ct = ctx.encrypt(convert.to_torch(jpk, device="cpu"),
                     convert.to_torch(m, device="cpu"), nonce=9)
    np.testing.assert_array_equal(
        np.asarray(jctx.decrypt(jsk, convert.to_numpy(ct))), m)
    sk, pk = ctx.keygen(6)
    jct = jctx.encrypt(convert.to_numpy(pk), m, nonce=10)
    out = ctx.decrypt(sk, convert.to_torch(jct, device="cpu"))
    np.testing.assert_array_equal(convert.to_numpy(out), m)
    # the carriers themselves are exact both ways, full 64-bit range included
    bits = np.array([0, 1, 2**62, 2**63, 2**64 - 1], dtype=np.uint64)
    np.testing.assert_array_equal(
        convert.to_numpy(convert.to_torch(bits, device="cpu")), bits)
    pp = convert.params_from(jget("16k_5q"))
    assert pp == get_bfv_params("16k_5q")


def test_to_torch_default_device():
    """convert.to_torch with no device is the card, as NTTTables.build: it
    raises where there is none."""
    bits = np.array([0, 2**64 - 1], dtype=np.uint64)
    if torch.cuda.is_available():
        assert convert.to_torch(bits).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            convert.to_torch(bits)


def test_roundtrip_check(ctx):
    m = np.random.default_rng(3).integers(0, ctx.params.t, ctx.params.n)
    np.testing.assert_array_equal(ctx.roundtrip_check(m).numpy(), m)


def test_unknown_fusion_raises():
    """An unknown fusion raises; the stage schedule decrypts an L = 3
    (un-relinearized) product, m * 1 (the op schedule's is
    test_torch_mult.py's test_mul_matches_jax_and_decrypts)."""
    p = get_bfv_params("4k_3q")
    with pytest.raises(ValueError, match="unknown fusion"):
        BFVContext.build(p, device="cpu", fusion="fast")
    m = np.random.default_rng(4).integers(0, p.t, p.n)
    one = np.zeros(p.n, np.int64)
    one[0] = 1
    ctx = BFVContext.build(p, device="cpu", fusion="stage")
    sk, pk = ctx.keygen(2)
    ct3 = ctx.mul(ctx.encrypt(pk, m, nonce=1), ctx.encrypt(pk, one, nonce=2))
    np.testing.assert_array_equal(ctx.decrypt(sk, ct3).numpy(), m)


def test_build_without_device_needs_a_card(monkeypatch):
    """device=None is the card: with no CUDA, build raises and says how to
    ask for the CPU; it never falls back to it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BFVContext.build(get_bfv_params("4k_3q"))
    assert BFVContext.build(get_bfv_params("4k_3q"),
                            device="cpu").device.type == "cpu"


def test_api_validation_messages(ctx):
    """Shape/dtype errors raise at the API with the JAX package's messages."""
    p = ctx.params
    sk, pk = ctx.keygen()
    m = np.zeros(p.n, np.uint64)
    with pytest.raises(ValueError, match="pk: expected shape"):
        ctx.encrypt(pk[0], m)
    with pytest.raises(ValueError, match="m_poly: expected shape"):
        ctx.encrypt(pk, m[: p.n // 2])
    with pytest.raises(TypeError, match="integer array"):
        ctx.encrypt(pk, m.astype(np.float32))
    ct = ctx.encrypt(pk, m)
    with pytest.raises(ValueError, match="ct: expected shape"):
        ctx.decrypt(sk, ct[:, :1])
    with pytest.raises(TypeError, match="expected an array"):
        ctx.decrypt(sk, "nonsense")
    with pytest.raises(ValueError, match="cts: expected"):
        ctx.decrypt_batch(sk, ct)
    # (r-1, n) sk accepted; an int32 plaintext casts cleanly
    np.testing.assert_array_equal(ctx.decrypt(sk[: p.r - 1], ct).numpy(),
                                  np.zeros(p.n))
    assert torch.equal(ctx.encrypt(pk, np.zeros(p.n, np.int32)), ct)
