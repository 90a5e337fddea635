"""The port's Salsa20 keystream and samplers (ntt_cuda_tpu_torch.ops.salsa20,
ops.sampling) against the JAX package's xla keystream, the integer golden
Salsa20, the ECRYPT vector and the JAX compact draws.  Exact everywhere.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ntt_cuda_tpu.ops import modmath as jmm
from ntt_cuda_tpu.ops import salsa20 as jsalsa
from ntt_cuda_tpu.ops import sampling as jsamp
from ntt_cuda_tpu.params import get_bfv_params as jget
from ntt_cuda_tpu.utils import golden
from ntt_cuda_tpu_torch import BFVContext, convert
from ntt_cuda_tpu_torch.ops import modmath, salsa20, sampling

NONCES = [0, 1, 2**62]


def _bytes(words: torch.Tensor) -> np.ndarray:
    return words.reshape(-1).numpy().astype(np.uint32).view(np.uint8)


@pytest.mark.parametrize("nonce,counter0", [(0, 0), (5, 0),
                                            (2**63 + 3, 2**32 - 7)])
def test_keystream_matches_jax_xla(nonce, counter0):
    nb = 333
    bw, lanes = salsa20.keystream_block_words(nb, nonce=nonce,
                                              counter0=counter0, with_u64=True)
    ref = np.asarray(jsalsa._keystream_xla(nb, nonce=jnp.uint64(nonce),
                                           counter0=jnp.uint64(counter0)))
    np.testing.assert_array_equal(bw.numpy(), ref.astype(np.int64))
    pairs = ref[0::2].astype(np.uint64) | (ref[1::2].astype(np.uint64) << 32)
    np.testing.assert_array_equal(convert.to_numpy(lanes), pairs)
    # without the lanes: the same words
    np.testing.assert_array_equal(
        salsa20.keystream_block_words(nb, nonce=nonce,
                                      counter0=counter0).numpy(),
        bw.numpy())


def test_keystream_and_lanes_match_golden():
    """Words and pre-paired u64 lanes against the golden byte stream (the
    lanes held against golden, not only against the JAX planes)."""
    nb = 37
    bw, lanes = salsa20.keystream_block_words(nb, with_u64=True)
    exp = golden.salsa20_keystream(64 * nb)
    np.testing.assert_array_equal(_bytes(bw.T), exp)
    np.testing.assert_array_equal(
        convert.to_numpy(salsa20.block_words_u64_planes(lanes, 0, 8 * nb)),
        exp.view(np.uint64))
    got = _bytes(salsa20.keystream_block_words(2, key_byte=0x4D).T)
    np.testing.assert_array_equal(got, golden.salsa20_keystream(
        128, key=b"\x4d" * 32))


def test_salsa20_core_ecrypt_vector():
    """The port's 20-round core on the ECRYPT Salsa20/20 256-bit set 1
    vector #0 (key 80 00 .. 00, IV 0, block 0)."""
    key = [0x80] + [0] * 7
    j = [torch.tensor([v]) for v in (
        0x61707865, key[0], key[1], key[2], key[3], 0x3320646E, 0, 0, 0, 0,
        0x79622D32, key[4], key[5], key[6], key[7], 0x6B206574)]
    x = list(j)
    for _ in range(10):
        salsa20._double_round(x)
    out = torch.cat([(x[i] + j[i]) & 0xFFFFFFFF for i in range(16)])
    assert _bytes(out).tobytes().hex().upper() == (
        "E3BE8FDD8BECA2E3EA8EF9475B29A6E7003951E1097A5C38D23B7A5FAD9F6844"
        "B22C97559E2723C7CBBD3FE4FC8D9A0744652A83E72A9C461876AF4D7EF1A117")


def test_slicers_match_jax():
    nb = 300
    bw, lanes = salsa20.keystream_block_words(nb, nonce=11, with_u64=True)
    jbw, jlo, jhi = jsalsa.keystream_block_words64(nb, nonce=11, impl="xla")
    np.testing.assert_array_equal(
        salsa20.block_words_u8(bw, 128, 1001).numpy(),
        np.asarray(jsalsa.block_words_u8(jbw, 128, 1001)))
    np.testing.assert_array_equal(
        salsa20.block_words_u32(bw, 64 * 7, 555).numpy(),
        np.asarray(jsalsa.block_words_u32(jbw, 64 * 7, 555)))
    np.testing.assert_array_equal(
        convert.to_numpy(salsa20.block_words_u64_planes(lanes, 64 * 3, 800)),
        np.asarray(jsalsa.block_words_u64_planes(jlo, jhi, 64 * 3, 800)))


def test_converters_match_jax():
    u = np.array([0, 1, 6, 7, 39, 40, 2**31, 2**32 - 129, 2**32 - 128,
                  2**32 - 1] + list(jsamp.GAUSS_ICDF_BOUNDS), dtype=np.uint32)
    np.testing.assert_array_equal(
        sampling.gaussian_int(torch.from_numpy(u.astype(np.int64))).numpy(),
        np.asarray(jsamp.gaussian_int(jnp.asarray(u))))
    b = np.arange(256, dtype=np.uint8)
    got = sampling.ternary_int(torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jsamp.ternary_int(jnp.asarray(b))))
    assert int(got[255]) == 2                       # the byte-255 quirk
    assert sampling.GAUSS_ICDF_BOUNDS == jsamp.GAUSS_ICDF_BOUNDS


@pytest.mark.parametrize("nonce", NONCES)
def test_keygen_draws_compact_match_jax(nonce):
    p = jget("4k_3q")
    ms = modmath.modulus_set(p)
    s_b, a, e_d = sampling.keygen_draws_compact(p.n, p.r, ms, nonce=nonce)
    js, ja, je = jsamp.keygen_draws_compact(p.n, p.r, jmm.modulus_set(p),
                                            nonce=nonce, ks_impl="xla")
    assert s_b.dtype == e_d.dtype == torch.int32
    np.testing.assert_array_equal(s_b.numpy(), np.asarray(js))
    np.testing.assert_array_equal(convert.to_numpy(a), np.asarray(ja))
    np.testing.assert_array_equal(e_d.numpy(), np.asarray(je))


@pytest.mark.parametrize("nonce", NONCES)
def test_encrypt_draws_compact_match_jax(nonce):
    n = 4096
    u_b, e_d = sampling.encrypt_draws_compact(n, nonce=nonce)
    ju, je = jsamp.encrypt_draws_compact(n, nonce=nonce, ks_impl="xla")
    np.testing.assert_array_equal(u_b.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(e_d.numpy(), np.asarray(je))


def test_residue_maps_match_jax():
    p = jget("4k_3q")
    rng = np.random.default_rng(3)
    d = rng.integers(-19, 17, p.n).astype(np.int32)
    q = modmath.modulus_set(p).q
    np.testing.assert_array_equal(
        convert.to_numpy(sampling.small_res(torch.from_numpy(d), q)),
        np.asarray(jsamp._residues(jnp.asarray(d), jmm.modulus_set(p))))


def test_nonce_mapping_and_bit63_rejection():
    for v in (0, 1, 7, 2**62, 2**63 - 1):
        assert sampling.keygen_nonce(v) == int(jsamp.keygen_nonce(v))
        assert sampling.encrypt_nonce(v) == int(jsamp.encrypt_nonce(v))
    assert sampling.keygen_nonce(2**63 + 5) == 5
    for bad in (2**63, np.uint64(2**63 + 7), [1, 2**63 + 1]):
        with pytest.raises(ValueError, match="bit 63"):
            sampling.check_user_nonce(bad)
    sampling.check_user_nonce(0)
    sampling.check_user_nonce([1, 2**62])
    ctx = BFVContext.build(convert.params_from(jget("4k_3q")))
    with pytest.raises(ValueError, match="bit 63"):
        ctx.keygen(nonce=2**63)
    with pytest.raises(ValueError, match="bit 63"):
        ctx.encrypt(np.zeros((2, 3, 4096), np.uint64),
                    np.zeros(4096, np.uint64), nonce=2**63 + 1)
