"""The port's Salsa20 keystream and samplers (ntt_cuda_tpu_torch.ops.salsa20,
ops.sampling) against the JAX package's xla keystream, the integer golden
Salsa20, the ECRYPT vector and the JAX compact draws; the draws' views of
the stream.  Exact everywhere.
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


def _u32(words: torch.Tensor) -> np.ndarray:
    """int32 bit patterns as the u32 words they carry."""
    return words.numpy().view(np.uint32)


@pytest.mark.parametrize("nonce,counter0", [(0, 0), (5, 0),
                                            (2**63 + 3, 2**32 - 7)])
def test_keystream_matches_jax_xla(nonce, counter0):
    """The stream in byte order equals the JAX xla keystream's words in
    stream order (its (16, nb) planes read block by block), the nonce's
    bit 63 and counter0's carry into word 9 included."""
    nb = 333
    ks = salsa20.keystream_words(nb, nonce=nonce, counter0=counter0,
                                 device="cpu")
    assert ks.dtype == torch.int32 and tuple(ks.shape) == (16 * nb,)
    ref = np.asarray(jsalsa._keystream_xla(nb, nonce=jnp.uint64(nonce),
                                           counter0=jnp.uint64(counter0)))
    np.testing.assert_array_equal(_u32(ks), ref.T.reshape(-1))
    np.testing.assert_array_equal(
        salsa20.keystream_words_plain(nb, nonce=nonce,
                                      counter0=counter0).numpy(),
        ks.numpy())
    if counter0 == 0:     # the JAX package's flat API starts at block 0
        np.testing.assert_array_equal(_u32(ks), np.asarray(
            jsalsa.keystream_words(nb, nonce=jnp.uint64(nonce))))


def test_keystream_and_lanes_match_golden():
    """Words and the u64 lanes' view against the golden byte stream (the
    lanes held against golden, not only against the JAX stream)."""
    nb = 37
    ks = salsa20.keystream_words(nb, device="cpu")
    exp = golden.salsa20_keystream(64 * nb)
    np.testing.assert_array_equal(_bytes(ks), exp)
    np.testing.assert_array_equal(salsa20.bytes_u8(ks, 0, 64 * nb).numpy(),
                                  exp)
    np.testing.assert_array_equal(
        convert.to_numpy(salsa20.bytes_u64(ks, 0, 8 * nb)),
        exp.view(np.uint64))
    got = _bytes(salsa20.keystream_for_bytes(100, key_byte=0x4D,
                                             device="cpu"))
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
    """bytes_u8 / u32 / u64 against the JAX package's bytes_u8 / u32 / u64
    over its flat stream, at odd counts and at offsets inside a block
    (bytes_u8 also at odd offsets, against the bytes of the JAX stream)."""
    nb = 300
    ks = salsa20.keystream_words(nb, nonce=11, device="cpu")
    jks = jsalsa.keystream_words(nb, nonce=jnp.uint64(11))
    for start, count in ((0, 1000), (132, 1004)):
        np.testing.assert_array_equal(
            salsa20.bytes_u8(ks, start, count).numpy(),
            np.asarray(jsalsa.bytes_u8(jks, start, count)))
    jbytes = np.asarray(jks).view(np.uint8)
    for start, count in ((1, 1001), (77, 333), (64 * nb - 3, 3)):
        np.testing.assert_array_equal(
            salsa20.bytes_u8(ks, start, count).numpy(),
            jbytes[start:start + count])
    for start, count in ((0, 555), (64 * 7 + 4, 555), (12, 1)):
        np.testing.assert_array_equal(
            _u32(salsa20.bytes_u32(ks, start, count)),
            np.asarray(jsalsa.bytes_u32(jks, start, count)))
    for start, count in ((0, 801), (64 * 3 + 8, 799), (40, 1)):
        np.testing.assert_array_equal(
            convert.to_numpy(salsa20.bytes_u64(ks, start, count)),
            np.asarray(jsalsa.bytes_u64(jks, start, count)))


def test_draws_are_views_of_the_stream():
    """Every draw of the stream is a view: its storage is the stream's,
    a single stream's and a (J, words) batch's alike; ranges that cannot be
    viewed raise."""
    ks = salsa20.keystream_words(20, nonce=3, device="cpu")
    batch = salsa20.keystream_words_batch(20, [1, 2, 3], device="cpu")
    for s in (ks, batch):
        base = s.untyped_storage().data_ptr()
        for v in (salsa20.bytes_u8(s, 5, 77), salsa20.bytes_u32(s, 4, 33),
                  salsa20.bytes_u64(s, 8, 40),
                  salsa20.bytes_u64(s, 0, 80).reshape(-1, 2, 40)):
            assert v.untyped_storage().data_ptr() == base
    with pytest.raises(ValueError, match="8-byte aligned"):
        salsa20.bytes_u64(ks, 4, 8)
    with pytest.raises(ValueError, match="4-byte aligned"):
        salsa20.bytes_u32(ks, 2, 8)
    with pytest.raises(RuntimeError):    # an odd word offset: no int64 view
        salsa20.bytes_u64(ks[1:], 0, 8)


def test_draw_functions_view_the_stream(monkeypatch):
    """The draw functions read their bytes, words and lanes through the
    views: each converter's input shares the storage of a keystream the
    draw launched (keygen's, encrypt's, a batch's, the relin keys')."""
    streams, seen = [], []
    for name in ("keystream_words", "keystream_words_batch"):
        fn = getattr(salsa20, name)

        def spy(*a, fn=fn, **k):
            streams.append(fn(*a, **k))
            return streams[-1]
        monkeypatch.setattr(salsa20, name, spy)
    for conv in ("ternary_int", "gaussian_int", "uniform"):
        fn = getattr(sampling, conv)

        def spy(x, *a, fn=fn):
            seen.append(x)
            return fn(x, *a)
        monkeypatch.setattr(sampling, conv, spy)
    p = jget("4k_3q")
    ms = modmath.modulus_set(p)
    sampling.keygen_draws_compact(p.n, p.r, ms, nonce=1)
    sampling.encrypt_draws_compact(p.n, nonce=1, device="cpu")
    sampling.encrypt_draws_compact_batch(p.n, [1, 2], device="cpu")
    sampling.relin_draws(p.n, p.r, p.r - 1, ms, nonce=1)
    ptrs = {s.untyped_storage().data_ptr() for s in streams}
    assert len(streams) == 4 and len(seen) == 9
    assert all(x.untyped_storage().data_ptr() in ptrs for x in seen)


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
    # u32 words as the stream's int32 bit patterns (>= 2^31 negative)
    np.testing.assert_array_equal(
        sampling.gaussian_int(torch.from_numpy(u.view(np.int32))).numpy(),
        np.asarray(jsamp.gaussian_int(jnp.asarray(u))))


def test_ternary_int_on_a_uint8_view():
    """ternary_int on a uint8 view of int32 words: the bytes 0 and 84 give
    -1 (not 254, as byte // 85 - 1 in uint8 would), 85 0, 170 1, 254 1 and
    255 the quirk's 2; equal to the JAX package's."""
    b = np.array([0, 84, 85, 170, 254, 255, 1, 169], dtype=np.uint8)
    view = torch.from_numpy(b.copy().view(np.int32)).view(torch.uint8)
    assert view.dtype == torch.uint8
    got = sampling.ternary_int(view)
    assert got.dtype == torch.int32
    assert got.tolist() == [-1, -1, 0, 1, 1, 2, -1, 0]
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jsamp.ternary_int(jnp.asarray(b))))


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
    u_b, e_d = sampling.encrypt_draws_compact(n, nonce=nonce, device="cpu")
    ju, je = jsamp.encrypt_draws_compact(n, nonce=nonce, ks_impl="xla")
    np.testing.assert_array_equal(u_b.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(e_d.numpy(), np.asarray(je))


@pytest.mark.parametrize("name,nonce", [("4k_3q", 0), ("8k_4q", 2**62)])
def test_relin_draws_match_jax(name, nonce):
    """The k relinearization keys' draws, sliced out together, equal the
    JAX package's per-key slices of the key-byte-0x02 stream."""
    p = jget(name)
    k = p.r - 1
    a, e = sampling.relin_draws(p.n, p.r, k, modmath.modulus_set(p),
                                nonce=nonce)
    ja, je = jsamp.relin_draws(p.n, p.r, k, jmm.modulus_set(p), nonce=nonce,
                               ks_impl="xla")
    assert tuple(a.shape) == tuple(e.shape) == (k, p.r, p.n)
    np.testing.assert_array_equal(convert.to_numpy(a), np.asarray(ja))
    np.testing.assert_array_equal(convert.to_numpy(e), np.asarray(je))


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
    ctx = BFVContext.build(convert.params_from(jget("4k_3q")), device="cpu")
    with pytest.raises(ValueError, match="bit 63"):
        ctx.keygen(nonce=2**63)
    with pytest.raises(ValueError, match="bit 63"):
        ctx.encrypt(np.zeros((2, 3, 4096), np.uint64),
                    np.zeros(4096, np.uint64), nonce=2**63 + 1)


def test_draws_without_device_need_a_card(monkeypatch):
    """device=None is the card: with no CUDA the keystreams and the
    encryption draws raise and say how to ask for the CPU; they never
    fall back to it."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: salsa20.keystream_words(4),
                 lambda: salsa20.keystream_words_batch(4, [1, 2]),
                 lambda: sampling.encrypt_draws_compact(64, nonce=1),
                 lambda: sampling.encrypt_draws_compact_batch(64, [1, 2])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert salsa20.keystream_words(4, device="cpu").shape == (64,)
