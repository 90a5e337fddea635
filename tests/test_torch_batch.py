"""Batched encryption of the port against the JAX package, and the op
schedule at n = 32768 against the stage schedule, on the CPU.

1. Kernel 6's plain version (salsa20.keystream_words_batch_plain) and the
   stream's views over a (J, words) batch against the JAX xla path (a vmap
   of the single stream) and its batched slicers, nonces >= 2^63 and
   counter0's carry into word 9 included.
2. The batched draws against the JAX package's at 4k_3q, J = 3.
3. BFVContext.encrypt_batch against JAX `backend="xla"` encrypt_batch and
   against the port's own per-message encrypt.
4. BFVContext.build(32k_9q, fusion="op") builds, and its keys, ciphertexts
   and plaintexts equal the stage schedule's (port against port: no JAX
   compile at n = 32768).

Every comparison is exact.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ntt_cuda_tpu.models import bfv as jbfv
from ntt_cuda_tpu.ops import modmath as jmm
from ntt_cuda_tpu.ops import salsa20 as jsalsa
from ntt_cuda_tpu.ops import sampling as jsamp
from ntt_cuda_tpu.params import get_bfv_params as jget
from ntt_cuda_tpu_torch import BFVContext, convert, get_bfv_params
from ntt_cuda_tpu_torch.ops import modmath, salsa20, sampling

NONCES = [0, 1, 2**40 + 7, 2**62 + 5]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at
    once, and oversubscribed threads slow the 32k plain transforms."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _u32(words: torch.Tensor) -> np.ndarray:
    return words.numpy().view(np.uint32)


@pytest.mark.parametrize("mapped", [False, True], ids=["raw", "encrypt"])
def test_keystream_batch_matches_jax(mapped):
    """Row j is nonce j's stream in byte order: the JAX (J, 16, nb) planes
    read block by block."""
    nb = 70
    nonces = sampling.encrypt_nonces(NONCES) if mapped else NONCES
    ref = jsalsa.keystream_block_words_batch(
        nb, jnp.asarray(np.asarray(nonces, np.uint64)), impl="xla")
    ref = np.asarray(ref).transpose(0, 2, 1).reshape(len(NONCES), 16 * nb)
    got = salsa20.keystream_words_batch(nb, nonces, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got), ref)
    np.testing.assert_array_equal(
        _u32(salsa20.keystream_words_batch_plain(nb, nonces)), ref)


@pytest.mark.parametrize("counter0", [0, 2**32 - 3])
def test_keystream_batch_rows_equal_single_streams(counter0):
    """Row j is the single stream of nonce j; a tensor of u64 bit patterns
    (bit 63 set) gives the same rows as the ints."""
    nb = 40
    nonces = [0, 5, 1 << 63, (1 << 64) - 1]
    bits = torch.from_numpy(np.asarray(nonces, np.uint64).view(np.int64))
    got = salsa20.keystream_words_batch_plain(nb, bits, counter0=counter0)
    assert got.shape == (4, 16 * nb)
    for j, nonce in enumerate(nonces):
        assert torch.equal(got[j], salsa20.keystream_words_plain(
            nb, nonce=nonce, counter0=counter0))


def test_batch_slicers_match_jax():
    """bytes_u32 / bytes_u8 over the (J, words) batch against the JAX
    package's block_words_u32_batch / block_words_u8_batch, every row at
    once; bytes_u64 row by row against JAX bytes_u64 of each row's flat
    stream; views, not copies."""
    nb = 70                 # the shapes of the keystream test: one compile
    ks = salsa20.keystream_words_batch_plain(nb, NONCES)
    jbw = jsalsa.keystream_block_words_batch(
        nb, jnp.asarray(NONCES, jnp.uint64), impl="xla")
    for start, count in ((0, 1001), (64 * 7, 555), (128, 640)):
        u32 = salsa20.bytes_u32(ks, start, count)
        np.testing.assert_array_equal(
            _u32(u32), np.asarray(jsalsa.block_words_u32_batch(jbw, start,
                                                               count)))
        np.testing.assert_array_equal(
            salsa20.bytes_u8(ks, start, count).numpy(),
            np.asarray(jsalsa.block_words_u8_batch(jbw, start, count)))
        assert u32.untyped_storage().data_ptr() == \
            ks.untyped_storage().data_ptr()
    u64 = salsa20.bytes_u64(ks, 72, 333)
    for j in range(len(NONCES)):
        np.testing.assert_array_equal(
            u64[j].numpy().view(np.uint64), np.asarray(jsalsa.bytes_u64(
                jnp.asarray(_u32(ks[j])), 72, 333)))
    with pytest.raises(ValueError, match="aligned"):
        salsa20.bytes_u32(ks, 2, 8)


def test_encrypt_draws_batch_match_jax():
    p = jget("4k_3q")
    nonces = [0, 1, 2**62 + 5]
    u_b, e_d = sampling.encrypt_draws_compact_batch(p.n, nonces, device="cpu")
    ju, je = jsamp.encrypt_draws_compact_batch(
        p.n, jnp.asarray(nonces, jnp.uint64), ks_impl="xla")
    assert u_b.dtype == e_d.dtype == torch.int32
    assert tuple(u_b.shape) == (3, p.n) and tuple(e_d.shape) == (3, 2, p.n)
    np.testing.assert_array_equal(u_b.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(e_d.numpy(), np.asarray(je))
    for j, nonce in enumerate(nonces):
        u1, e1 = sampling.encrypt_draws_compact(p.n, nonce=nonce,
                                                device="cpu")
        assert torch.equal(u_b[j], u1) and torch.equal(e_d[j], e1)
    u, e = sampling.encrypt_draws_batch(p.n, p.r, modmath.modulus_set(p),
                                        nonces)
    jur, jer = jsamp.encrypt_draws_batch(p.n, p.r, jmm.modulus_set(p),
                                         jnp.asarray(nonces, jnp.uint64),
                                         ks_impl="xla")
    np.testing.assert_array_equal(convert.to_numpy(u), np.asarray(jur))
    np.testing.assert_array_equal(convert.to_numpy(e), np.asarray(jer))


@pytest.fixture(scope="module")
def jctx():
    return jbfv.BFVContext.build(jget("4k_3q"), backend="xla")


@pytest.fixture(scope="module")
def ctx():
    return BFVContext.build(get_bfv_params("4k_3q"), device="cpu")


def test_encrypt_batch_matches_jax_and_encrypt(ctx, jctx):
    p = ctx.params
    nonces = [0, 1, 2**62 + 5]
    sk, pk = ctx.keygen(3)
    m = np.random.default_rng(5).integers(0, p.t, (3, p.n), dtype=np.uint64)
    m[:, :3] = [0, p.t - 1, p.t // 2]
    cts = ctx.encrypt_batch(pk, m, nonces)
    assert tuple(cts.shape) == (3, 2, p.r - 1, p.n)
    jcts = jctx.encrypt_batch(convert.to_numpy(pk), m,
                              np.asarray(nonces, np.uint64))
    np.testing.assert_array_equal(convert.to_numpy(cts), np.asarray(jcts))
    for j, nonce in enumerate(nonces):
        assert torch.equal(cts[j], ctx.encrypt(pk, m[j], nonce=nonce))
    np.testing.assert_array_equal(
        convert.to_numpy(ctx.decrypt_batch(sk, cts)), m)
    # nonces as a uint64 array or an int64 tensor: the same ciphertexts
    for ns in (np.asarray(nonces, np.uint64), torch.tensor(nonces)):
        assert torch.equal(ctx.encrypt_batch(pk, m, ns), cts)


def test_encrypt_batch_validation(ctx):
    p = ctx.params
    _, pk = ctx.keygen()
    m = np.zeros((2, p.n), np.uint64)
    with pytest.raises(ValueError, match=r"m_batch: expected \(J, n\)"):
        ctx.encrypt_batch(pk, m[0], [1])
    with pytest.raises(ValueError, match="m_batch: expected shape"):
        ctx.encrypt_batch(pk, m[:, :8], [1, 2])
    with pytest.raises(ValueError, match=r"nonces: expected shape \(2,\)"):
        ctx.encrypt_batch(pk, m, [1, 2, 3])
    with pytest.raises(ValueError, match="bit 63"):
        ctx.encrypt_batch(pk, m, [1, 2**63 + 1])
    with pytest.raises(ValueError, match="pk: expected shape"):
        ctx.encrypt_batch(pk[0], m, [1, 2])


def test_op_schedule_at_32k_equals_stage():
    """fusion="op" at n = 32768 (K3-K5 over two 2^14 halves on the card;
    their plain versions here) gives the stage schedule's integers; "auto"
    stays "stage" there, as in the JAX package."""
    p = get_bfv_params("32k_9q")
    op = BFVContext.build(p, device="cpu", fusion="op")
    st = BFVContext.build(p, device="cpu")
    assert (op.fusion, st.fusion) == ("op", "stage")
    sk, pk = op.keygen(1)
    sk_s, pk_s = st.keygen(1)
    assert torch.equal(sk, sk_s) and torch.equal(pk, pk_s)
    m = torch.from_numpy(np.random.default_rng(6).integers(0, p.t, p.n))
    ct = op.encrypt(pk, m, nonce=2)
    assert torch.equal(ct, st.encrypt(pk, m, nonce=2))
    assert torch.equal(op.encrypt_batch(pk, m[None], [2])[0], ct)
    assert torch.equal(op.decrypt(sk, ct), m)
