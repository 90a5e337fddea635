"""The port's EvalMult path (BFVContext.mul / square / relin_keygen /
relinearize and decrypt of L = 3 ciphertexts) against the JAX package, on
the CPU at 4k_3q.  Every comparison is exact (tolerance 0).

1. relin_keygen, mul with and without rlk, square and relinearize are
   bit-identical to `ntt_cuda_tpu` BFVContext.build(p, backend="xla");
   square equals mul(ct, ct); a (J = 2) batch equals its messages.
2. decrypt of the L = 3 product is the schoolbook negacyclic product mod t
   (`golden.schoolbook_negacyclic`).
3. The argument errors of the JAX package's test_bfv_mult.py; keys cross
   between the packages through `convert` both ways.
4. Kernel 11's plain version against the JAX Pallas kernel
   (`ntt_pallas.ntt_forward_addneg`) in interpret mode.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntt_cuda_tpu.models import bfv as jbfv
from ntt_cuda_tpu.ops import ntt_pallas
from ntt_cuda_tpu.params import get_bfv_params as jget
from ntt_cuda_tpu.utils import golden
from ntt_cuda_tpu_torch import BFVContext, convert, get_bfv_params
from ntt_cuda_tpu_torch.ops import ntt_stage


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    several worker processes at once, and oversubscribed torch threads slow
    the plain transforms by orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _eq(got, ref):
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(ref))


def _product(m1, m2, p):
    return golden.schoolbook_negacyclic(m1.tolist(), m2.tolist(), p.t, p.n)


@pytest.fixture(scope="module")
def jctx():
    return jbfv.BFVContext.build(jget("4k_3q"), backend="xla")


@pytest.fixture(scope="module")
def ctx():
    return BFVContext.build(get_bfv_params("4k_3q"), device="cpu")


@pytest.fixture(scope="module")
def keys(ctx, jctx):
    """Both packages' keys at nonce 3 (equal: tests/test_torch_bfv.py), the
    JAX rlk, and two encrypted messages."""
    p = ctx.params
    jsk, jpk = jctx.keygen(3)
    sk, pk = ctx.keygen(3)
    jrlk = np.asarray(jctx.relin_keygen(jsk))
    m = np.random.default_rng(5).integers(0, p.t, (2, p.n), dtype=np.uint64)
    cts = torch.stack([ctx.encrypt(pk, m[j], nonce=j + 1) for j in range(2)])
    return dict(jsk=jsk, sk=sk, jrlk=jrlk, m=m, cts=cts,
                jcts=convert.to_numpy(cts))


@pytest.mark.parametrize("nonce", [0, 1])
def test_relin_keygen_matches_jax(ctx, jctx, keys, nonce):
    rlk = ctx.relin_keygen(keys["sk"], nonce=nonce)
    p = ctx.params
    assert tuple(rlk.shape) == (2, p.r - 1, p.r, p.n)
    ref = (keys["jrlk"] if nonce == 0 else
           np.asarray(jctx.relin_keygen(keys["jsk"], nonce=nonce)))
    _eq(rlk, ref)


def test_mul_matches_jax_and_decrypts(ctx, jctx, keys):
    p, m = ctx.params, keys["m"]
    cts, jcts = keys["cts"], keys["jcts"]
    ct3 = ctx.mul(cts[0], cts[1])
    assert tuple(ct3.shape) == (3, p.r - 1, p.n)
    _eq(ct3, jctx.mul(jcts[0], jcts[1]))
    out = ctx.decrypt(keys["sk"], ct3)
    _eq(out, jctx.decrypt(keys["jsk"], convert.to_numpy(ct3)))
    assert out.tolist() == _product(m[0], m[1], p)


def test_mul_relinearized_matches_jax(ctx, jctx, keys):
    p, m = ctx.params, keys["m"]
    cts, jcts = keys["cts"], keys["jcts"]
    rlk = ctx.relin_keygen(keys["sk"])
    ct = ctx.mul(cts[0], cts[1], rlk=rlk)
    assert tuple(ct.shape) == (2, p.r - 1, p.n)
    _eq(ct, jctx.mul(jcts[0], jcts[1], rlk=keys["jrlk"]))
    assert ctx.decrypt(keys["sk"], ct).tolist() == _product(m[0], m[1], p)


def test_relinearize_matches_jax(ctx, jctx, keys):
    cts, jcts = keys["cts"], keys["jcts"]
    ct3 = ctx.mul(cts[1], cts[0])
    rlk = ctx.relin_keygen(keys["sk"])
    _eq(ctx.relinearize(ct3, rlk),
        jctx.relinearize(convert.to_numpy(ct3), keys["jrlk"]))


def test_square_equals_mul(ctx, jctx, keys):
    p, m = ctx.params, keys["m"]
    ct = keys["cts"][0]
    sq = ctx.square(ct)
    assert torch.equal(sq, ctx.mul(ct, ct))
    _eq(sq, jctx.square(keys["jcts"][0]))
    rlk = ctx.relin_keygen(keys["sk"])
    out = ctx.decrypt(keys["sk"], ctx.square(ct, rlk=rlk))
    assert out.tolist() == _product(m[0], m[0], p)


def test_batch_equals_per_message(ctx, keys):
    cts = keys["cts"]
    a, b = cts, cts.flip(0)
    rlk = ctx.relin_keygen(keys["sk"])
    batched = ctx.mul(a, b, rlk=rlk)
    assert tuple(batched.shape) == (2,) + tuple(cts.shape[1:])
    for j in range(2):
        assert torch.equal(batched[j], ctx.mul(a[j], b[j], rlk=rlk))
    sq = ctx.square(a)
    for j in range(2):
        assert torch.equal(sq[j], ctx.square(a[j]))


def test_decrypt_l3_is_the_product(ctx, keys):
    """decrypt(mul(E(m1), E(m2))) == m1 * m2 in R_t, unrelinearized."""
    p, m = ctx.params, keys["m"]
    ct3 = ctx.mul(keys["cts"][1], keys["cts"][1])
    assert ctx.decrypt(keys["sk"], ct3).tolist() == _product(m[1], m[1], p)


def test_validation_errors(ctx, keys):
    """tests/test_bfv_mult.py:135-147 on the port."""
    p, sk = ctx.params, keys["sk"]
    ct = keys["cts"][0]
    rlk = ctx.relin_keygen(sk)
    with pytest.raises(ValueError):
        ctx.relinearize(convert.to_numpy(ct), rlk)   # (2, ...) not (3, ...)
    ct3 = ctx.mul(ct, ct)
    with pytest.raises(ValueError):
        ctx.relinearize(ct3, np.zeros((2, 2, 2, p.n), dtype=np.uint64))
    with pytest.raises(ValueError, match="shapes differ"):
        ctx.mul(ct, convert.to_numpy(ct3))             # mismatched shapes
    with pytest.raises(ValueError):
        ctx.relin_keygen(sk, nonce=1 << 63)            # reserved bit
    with pytest.raises(ValueError, match="expected \\(2, r-1, n\\)"):
        ctx.square(ct[:, :1])


def test_rlk_interop_through_convert(ctx, jctx, keys):
    """A JAX rlk relinearizes a port product, and the port's rlk a JAX
    one; both decrypt to the product."""
    p, m = ctx.params, keys["m"]
    exp = _product(m[0], m[1], p)
    ct3 = ctx.mul(keys["cts"][0], keys["cts"][1])
    out = ctx.relinearize(ct3, convert.to_torch(keys["jrlk"], device="cpu"))
    assert ctx.decrypt(keys["sk"], out).tolist() == exp
    jct3 = jctx.mul(keys["jcts"][0], keys["jcts"][1])
    rlk = ctx.relin_keygen(keys["sk"])
    jout = jctx.relinearize(jct3, convert.to_numpy(rlk))
    assert np.asarray(jctx.decrypt(keys["jsk"], jout)).tolist() == exp


def test_forward_addneg_plain_matches_pallas_interpret():
    jp = jget("4k_3q")
    tb = BFVContext.build(convert.params_from(jp), device="cpu").tables_full
    rng = np.random.default_rng(11)
    x = np.stack([rng.integers(0, q, (2, jp.n), dtype=np.uint64)
                  for q in jp.q], axis=-2)
    e = np.stack([rng.integers(0, q, (2, jp.n), dtype=np.uint64)
                  for q in jp.q], axis=-2)
    x[0, :, 0] = np.array(jp.q, dtype=np.uint64) - np.uint64(1)
    e[0, :, 0] = 1                                 # x + e == q: the 0 fixup
    ref = ntt_pallas.ntt_forward_addneg(jnp.asarray(x), jnp.asarray(e),
                                        ntt_pallas.tables_for(jp),
                                        interpret=True)
    _eq(ntt_stage.ntt_forward_addneg_plain(convert.to_torch(x, device="cpu"),
                                           convert.to_torch(e, device="cpu"),
                                           tb), ref)
    _eq(ntt_stage.ntt_forward_addneg(convert.to_torch(x[0], device="cpu"),
                                     convert.to_torch(e[0], device="cpu"), tb),
        np.asarray(ref)[0])
