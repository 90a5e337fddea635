"""The port's plain NTT / INTT and twiddle tables (ntt_cuda_tpu_torch.ops.ntt)
against the JAX package's `ops/ntt.py` and the integer golden models.

Inputs are made with numpy from a seed and fed to both sides; every
comparison is exact.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from ntt_cuda_tpu.ops import ntt as jntt
from ntt_cuda_tpu.ops import modmath as jmm
from ntt_cuda_tpu.params import get_bfv_params as jget
from ntt_cuda_tpu.utils import golden, primegen
from ntt_cuda_tpu_torch import convert
from ntt_cuda_tpu_torch.ops import ntt
from ntt_cuda_tpu_torch.utils import hostmath as thm

SETS = {
    "gen_1024": lambda: primegen.make_bfv_params(1024, 40, 3),
    "4k_3q": lambda: jget("4k_3q"),
}


@pytest.fixture(scope="module", params=sorted(SETS))
def pair(request):
    jp = SETS[request.param]()
    return jp, ntt.tables_for(convert.params_from(jp))


def _rand(rng, qs, n, lead=()):
    return np.stack([rng.integers(0, q, lead + (n,), dtype=np.uint64)
                     for q in qs], axis=-2)


def test_tables_match_jax(pair):
    jp, tb = pair
    jt = jntt.tables_for(jp)
    np.testing.assert_array_equal(convert.to_numpy(tb.psi_mont),
                                  np.asarray(jt.psi_mont))
    np.testing.assert_array_equal(convert.to_numpy(tb.psiinv_mont),
                                  np.asarray(jt.psiinv_mont))
    for i, q in enumerate(jp.q):
        fwd, inv = jp.psi_tables(i)
        assert convert.to_numpy(tb.psi[i]).tolist() == fwd
        assert convert.to_numpy(tb.psiinv[i]).tolist() == inv
        assert convert.to_numpy(tb.psi_shoup[i]).tolist() == [
            (w << 64) // q for w in fwd]
        assert convert.to_numpy(tb.psiinv_shoup[i]).tolist() == [
            (w << 64) // q for w in inv]
        ninv_mont = (pow(jp.n, -1, q) << 64) % q
        assert convert.to_numpy(tb.consts[i]).tolist() == [
            q, thm.mont_qinv_neg(q), ninv_mont, (ninv_mont << 64) // q]


@pytest.mark.parametrize("lead", [(), (3,)], ids=["J1", "J3"])
def test_forward_inverse_match_jax(pair, lead):
    jp, tb = pair
    rng = np.random.default_rng(len(lead) + jp.n)
    x = _rand(rng, jp.q, jp.n, lead)
    jt, jms = jntt.tables_for(jp), jmm.modulus_set(jp)
    fwd = ntt.ntt_forward(convert.to_torch(x), tb)
    np.testing.assert_array_equal(
        convert.to_numpy(fwd),
        np.asarray(jntt.ntt_forward_jit(jnp.asarray(x), jt, jms)))
    inv = ntt.ntt_inverse(convert.to_torch(x), tb)
    np.testing.assert_array_equal(
        convert.to_numpy(inv),
        np.asarray(jntt.ntt_inverse_jit(jnp.asarray(x), jt, jms)))
    np.testing.assert_array_equal(
        convert.to_numpy(ntt.ntt_inverse(fwd, tb)), x)


def test_dyadic_matches_jax(pair):
    jp, tb = pair
    rng = np.random.default_rng(5)
    a, b = _rand(rng, jp.q, jp.n), _rand(rng, jp.q, jp.n)
    got = ntt.dyadic_mul(convert.to_torch(a), convert.to_torch(b), tb.ms)
    ref = jntt.dyadic_mul_jit(jnp.asarray(a), jnp.asarray(b),
                              jmm.modulus_set(jp))
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(ref))


def test_forward_matches_golden_and_schoolbook():
    jp = SETS["gen_1024"]()
    tb = ntt.tables_for(convert.params_from(jp))
    rng = np.random.default_rng(9)
    a, b = _rand(rng, jp.q, jp.n), _rand(rng, jp.q, jp.n)
    fwd = convert.to_numpy(ntt.ntt_forward(convert.to_torch(a), tb))
    fa, fb = (ntt.ntt_forward(convert.to_torch(v), tb) for v in (a, b))
    prod = convert.to_numpy(ntt.ntt_inverse(ntt.dyadic_mul(fa, fb, tb.ms),
                                            tb))
    i = 1
    q = jp.q[i]
    psi_tab, _ = jp.psi_tables(i)
    assert fwd[i].tolist() == golden.ntt_forward(a[i], psi_tab, q, jp.n)
    assert prod[i].tolist() == golden.schoolbook_negacyclic(a[i], b[i], q,
                                                            jp.n)


def test_negacyclic_polymul_matches_jax(pair):
    jp, tb = pair
    rng = np.random.default_rng(11)
    a, b = _rand(rng, jp.q, jp.n), _rand(rng, jp.q, jp.n)
    got = ntt.negacyclic_polymul(convert.to_torch(a), convert.to_torch(b), tb)
    ref = jntt.negacyclic_polymul_jit(jnp.asarray(a), jnp.asarray(b),
                                      jntt.tables_for(jp),
                                      jmm.modulus_set(jp))
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(ref))


def test_poly_scalar_helpers_match_jax(pair):
    """poly_add_scalar with a scalar and an (r, 1) addend at the edge
    q - 1, and poly_mul_scalar_mod_t with a 64-bit scalar."""
    from ntt_cuda_tpu.ops import poly as jpoly
    from ntt_cuda_tpu_torch.ops import poly
    jp, tb = pair
    rng = np.random.default_rng(12)
    a = _rand(rng, jp.q, jp.n)
    jms = jmm.modulus_set(jp)
    col = np.array([[q - 1] for q in jp.q], np.uint64)
    for c in (min(jp.q) - 1, col):
        got = poly.poly_add_scalar(
            convert.to_torch(a), convert.to_torch(c) if np.ndim(c) else c,
            tb.ms)
        ref = jpoly.poly_add_scalar(jnp.asarray(a), jnp.asarray(c), jms)
        np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(ref))
    c, t = 0xDEADBEEF12345677, 1024
    got = poly.poly_mul_scalar_mod_t(convert.to_torch(a), c, t)
    ref = jpoly.poly_mul_scalar_mod_t(jnp.asarray(a), c, t)
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(ref))
