"""The port's host layer and u64 arithmetic (ntt_cuda_tpu_torch.params,
utils.hostmath, ops.modmath) against Python ints and the JAX package.

Every comparison is exact.  Random 64-bit inputs are made with numpy from
a seed; the torch side carries them as int64 bit patterns.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import ntt_cuda_tpu.params as jparams
from ntt_cuda_tpu.ops import modmath as jmm
from ntt_cuda_tpu.utils import hostmath as jhm
from ntt_cuda_tpu.utils import primegen
from ntt_cuda_tpu_torch import params as tparams
from ntt_cuda_tpu_torch.ops import modmath as mm
from ntt_cuda_tpu_torch.utils import hostmath as thm
from ntt_cuda_tpu_torch.utils import primegen as tprimegen

REPO = Path(__file__).resolve().parents[1]
M64 = (1 << 64) - 1
N = 4096


def _u64(rng, n=N):
    return rng.integers(0, 1 << 64, n, dtype=np.uint64)


def _t(a_u64):
    return torch.from_numpy(np.asarray(a_u64, dtype=np.uint64).view(np.int64))


def _ints(t):
    return [int(v) & M64 for v in t.tolist()]


MODULI = [68719403009, 137438822401, 1125899904679937, 562949952798721,
          36028797017456641, 2305843009213683713]   # gamma is the last


def test_import_is_jax_free():
    """Importing the port (every module) leaves jax out of sys.modules."""
    code = ("import sys, ntt_cuda_tpu_torch, ntt_cuda_tpu_torch.convert, "
            "ntt_cuda_tpu_torch.cuda, ntt_cuda_tpu_torch.ops.fused_ops, "
            "ntt_cuda_tpu_torch.ops.bfv_tail, ntt_cuda_tpu_torch.ops.poly, "
            "ntt_cuda_tpu_torch.ops.sampling, ntt_cuda_tpu_torch.models.bfv, "
            "ntt_cuda_tpu_torch.ops.ntt30, ntt_cuda_tpu_torch.models.encoder, "
            "ntt_cuda_tpu_torch.cli, ntt_cuda_tpu_torch.utils.golden, "
            "ntt_cuda_tpu_torch.utils.profiling, "
            "ntt_cuda_tpu_torch.utils.primegen, "
            "ntt_cuda_tpu_torch.examples.encrypted_dot_product; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'ntt_cuda_tpu.'))]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True, timeout=120)
    assert out.stdout.strip() == "[]"


def test_mulhi_u64():
    rng = np.random.default_rng(1)
    a, b = _u64(rng), _u64(rng)
    a[:4] = [0, M64, M64, 1 << 63]
    b[:4] = [M64, M64, 1, 1 << 63]
    got = _ints(mm.mulhi_u64(_t(a), _t(b)))
    assert got == [(int(x) * int(y)) >> 64 for x, y in zip(a, b)]


@pytest.mark.parametrize("q", MODULI)
def test_mont_mul_and_mulmod(q):
    rng = np.random.default_rng(q % 1000)
    a = _u64(rng)                                     # any u64
    b = rng.integers(0, q, N, dtype=np.uint64)        # b < q
    qt = torch.tensor(q)
    qinv = torch.tensor(mm.as_i64(thm.mont_qinv_neg(q)))
    rinv = pow(1 << 64, -1, q)
    got = _ints(mm.mont_mul(_t(a), _t(b), qt, qinv))
    assert got == [(int(x) * int(y) * rinv) % q for x, y in zip(a, b)]
    a_small = rng.integers(0, q, N, dtype=np.uint64)
    got = _ints(mm.mulmod(_t(a_small), _t(b), qt, qinv,
                          torch.tensor(thm.mont_r2(q))))
    assert got == [(int(x) * int(y)) % q for x, y in zip(a_small, b)]


@pytest.mark.parametrize("q", MODULI)
def test_add_sub_halve_add_negate(q):
    rng = np.random.default_rng(q % 997)
    a = rng.integers(0, q, N, dtype=np.uint64)
    b = rng.integers(0, q, N, dtype=np.uint64)
    a[:3] = [0, q - 1, 1]
    b[:3] = [0, 1, q - 1]            # a + b == q exactly in lanes 1, 2
    qt = torch.tensor(q)
    A, B = _t(a), _t(b)
    ia, ib = [int(x) for x in a], [int(x) for x in b]
    assert _ints(mm.add_mod(A, B, qt)) == [(x + y) % q for x, y in zip(ia, ib)]
    assert _ints(mm.add_mod_lazy_gt(A, B, qt)) == [
        x + y - q if x + y > q else x + y for x, y in zip(ia, ib)]
    assert _ints(mm.sub_mod(A, B, qt)) == [(x - y) % q for x, y in zip(ia, ib)]
    inv2 = pow(2, -1, q)
    assert _ints(mm.halve_mod(A, qt)) == [(x * inv2) % q for x in ia]
    assert _ints(mm.add_negate_mod(A, B, qt)) == [(-(x + y)) % q
                                                  for x, y in zip(ia, ib)]


@pytest.mark.parametrize("q", MODULI + [1024 + 1, 12289, 3])
def test_mod_u64(q):
    rng = np.random.default_rng(q % 991)
    x = _u64(rng)
    x[:3] = [0, M64, q]
    got = _ints(mm.mod_u64(_t(x), torch.tensor(q),
                           torch.tensor(mm.as_i64((1 << 64) // q))))
    assert got == [int(v) % q for v in x]


def test_modulus_set_matches_jax():
    qs = MODULI[:5]
    t = mm.ModulusSet.from_moduli(qs)
    j = jmm.ModulusSet.from_moduli(qs)
    for f in ("q", "qinv_neg", "r2", "nu"):
        np.testing.assert_array_equal(
            getattr(t, f).numpy().view(np.uint64), np.asarray(getattr(j, f)))


_DERIVED = ("r", "logn", "psiinv", "q_bits", "mu", "inv_q_last_mod_q",
            "qi_div_t", "punctured_q", "inv_punctured_q", "base_change_matrix",
            "neg_inv_q_mod_t_gamma", "prod_t_gamma_mod_q", "gamma_bits",
            "mu_gamma", "gamma_div_2", "half_last_modulus", "half_mod_q")


@pytest.mark.parametrize("name", sorted(jparams.BFV_SETS))
def test_params_match_jax(name):
    """Every published set, every derived constant, equal to the JAX
    package's."""
    assert tparams.BFV_SETS[name] == jparams.BFV_SETS[name]
    t, j = tparams.get_bfv_params(name), jparams.get_bfv_params(name)
    assert (t.name, t.n, t.q, t.psi, t.t, t.gamma) == \
        (j.name, j.n, j.q, j.psi, j.t, j.gamma)
    for f in _DERIVED:
        assert getattr(t, f) == getattr(j, f), f
    assert (tparams.T_DEFAULT, tparams.GAMMA) == (jparams.T_DEFAULT,
                                                  jparams.GAMMA)


def test_params_match_jax_generated_odd_t():
    tp = primegen.find_plain_modulus(1024, 14)
    j = primegen.make_bfv_params(1024, 40, 3, t=tp)
    t = tparams.BFVParams(name=j.name, n=j.n, q=j.q, psi=j.psi, t=j.t)
    for f in _DERIVED:
        assert getattr(t, f) == getattr(j, f), f


def test_hostmath_matches_jax():
    for q in MODULI:
        for x in (1, 2, q - 1, q // 3):
            assert thm.modinv(x, q) == jhm.modinv(x, q)
            assert thm.to_mont(x, q) == jhm.to_mont(x, q)
        assert thm.mont_qinv_neg(q) == jhm.mont_qinv_neg(q)
        assert thm.mont_r2(q) == jhm.mont_r2(q)
        assert thm.mu_barrett(q, q.bit_length()) == jhm.mu_barrett(
            q, q.bit_length())
    for v, bits in ((0b1011, 4), (1, 12), (4095, 12), (1234, 13)):
        assert thm.bit_reverse(v, bits) == jhm.bit_reverse(v, bits)


@pytest.mark.parametrize("name", ["4k_3q", "8k_4q"])
def test_psi_tables_match_jax(name):
    t, j = tparams.get_bfv_params(name), jparams.get_bfv_params(name)
    for i in (0, t.r - 1):
        assert t.psi_tables(i) == j.psi_tables(i)


def test_ntt_families_match_jax():
    """The single-modulus NTT families (parameter.h getParams /
    getParams30) and get_params, equal to the JAX package's."""
    assert tparams.PARAMS_60BIT == jparams.PARAMS_60BIT
    assert tparams.PARAMS_60BIT_ALT4096 == jparams.PARAMS_60BIT_ALT4096
    assert tparams.PARAMS_30BIT == jparams.PARAMS_30BIT
    for family, table in (("60bit", tparams.PARAMS_60BIT),
                          ("30bit", tparams.PARAMS_30BIT)):
        for n in table:
            assert tparams.get_params(n, family) == jparams.get_params(
                n, family)
    assert all(q < (1 << 30) for q, *_ in tparams.PARAMS_30BIT.values())


@pytest.mark.parametrize("n,bits,r", [(1024, 40, 3), (2048, 45, 3),
                                      (32768, 45, 3)])
def test_primegen_params_match_jax(n, bits, r):
    """find_plain_modulus and make_bfv_params (the batching sets of the
    encoder and the dot-product example), equal to the JAX package's."""
    t = tprimegen.find_plain_modulus(n, 17)
    assert t == primegen.find_plain_modulus(n, 17)
    got = tprimegen.make_bfv_params(n, bits, r, t=t)
    ref = primegen.make_bfv_params(n, bits, r, t=t)
    assert (got.name, got.n, got.q, got.psi, got.t, got.gamma) == \
        (ref.name, ref.n, ref.q, ref.psi, ref.t, ref.gamma)
    pow2 = tprimegen.make_bfv_params(n, bits, r)
    assert pow2.q == primegen.make_bfv_params(n, bits, r).q
