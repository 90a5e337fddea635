"""The plain versions of the port's kernels K2-K5 (ops.bfv_tail,
ops.fused_ops) against the JAX package's xla compositions, and the kernels'
constant tables against the JAX package's.

Inputs are made with numpy from a seed and fed to both sides; every
comparison is exact, pow2 t (the reference's 1024) and an odd batching
prime t alike.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ntt_cuda_tpu.models import bfv as jbfv
from ntt_cuda_tpu.ops import bfv_tail as jtail
from ntt_cuda_tpu.ops import ntt as jntt
from ntt_cuda_tpu.ops import poly as jpoly
from ntt_cuda_tpu.ops import sampling as jsamp
from ntt_cuda_tpu.params import get_bfv_params as jget
from ntt_cuda_tpu.utils import primegen
from ntt_cuda_tpu_torch import BFVContext, convert
from ntt_cuda_tpu_torch.ops import bfv_tail, fused_ops, sampling


T_ODD = primegen.find_plain_modulus(1024, 14)
SETS = {
    "gen_1024": lambda: primegen.make_bfv_params(1024, 40, 3),
    "gen_1024_odd_t": lambda: primegen.make_bfv_params(1024, 40, 3, t=T_ODD),
    "4k_3q": lambda: jget("4k_3q"),
}


@pytest.fixture(scope="module", params=sorted(SETS))
def pair(request):
    """(JAX params, JAX xla context, port CPU context) for one set."""
    jp = SETS[request.param]()
    return jp, jbfv.BFVContext.build(jp, backend="xla"), BFVContext.build(
        convert.params_from(jp), device="cpu")


def _rand(rng, qs, n, lead=()):
    return np.stack([rng.integers(0, q, lead + (n,), dtype=np.uint64)
                     for q in qs], axis=-2)


def _eq(got, ref):
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(ref))


def _pairs(limbs) -> list:
    """JAX (rows, 2k) u32 lo/hi limb tables -> rows of u64 ints."""
    a = np.asarray(limbs, dtype=np.uint64)
    return (a[..., 0::2] | (a[..., 1::2] << np.uint64(32))).tolist()


@pytest.mark.parametrize("lead", [(), (3,)], ids=["J1", "J3"])
def test_half_polymul_plain(pair, lead):
    jp, jctx, ctx = pair
    rng = np.random.default_rng(1 + len(lead))
    x = _rand(rng, jp.q[:-1], jp.n, lead)
    y = _rand(rng, jp.q[:-1], jp.n)
    ref = jax.jit(lambda x, y: jntt.ntt_inverse(jntt.dyadic_mul(
        jntt.ntt_forward(x, jctx.tables_drop, jctx.ms_drop), y,
        jctx.ms_drop), jctx.tables_drop, jctx.ms_drop))(x, y)
    _eq(fused_ops.half_polymul_plain(convert.to_torch(x, device="cpu"),
                                     convert.to_torch(y, device="cpu"),
                                     ctx.tables_drop), ref)


def test_keygen_fused_plain(pair):
    jp, jctx, ctx = pair
    s_b, a, e_d = sampling.keygen_draws_compact(jp.n, jp.r, ctx.tables_full.ms,
                                                nonce=4)
    ms, tb = jctx.ms_full, jctx.tables_full

    @jax.jit
    def ref(s_b, a, e_d):
        sk = jntt.ntt_forward(jsamp._residues(s_b, ms), tb, ms)
        x = jntt.ntt_inverse(jntt.dyadic_mul(a, sk, ms), tb, ms)
        x = jpoly.poly_add_negate(x, jsamp._residues(e_d, ms), ms)
        return sk, jntt.ntt_forward(x, tb, ms)

    sk_r, pk0_r = ref(s_b.numpy(), convert.to_numpy(a), e_d.numpy())
    sk, pk0 = fused_ops.keygen_fused_plain(s_b, a, e_d, ctx.tables_full)
    _eq(sk, sk_r)
    _eq(pk0, pk0_r)


@pytest.mark.parametrize("J", [1, 3])
def test_encrypt_fused_plain(pair, J):
    jp, jctx, ctx = pair
    rng = np.random.default_rng(7 + J)
    pk = np.stack([_rand(rng, jp.q, jp.n), _rand(rng, jp.q, jp.n)])
    m = rng.integers(0, jp.t, (J, jp.n), dtype=np.int64)
    m[:, :4] = [0, jp.t - 1, jp.t // 2, (jp.t + 1) // 2]
    draws = [sampling.encrypt_draws_compact(jp.n, nonce=k + 1, device="cpu")
             for k in range(J)]
    u_b = torch.stack([d[0] for d in draws])
    e_d = torch.stack([d[1] for d in draws])
    c = jctx

    @jax.jit
    def ref(u_b, e_d, pk, m):
        return jbfv._encrypt_one_drawn(
            jsamp._residues(u_b, c.ms_full), jsamp._residues(e_d, c.ms_full),
            pk, m.astype(jnp.uint64), c.ms_full, c.ms_drop, c.ms_last,
            c.tables_full, None, c.dr_consts, c.msg_consts, None, jp.n, jp.r,
            "xla")

    got = fused_ops.encrypt_fused_plain(u_b,
                                        convert.to_torch(pk, device="cpu"),
                                        e_d,
                                        torch.from_numpy(m), ctx.tables_full,
                                        ctx.tail_consts)
    for j in range(J):
        _eq(got[j], ref(u_b[j].numpy(), e_d[j].numpy(), pk, m[j]))


@pytest.mark.parametrize("lead", [(), (3,)], ids=["J1", "J3"])
def test_decrypt_tail_plain(pair, lead):
    jp, jctx, ctx = pair
    rng = np.random.default_rng(11 + len(lead))
    x = _rand(rng, jp.q[:-1], jp.n, lead)
    c0 = _rand(rng, jp.q[:-1], jp.n, lead)
    for i, q in enumerate(jp.q[:-1]):          # x + c0 == q: stays unreduced
        x[..., i, :2] = [q - 1, 3]
        c0[..., i, :2] = [1, q - 3]
    ms, dc = jctx.ms_drop, jctx.dec_consts

    @jax.jit
    def ref(x, c0):
        y = jpoly.poly_add(x, c0, ms)
        y = jpoly.poly_mul_scalar_mont(y, dc.prod_t_gamma_mont, ms)
        y = jpoly.poly_mul_scalar_mont(y, dc.inv_punctured_mont, ms)
        return jpoly.fast_convert_and_round(y, dc)

    got = bfv_tail.decrypt_tail_plain(convert.to_torch(x, device="cpu"),
                                      convert.to_torch(c0, device="cpu"),
                                      ctx.dec_tail_consts)
    _eq(got, ref(x, c0))


def test_tail_constants_match_jax(pair):
    jp, _, ctx = pair
    tc, jtc = ctx.tail_consts, jtail.TailConsts.build(jp)
    assert convert.to_numpy(tc.per_mod).tolist() == _pairs(jtc.per_mod)
    assert [tc.q_last, tc.half] == _pairs(np.asarray(jtc.glob)[None])[0]
    assert tc.fix_th == jtc.fix_th == jtail._fix_threshold(jp.t)
    dt, jdt = ctx.dec_tail_consts, jtail.DecTailConsts.build(jp)
    assert convert.to_numpy(dt.per_mod).tolist() == _pairs(jdt.per_mod)
    assert convert.to_numpy(dt.glob).tolist() == _pairs(
        np.asarray(jdt.glob)[None])[0]
    assert dt.tmeta == jdt.tmeta
    pow2, t, neg_t, nu_t, inv_gt = bfv_tail._t_strategy(dt.tmeta)
    assert (pow2 == 1) == (jp.t & (jp.t - 1) == 0)
    assert (t, neg_t) == (jdt.t, jdt.neg_t)


def test_fix_threshold_and_t_checks():
    for t in (2, 3, 1024, T_ODD, 2**31 - 1):
        assert bfv_tail._fix_threshold(t) == jtail._fix_threshold(t)
        assert all((m + (t + 1) // 2) // t == (m >= bfv_tail._fix_threshold(t))
                   for m in (0, 1, t // 2 - 1, t // 2, (t + 1) // 2, t - 1))
    for t in (2**32 + 15, 2**62 - 57):     # past the JAX kernels' u32 bound
        assert all((m + (t + 1) // 2) // t == (m >= bfv_tail._fix_threshold(t))
                   for m in (0, 1, t // 2 - 1, t // 2, (t + 1) // 2, t - 1))
    with pytest.raises(ValueError, match="2\\^62"):
        bfv_tail._fix_threshold(2**62)
