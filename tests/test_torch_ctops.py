"""The port's ciphertext ops (add, sub, negate, add_plain, sub_plain,
mul_plain, next_context, mod_switch_to_next, noise_budget) against the JAX
package's `backend="xla"` context at 4k_3q, on the CPU, exactly; and the
corrected poly_sub and the exact add at sums equal to q.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ntt_cuda_tpu.models import bfv as jbfv
from ntt_cuda_tpu.ops import modmath as jmm
from ntt_cuda_tpu.ops import poly as jpoly
from ntt_cuda_tpu.params import get_bfv_params as jget
from ntt_cuda_tpu_torch import BFVContext, convert, get_bfv_params
from ntt_cuda_tpu_torch.ops import modmath, poly


@pytest.fixture(scope="module")
def setup():
    """(JAX xla context, port CPU context, sk, pk, messages (2, n),
    ciphertexts (2, 2, r-1, n)); the messages put m1 + m2 >= t on the
    first lanes."""
    jctx = jbfv.BFVContext.build(jget("4k_3q"), backend="xla")
    ctx = BFVContext.build(get_bfv_params("4k_3q"), device="cpu")
    p = ctx.params
    sk, pk = ctx.keygen(1)
    m = np.random.default_rng(7).integers(0, p.t, (2, p.n), dtype=np.uint64)
    m[:, :8] = p.t - 1
    cts = ctx.encrypt_batch(pk, m, [1, 2])
    return jctx, ctx, sk, pk, m, cts


def _eq(got, ref):
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(ref))


def _np(t):
    return convert.to_numpy(t)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "J2"])
def test_add_sub_negate_match_jax(setup, batched):
    jctx, ctx, sk, _, m, cts = setup
    t = ctx.params.t
    a, b = (cts, cts.flip(0)) if batched else (cts[0], cts[1])
    q = _np(ctx.tables_drop.ms.q)
    for op, want in (("add", (m[0] + m[1]) % t), ("sub", (m[0] - m[1]) % t)):
        got = getattr(ctx, op)(a, b)
        _eq(got, getattr(jctx, op)(_np(a), _np(b)))
        assert (_np(got) < q).all()
        first = got[0] if batched else got
        _eq(ctx.decrypt(sk, first), want)
    neg = ctx.negate(a)
    _eq(neg, jctx.negate(_np(a)))
    _eq(ctx.decrypt(sk, neg[0] if batched else neg), (t - m[0]) % t)


def test_add_is_exact_at_q_and_poly_sub_is_corrected(setup):
    """Sums that land exactly on q reduce to 0 (the exact add, not
    encrypt's strict `>`), and poly_sub subtracts."""
    jctx, ctx, _, _, _, cts = setup
    ms = ctx.tables_drop.ms
    q = ms.q                                            # (r-1, 1)
    a = cts[0]
    b = torch.where(a == 0, a, q - a)                   # a + b == q or 0
    s = ctx.add(a, b)
    assert not s.any()
    _eq(s, jctx.add(_np(a), _np(b)))
    rng = np.random.default_rng(8)
    qs = [int(v) for v in q.flatten()]
    x = np.stack([rng.integers(0, v, 64, dtype=np.uint64) for v in qs])
    y = np.stack([rng.integers(0, v, 64, dtype=np.uint64) for v in qs])
    y[:, :2] = x[:, :2]                                 # a == b
    got = poly.poly_sub(convert.to_torch(x, device="cpu"),
                        convert.to_torch(y, device="cpu"), ms)
    _eq(got, jpoly.poly_sub(jnp.asarray(x), jnp.asarray(y),
                            jmm.modulus_set(jget("4k_3q"), 2)))
    want = [[(int(u) - int(v)) % qi for u, v in zip(xr, yr)]
            for xr, yr, qi in zip(x, y, qs)]
    assert _np(got).tolist() == want
    _eq(poly.poly_negate(convert.to_torch(x, device="cpu"), ms),
        jmm.negate_mod(jnp.asarray(x), jnp.asarray(np.asarray(qs, np.uint64)
                                                   [:, None])))
    assert modmath.negate_mod(torch.zeros(2, 1, dtype=torch.int64),
                              q).eq(0).all()


def test_plain_ops_match_jax(setup):
    jctx, ctx, sk, _, m, cts = setup
    p = ctx.params
    ct = cts[0]
    m2 = m[1]
    _eq(ctx.add_plain(ct, m2), jctx.add_plain(_np(ct), m2))
    _eq(ctx.sub_plain(ct, m2), jctx.sub_plain(_np(ct), m2))
    _eq(ctx.decrypt(sk, ctx.add_plain(ct, m2)), (m[0] + m2) % p.t)
    _eq(ctx.decrypt(sk, ctx.sub_plain(ct, m2)), (m[0] - m2) % p.t)
    assert torch.equal(ctx.sub_plain(ctx.add_plain(ct, m2), m2), ct)
    mono = np.zeros(p.n, np.uint64)
    mono[17] = 1
    sparse = np.zeros(p.n, np.uint64)
    sparse[[0, 5, 300]] = [7, p.t - 1, 2]
    for plain in (mono, sparse):
        got = ctx.mul_plain(ct, plain)
        _eq(got, jctx.mul_plain(_np(ct), plain))
    exp = np.empty(p.n, np.uint64)                      # x^17: a shift
    exp[17:] = m[0][: p.n - 17]
    exp[:17] = (p.t - m[0][p.n - 17:]) % p.t            # wrapped: -1
    _eq(ctx.decrypt(sk, ctx.mul_plain(ct, mono)), exp)
    with pytest.raises(ValueError, match="m_poly: expected shape"):
        ctx.mul_plain(ct, mono[:8])
    with pytest.raises(ValueError, match="ct: expected shape"):
        ctx.add_plain(cts, m2)


def test_mod_switch_matches_jax(setup):
    jctx, ctx, sk, _, m, cts = setup
    p = ctx.params
    for ct in (cts[0], ctx.mul(cts[0], cts[1])):       # L = 2 and L = 3
        got = ctx.mod_switch_to_next(ct)
        assert tuple(got.shape) == (ct.shape[0], p.r - 2, p.n)
        _eq(got, jctx.mod_switch_to_next(_np(ct)))
    nxt = ctx.next_context()
    assert nxt is ctx.next_context()                   # cached
    assert nxt.params.q == p.q[:-1] and nxt.params.name == "4k_3q@L2"
    assert (nxt.device, nxt.fusion) == (ctx.device, ctx.fusion)
    _eq(nxt.decrypt(sk, ctx.mod_switch_to_next(cts[0])), m[0])
    with pytest.raises(ValueError, match="chain exhausted"):
        nxt.next_context()
    with pytest.raises(ValueError, match=r"ct: expected shape \(L>=2"):
        ctx.mod_switch_to_next(cts[0][0])


def test_noise_budget_matches_jax(setup):
    """Equal integers to the JAX package's: fresh, after mul_plain, at
    L = 3, one level down, and on a corrupted ciphertext."""
    jctx, ctx, sk, _, _, cts = setup
    ct = cts[0]
    sparse = np.zeros(ctx.params.n, np.uint64)
    sparse[[0, 9]] = [3, 5]
    garbage = ct.clone()
    garbage[0] ^= 1 << 20
    budgets = []
    for c in (ct, ctx.mul_plain(ct, sparse), ctx.mul(ct, cts[1]), garbage):
        budgets.append(ctx.noise_budget(sk, c))
        assert budgets[-1] == jctx.noise_budget(_np(sk), _np(c))
    fresh, scaled, l3, bad = budgets
    assert fresh > 40 and 0 < scaled < fresh and 0 <= l3 < fresh and bad <= 2
    low = ctx.mod_switch_to_next(ct)
    assert (ctx.next_context().noise_budget(sk, low)
            == jctx.next_context().noise_budget(_np(sk), _np(low)))
