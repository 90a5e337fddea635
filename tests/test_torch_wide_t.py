"""Odd plaintext moduli t >= 2^31 in the port (the decrypt kernels' wide
mod-t strategy: K2, 15 and 17 on Montgomery products mod t) against the
JAX package's `backend="xla"` context, which runs every odd t, on the CPU,
exactly.

Two t's at n = 2048 over three 60-bit moduli:

* t33: `find_plain_modulus(2048, 33)` = 4294991873, with moduli === 1 mod
  2nt (`make_bfv_params(2048, 60, 3, t=...)`): a working BFV set, so the
  round trip gives m back;
* t62: the largest batching prime below 2^62, the port's bound and the
  width of the JAX package's mod-t arithmetic (ops/poly.py
  fast_convert_and_round: Montgomery products mod t whose sums, below 2t,
  fit 64 bits; its add_message assumes q === 1 mod t, so no working t
  reaches the 2^62 moduli), over the same three moduli (t > q: the
  message does not survive, but every integer is JAX's).

The host build of csrc/ (`cuda.host_library`) runs K2 (every G), 17 and 15 at these
t's and at the narrowest wide t against their plain versions.
"""

import functools

import numpy as np
import pytest
import torch

from ntt_cuda_tpu.models import bfv as jbfv
from ntt_cuda_tpu.models import encoder as jenc
from ntt_cuda_tpu import params as jparams
from ntt_cuda_tpu_torch import BFVContext, convert, cuda
from ntt_cuda_tpu_torch.models.encoder import BatchEncoder
from ntt_cuda_tpu_torch.ops import bfv_tail, ntt
from ntt_cuda_tpu_torch.params import BFVParams
from ntt_cuda_tpu_torch.utils import primegen

N = 2048


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in
    several worker processes at once."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _largest_batching_prime(n: int, below: int) -> int:
    step = 2 * n
    t = (below - 1) // step * step + 1
    while not primegen.is_prime(t):
        t -= step
    return t


@functools.cache
def _params(name: str) -> BFVParams:
    if name == "t33":
        return primegen.make_bfv_params(
            N, 60, 3, t=primegen.find_plain_modulus(N, 33))
    base = primegen.make_bfv_params(N, 60, 3)
    return BFVParams(name="gen_2048_60b_3q_t62", n=N, q=base.q, psi=base.psi,
                     t=_largest_batching_prime(N, bfv_tail.T_MAX))


def _jax_params(p: BFVParams):
    return jparams.BFVParams(name=p.name, n=p.n, q=p.q, psi=p.psi, t=p.t)


@pytest.fixture(scope="module", params=["t33", "t62"])
def pair(request):
    p = _params(request.param)
    return (jbfv.BFVContext.build(_jax_params(p), backend="xla"),
            BFVContext.build(p, device="cpu"))


def _np(t):
    return convert.to_numpy(t)


def _eq(got, ref):
    np.testing.assert_array_equal(_np(got), np.asarray(ref))


def test_t_values_and_strategy():
    assert _params("t33").t == 4294991873
    t62 = _params("t62").t
    assert t62 < 2**62 and t62 % (2 * N) == 1 and t62.bit_length() == 62
    assert bfv_tail._t_mode(1 << 20) == 1
    assert bfv_tail._t_mode(2**31 - 1) == 0
    assert bfv_tail._t_mode(2**31 + 1) == 2
    assert bfv_tail._t_mode(t62) == 2


def test_build_refusals():
    base = primegen.make_bfv_params(N, 60, 3)
    for t, match in ((2**62 + 1, "2\\^62"), (6, "neither")):
        with pytest.raises(ValueError, match=match):
            BFVContext.build(BFVParams(name="x", n=N, q=base.q, psi=base.psi,
                                       t=t), device="cpu")


def test_roundtrip_and_decrypt_batch_match_jax(pair):
    """encrypt, encrypt_batch (each row against the JAX package's encrypt),
    decrypt_batch and decrypt (each row against the JAX package's
    decrypt_batch); keygen does not read t, so the port's keys serve both
    packages."""
    jctx, ctx = pair
    p = ctx.params
    sk, pk = ctx.keygen(1)
    jsk, jpk = _np(sk), _np(pk)
    m = np.random.default_rng(5).integers(0, p.t, (2, p.n), dtype=np.uint64)
    m[:, :4] = [0, 1, p.t - 1, p.t // 2]
    cts = ctx.encrypt_batch(pk, m, [3, 4])
    for j in range(2):
        _eq(cts[j], jctx.encrypt(jpk, m[j], nonce=3 + j))
    want = np.asarray(jctx.decrypt_batch(jsk, _np(cts)))
    _eq(ctx.decrypt_batch(sk, cts), want)
    for j in range(2):
        _eq(ctx.decrypt(sk, cts[j]), want[j])
    if p.t < p.q[0]:
        _eq(ctx.decrypt(sk, cts[0]), m[0])


def test_noise_budget_and_plain_ops_match_jax(pair):
    """noise_budget against the JAX package's; add_plain and sub_plain
    (the message path at such a t) undo each other."""
    jctx, ctx = pair
    p = ctx.params
    sk, pk = ctx.keygen(2)
    m = np.random.default_rng(6).integers(0, p.t, p.n, dtype=np.uint64)
    ct = ctx.encrypt(pk, m, nonce=7)
    assert ctx.noise_budget(sk, ct) == jctx.noise_budget(_np(sk), _np(ct))
    assert torch.equal(ctx.sub_plain(ctx.add_plain(ct, m), m), ct)


def test_encoder_matches_jax(pair):
    jctx, ctx = pair
    p = ctx.params
    enc, jenc_ = BatchEncoder(p, device="cpu"), jenc.BatchEncoder(jctx.params)
    v = np.random.default_rng(8).integers(0, p.t, p.n, dtype=np.uint64)
    v[:2] = [p.t - 1, 0]
    plain = enc.encode(v)
    _eq(plain, jenc_.encode(v))
    _eq(enc.decode(plain), jenc_.decode(_np(plain)))
    _eq(enc.decode(plain), v)


def test_mul_matches_jax_or_raises_its_error(pair):
    """EvalMult where the JAX package runs it, and its ValueError where it
    refuses (its aux base is too small for such a t)."""
    jctx, ctx = pair
    p = ctx.params
    sk, pk = ctx.keygen(3)
    m = np.random.default_rng(9).integers(0, p.t, (2, p.n), dtype=np.uint64)
    a, b = (ctx.encrypt(pk, m[i], nonce=10 + i) for i in range(2))
    try:
        want = jctx.mul(_np(a), _np(b))
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            ctx.mul(a, b)
        return
    got = ctx.mul(a, b)
    _eq(got, want)
    _eq(ctx.decrypt(sk, got), jctx.decrypt(_np(sk), _np(got)))


# --- the decrypt kernels' wide strategy on the host build -----------------



@pytest.fixture(scope="module")
def host_lib():
    """csrc/*.cu built as host C++, once per checkout (cuda.host_library)."""
    try:
        return cuda.host_library()
    except cuda.NoHostCompiler as e:
        pytest.skip(str(e))


@functools.cache
def _rk_params(rk: int, t: int) -> BFVParams:
    if t < 2**40:
        return primegen.make_bfv_params(256, 60, rk + 1, t=t)
    base = primegen.make_bfv_params(256, 60, rk + 1)
    return BFVParams(name=f"x{rk}", n=256, q=base.q, psi=base.psi, t=t)


_T_NARROWEST = primegen.find_plain_modulus(256, 32)       # just above 2^31
_WIDE_TS = {"t32": _T_NARROWEST, "t33": primegen.find_plain_modulus(256, 33),
            "t62": _largest_batching_prime(256, bfv_tail.T_MAX)}


def _rand_res(rng, qs, n, lead=()):
    return torch.from_numpy(np.stack(
        [rng.integers(0, q, lead + (n,), dtype=np.int64) for q in qs],
        axis=-2))


@pytest.mark.parametrize("tname", list(_WIDE_TS))
@pytest.mark.parametrize("rk", [1, 3, 9, 16, 23])
def test_host_decrypt_tail_wide_t(host_lib, rk, tname):
    """K2 at J = 2, by the launchers' rule and at G = 1, 2, 4 and 8, against
    decrypt_tail_plain (the JAX package's Montgomery chain)."""
    p = _rk_params(rk, _WIDE_TS[tname])
    assert bfv_tail._t_mode(p.t) == 2
    rng = np.random.default_rng(rk)
    dt = bfv_tail.DecTailConsts.build(p)
    x = _rand_res(rng, p.q[:-1], p.n, (2,))
    c0 = _rand_res(rng, p.q[:-1], p.n, (2,))
    x[:, 0, :2] = torch.tensor([p.q[0] - 1, 0])
    c0[:, 0, :2] = torch.tensor([1, 0])
    want = bfv_tail.decrypt_tail_plain(x, c0, dt)
    args = bfv_tail._t_strategy(dt.tmeta)
    assert args[0] == 2
    out = torch.empty((2, p.n), dtype=torch.int64)
    assert host_lib.ntt_decrypt_tail(
        x.data_ptr(), c0.data_ptr(), out.data_ptr(), dt.k2_rows.data_ptr(),
        dt.glob.data_ptr(), 2, rk, p.n, *args, None) == 0
    assert torch.equal(out, want)
    for G in (1, 2, 4, 8):
        if rk > 16 * G:
            continue
        out.zero_()
        assert host_lib.ntt_decrypt_tail_group(
            0, G, x.data_ptr(), c0.data_ptr(), out.data_ptr(),
            dt.k2_rows.data_ptr(), dt.glob.data_ptr(), 2, rk, p.n,
            *args) == 0
        assert torch.equal(out, want), G


@pytest.mark.parametrize("tname", list(_WIDE_TS))
def test_host_decrypt_fused_wide_t(host_lib, tname):
    """Kernel 15 at every B against decrypt_fused_plain."""
    p = _rk_params(4, _WIDE_TS[tname])
    rk = p.r - 1
    td = ntt.tables_for(p, rk, device="cpu")
    dc = bfv_tail.DecTailConsts.build(p)
    rng = np.random.default_rng(15)
    x, sk, c0 = (_rand_res(rng, p.q[:rk], p.n) for _ in range(3))
    want = bfv_tail.decrypt_fused_plain(x, sk, c0, td, dc)
    for B in (1, 2, 4, 8):
        out = torch.zeros((p.n,), dtype=torch.int64)
        assert host_lib.ntt_decrypt_fused(
            x.data_ptr(), sk.data_ptr(), c0.data_ptr(),
            torch.empty_like(x).data_ptr(), out.data_ptr(),
            *td.kernel_args(), dc.k2_rows.data_ptr(), dc.glob.data_ptr(), rk,
            td.logn, *bfv_tail._t_strategy(dc.tmeta), B, None) == 0
        assert torch.equal(out, want), B


@pytest.mark.parametrize("tname", list(_WIDE_TS))
def test_partials_wide_t(host_lib, tname):
    """Kernel 17 on each of four ranks' bands (the dropped modulus's rank
    included) at the rule and at G = 1 and 8, against its plain version;
    the bands' partials, all-reduced as 32-bit halves (x_t's too at such a
    t) and rounded, equal the single-card decrypt tail."""
    p = _rk_params(7, _WIDE_TS[tname])
    rng = np.random.default_rng(17)
    x = _rand_res(rng, p.q, p.n)
    c0 = _rand_res(rng, p.q, p.n)
    halves = []
    for lo in range(0, p.r, 2):
        dc = bfv_tail.build_dec_tail_consts_padded(p, lo, lo + 2)
        xs, cs = x[lo:lo + 2].contiguous(), c0[lo:lo + 2].contiguous()
        want = bfv_tail.decrypt_tail_partial_plain(xs, cs, dc)
        out = torch.empty((2, p.n), dtype=torch.int64)
        assert host_lib.ntt_decrypt_tail_partial(
            xs.data_ptr(), cs.data_ptr(), out.data_ptr(),
            dc.k2_rows.data_ptr(), dc.glob.data_ptr(), 2, p.n,
            bfv_tail._t_mode(p.t), p.t, dc.nu_t, None) == 0
        assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])
        for G in (1, 8):
            assert host_lib.ntt_decrypt_tail_group(
                1, G, xs.data_ptr(), cs.data_ptr(), out.data_ptr(),
                dc.k2_rows.data_ptr(), dc.glob.data_ptr(), 1, 2, p.n,
                bfv_tail._t_mode(p.t), p.t, 0, dc.nu_t, 0) == 0
            assert torch.equal(out[0], want[0]), G
        assert (want[0] < p.t).all()
        halves.append(torch.stack([v >> s & 0xFFFFFFFF for v in want
                                   for s in (0, 32)]))
    sums = torch.stack(halves).sum(dim=0)
    x_t = bfv_tail._combine_halves(sums[0], sums[1], p.t)
    x_g = bfv_tail.combine_gamma_halves(sums[2], sums[3], p)
    got = bfv_tail.dec_round_from_sums(x_t, x_g, p)
    dt = bfv_tail.DecTailConsts.build(p)
    assert torch.equal(got, bfv_tail.decrypt_tail_plain(x[:-1], c0[:-1], dt))
