"""The RNS-sharded program's kernels and constants (ntt_cuda_tpu_torch:
kernels 16, 17 and 18, the padded tail constants, the partial sums)
against the JAX package, exactly (tolerance 0).

* The plain versions of kernels 16 (encrypt_tail_padded), 17
  (decrypt_tail_partial) and 18 (encrypt_front) against the JAX Pallas
  kernels in interpret mode, at n = 2048, r = 4, rl = 2, for a rank that
  holds the dropped (global last) modulus and one that does not, with a
  power-of-two t and an odd batching prime t; kernel 17 also over a level-1
  rank whose rows end in a q = 1 pad row.
* The padded constants and the mod-switch constants against the JAX
  package's for every published set, every rank count dividing r and every
  level.
* The all-reduced sums: combine_gamma_halves past R = 8 and, at R = 8,
  r = 16, the summed per-rank partials rounded by dec_round_from_sums equal
  to the single-card decrypt tail.
* A rank's keygen draws equal to the rows of the single-card draws.
* The .cu sources built as host code with g++ (as in
  tests/test_torch_kernels.py): kernels 16, 17 and 18 against their plain
  versions, kernel 18 also at 2^15 and at every cluster size B (one
  thread-block cluster per polynomial of u).
* On the card (`-m gpu`): each kernel against its plain version at 32k_9q
  rank shapes (kernel 18 at every cluster size B: tests/test_torch_kernels.py
  test_cuda_encrypt_cluster_sizes_match_plain).  The JAX package is
  imported inside the tests that use it, so that the card's machine, which
  has no jax, runs this file's `-m gpu` test: `python -m pytest
  --noconftest -p no:cacheprovider -m gpu tests/test_torch_spmd_kernels.py`.
"""

import ctypes
import dataclasses
import functools
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from ntt_cuda_tpu_torch import convert, cuda, get_bfv_params
from ntt_cuda_tpu_torch.ops import bfv_tail, fused_ops, ntt, sampling
from ntt_cuda_tpu_torch.params import BFV_SETS
from ntt_cuda_tpu_torch.parallel import mesh, multihost, spmd
from ntt_cuda_tpu_torch.utils import primegen

N, BITS, R_MODULI = 2048, 40, 4
T_ODD = primegen.find_plain_modulus(N, 17)
BANDS = ((0, 2), (2, 4))        # rl = 2: the second holds the dropped row


@functools.cache
def _jax():
    """The JAX package's modules these tests hold the port against."""
    import jax
    import jax.numpy as jnp
    from ntt_cuda_tpu import params
    from ntt_cuda_tpu.ops import bfv_tail, fused_ops, ntt_pallas, sampling
    from ntt_cuda_tpu.parallel import spmd as jspmd
    from ntt_cuda_tpu.utils import primegen as jprimegen
    return types.SimpleNamespace(jax=jax, jnp=jnp, params=params,
                                 tail=bfv_tail, fused=fused_ops,
                                 ntt_pallas=ntt_pallas, sampling=sampling,
                                 spmd=jspmd, primegen=jprimegen)


def _jax_params(t=None, r=R_MODULI):
    kw = {} if t is None else {"t": t}
    return _jax().primegen.make_bfv_params(N, BITS, r, **kw)


@pytest.fixture(scope="module", params=[None, T_ODD],
                ids=["pow2_t", "odd_t"])
def sets(request):
    """(JAX params, the port's equal params) at n = 2048, r = 4."""
    jp = _jax_params(request.param)
    return jp, convert.params_from(jp)


def _rand_rows(rng, qs, n, lead=()):
    return np.stack([rng.integers(0, q, lead + (n,), dtype=np.uint64)
                     for q in qs], axis=-2)


def _t(a) -> torch.Tensor:
    return convert.to_torch(np.asarray(a))


def _u64(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint64)


def _pairs_to_u64(per_mod) -> np.ndarray:
    """A JAX constant table of u32 lo/hi pairs -> u64 columns."""
    a = np.asarray(per_mod).astype(np.uint64)
    return a[..., 0::2] | (a[..., 1::2] << np.uint64(32))


def _band_tables(ftab, r, lo, hi):
    return _jax().jax.tree.map(lambda x: x[lo:hi] if getattr(x, "ndim", 0) >= 2
                        and x.shape[0] == r else x, ftab)


# --- the plain versions against the JAX kernels in interpret mode ----------

@pytest.mark.parametrize("band", BANDS, ids=lambda b: f"rows{b[0]}-{b[1]}")
def test_encrypt_front_plain_matches_jax(sets, band, rng):
    J = _jax()
    jp, pp = sets
    lo, hi = band
    u_b, _ = J.sampling.encrypt_draws_compact(N, nonce=3, ks_impl="xla")
    pk = _rand_rows(rng, jp.q[lo:hi], N, (2,))
    ftab = _band_tables(J.ntt_pallas.tables_for(jp), jp.r, lo, hi)
    ref = J.fused.encrypt_front(u_b, J.jnp.asarray(pk), ftab, interpret=True)
    tb = ntt.NTTTables.build(pp.q[lo:hi], pp.psi[lo:hi], N, device="cpu")
    got = fused_ops.encrypt_front(torch.from_numpy(np.array(u_b)), _t(pk),
                                  tb)
    np.testing.assert_array_equal(convert.to_numpy(got), _u64(ref))


@pytest.mark.parametrize("band", BANDS, ids=lambda b: f"rows{b[0]}-{b[1]}")
def test_encrypt_tail_padded_plain_matches_jax(sets, band, rng):
    J = _jax()
    jp, pp = sets
    lo, hi = band
    c = _rand_rows(rng, jp.q[lo:hi], N, (2,))
    e = _rand_rows(rng, jp.q[lo:hi], N, (2,))
    c[:, :, 0] = np.asarray(jp.q[lo:hi], np.uint64) - np.uint64(1)
    e[:, :, 0] = 1                      # c + e == q: the strict-`>` quirk
    ra = rng.integers(0, jp.q[-1], (2, N), dtype=np.uint64)
    m = rng.integers(0, jp.t, N, dtype=np.uint64)
    m[:4] = [0, jp.t - 1, jp.t // 2, jp.t // 2 - 1]
    tc = J.tail.build_tail_consts_padded(jp)
    tc = dataclasses.replace(tc, per_mod=tc.per_mod[lo:hi])
    ref = J.tail.encrypt_tail_padded(J.jnp.asarray(c), J.jnp.asarray(e),
                                     J.jnp.asarray(ra), J.jnp.asarray(m), tc,
                                     interpret=True)
    got = bfv_tail.encrypt_tail_padded(
        _t(c), _t(e), _t(ra), _t(m),
        bfv_tail.build_tail_consts_padded(pp, lo, hi))
    np.testing.assert_array_equal(convert.to_numpy(got), _u64(ref))


@pytest.mark.parametrize("case", ["rows0-2", "rows2-4", "level1_rows2-4"])
def test_decrypt_tail_partial_plain_matches_jax(sets, case, rng):
    """Level 1 over rows [2, 4): row 2 is the level's dropped modulus
    (zeroed BEHZ row) and row 3 a q = 1 pad row holding any values."""
    J = _jax()
    jp, pp = sets
    level = 1 if case.startswith("level1") else 0
    lo, hi = (0, 2) if case == "rows0-2" else (2, 4)
    x = _rand_rows(rng, jp.q[lo:hi], N)
    c0 = _rand_rows(rng, jp.q[lo:hi], N)
    jcp = J.spmd._chain_params(jp, level)
    pcp = spmd._chain_params(pp, level)
    if level:
        x[-1] = rng.integers(0, 1 << 62, N, dtype=np.uint64)
        dc = J.tail.build_dec_tail_consts_padded(jcp, 0, jcp.r, pad_to=jp.r)
        dc = dataclasses.replace(dc, per_mod=dc.per_mod[lo:hi])
    else:
        dc = J.tail.build_dec_tail_consts_padded(jp, lo, hi)
    xt, xg = J.tail.decrypt_tail_partial(J.jnp.asarray(x), J.jnp.asarray(c0),
                                         dc, interpret=True)
    got_t, got_g = bfv_tail.decrypt_tail_partial(
        _t(x), _t(c0), bfv_tail.build_dec_tail_consts_padded(
            pcp, lo, min(hi, pcp.r), pad_to=hi))
    np.testing.assert_array_equal(convert.to_numpy(got_t), _u64(xt))
    np.testing.assert_array_equal(convert.to_numpy(got_g), _u64(xg))


# --- constants against the JAX package's, every published set -------------

@pytest.mark.parametrize("name", sorted(BFV_SETS))
def test_padded_constants_match_jax(name):
    J = _jax()
    jp, pp = J.params.get_bfv_params(name), get_bfv_params(name)
    r = jp.r
    tc = J.tail.build_tail_consts_padded(jp)
    tc_rows = _pairs_to_u64(tc.per_mod)
    for R in (R for R in range(1, r + 1) if r % R == 0):
        rl = r // R
        for lo in range(0, r, rl):
            got = bfv_tail.build_tail_consts_padded(pp, lo, lo + rl)
            np.testing.assert_array_equal(convert.to_numpy(got.per_mod),
                                          tc_rows[lo:lo + rl])
            assert (got.q_last, got.fix_th) == (int(_pairs_to_u64(
                tc.glob)[0]), tc.fix_th)
    for level in range(r - 1):
        jcp, pcp = J.spmd._chain_params(jp, level), spmd._chain_params(pp,
                                                                      level)
        assert (pcp.q, pcp.psi, pcp.t, pcp.gamma) == (jcp.q, jcp.psi, jcp.t,
                                                      jcp.gamma)
        dc = J.tail.build_dec_tail_consts_padded(jcp, 0, jcp.r, pad_to=r)
        dc_rows = _pairs_to_u64(dc.per_mod)
        for R in (R for R in range(1, r + 1) if r % R == 0):
            rl = r // R
            for lo in range(0, r, rl):
                got = bfv_tail.build_dec_tail_consts_padded(
                    pcp, lo, min(lo + rl, pcp.r), pad_to=lo + rl)
                np.testing.assert_array_equal(convert.to_numpy(got.per_mod),
                                              dc_rows[lo:lo + rl])
                np.testing.assert_array_equal(convert.to_numpy(got.glob),
                                              _pairs_to_u64(dc.glob))
                assert (got.t, got.nu_t) == (dc.t, dc.nu_t)
    for level in range(r - 3):
        hmod, invq, qlast, half = J.spmd._mod_switch_consts_padded(jp, level)
        got = spmd._mod_switch_consts_padded(pp, level)
        assert got[0] == tuple(int(v) for v in np.asarray(hmod).ravel())
        assert got[1] == tuple(int(v) for v in np.asarray(invq).ravel())
        assert got[2:] == (qlast, half)


# --- the all-reduced sums --------------------------------------------------

def test_combine_gamma_halves_beyond_8_ranks(rng):
    """Exact where a direct u64 sum of the gamma partials would wrap
    (R gamma >= 2^64, R > 8 for the published gamma)."""
    p = get_bfv_params("4k_3q")
    g = p.gamma
    for R in (8, 9, 16, 64):
        parts = rng.integers(0, g, (R, 257), dtype=np.uint64)
        parts[:, 0] = g - 1
        total = parts.astype(object).sum(axis=0)
        if R > 8:
            assert (total >= (1 << 64)).any()
        lo = (parts & np.uint64(0xFFFFFFFF)).sum(axis=0, dtype=np.uint64)
        hi = (parts >> np.uint64(32)).sum(axis=0, dtype=np.uint64)
        got = convert.to_numpy(bfv_tail.combine_gamma_halves(_t(lo), _t(hi),
                                                             p))
        assert (got < np.uint64(2) * np.uint64(g)).all()
        np.testing.assert_array_equal(
            got % np.uint64(g), np.array([int(v) % g for v in total],
                                         dtype=np.uint64))
        jnp = _jax().jnp
        np.testing.assert_array_equal(
            got, np.asarray(_jax().tail.combine_gamma_halves(
                jnp.asarray(lo), jnp.asarray(hi), p)))


@pytest.mark.parametrize("t", [None, T_ODD], ids=["pow2_t", "odd_t"])
def test_summed_partials_equal_decrypt_tail_r16_R8(t, rng):
    """Eight ranks of two rows each at r = 16: the per-rank partials,
    summed as the all-reduce sums them, recombined and rounded, equal the
    single-card decrypt tail (port and JAX)."""
    jp = _jax_params(t, r=16)
    pp = convert.params_from(jp)
    x = _rand_rows(rng, jp.q, N)
    c0 = _rand_rows(rng, jp.q, N)
    parts = []
    for k in range(8):
        xt, xg = bfv_tail.decrypt_tail_partial(
            _t(x[2 * k:2 * k + 2]), _t(c0[2 * k:2 * k + 2]),
            bfv_tail.build_dec_tail_consts_padded(pp, 2 * k, 2 * k + 2))
        parts.append(torch.stack([xt, xg & 0xFFFFFFFF, xg >> 32]))
    sums = torch.stack(parts).sum(dim=0)
    xg = bfv_tail.combine_gamma_halves(sums[1], sums[2], pp)
    got = bfv_tail.dec_round_from_sums(sums[0], xg, pp)
    want = bfv_tail.decrypt_tail_plain(
        _t(x[:-1]), _t(c0[:-1]), bfv_tail.DecTailConsts.build(pp))
    np.testing.assert_array_equal(convert.to_numpy(got),
                                  convert.to_numpy(want))
    J = _jax()
    jgot = J.tail.dec_round_from_sums(
        J.jnp.asarray(convert.to_numpy(sums[0])),
        J.tail.combine_gamma_halves(J.jnp.asarray(convert.to_numpy(sums[1])),
                                    J.jnp.asarray(convert.to_numpy(sums[2])),
                                    jp), jp)
    np.testing.assert_array_equal(convert.to_numpy(got), _u64(jgot))


# --- a rank's draws ---------------------------------------------------------

@pytest.mark.parametrize("nonce", [0, 3])
def test_keygen_draws_rank_are_rows_of_the_full_draw(nonce):
    pp = convert.params_from(_jax_params())
    full = ntt.tables_for(pp, device="cpu").ms
    s_b, a, e_d = sampling.keygen_draws_compact(N, pp.r, full, nonce=nonce)
    for rl in (1, 2, 4):
        for lo in range(0, pp.r, rl):
            ms = ntt.NTTTables.build(pp.q[lo:lo + rl], pp.psi[lo:lo + rl],
                                     N, device="cpu").ms
            got = sampling.keygen_draws_rank(N, pp.r, lo, lo + rl, ms,
                                             nonce=nonce)
            for g, w in zip(got, (s_b, a[lo:lo + rl], e_d)):
                assert torch.equal(g, w)


# --- entry points without a process group or a card ------------------------

def test_build_without_process_group_or_card_raises():
    pp = get_bfv_params("4k_3q")
    with pytest.raises(RuntimeError, match="process group"):
        spmd.SpmdBFVContext.build(pp, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.make_mesh(1, 1)
        with pytest.raises(RuntimeError, match="NCCL"):
            multihost.initialize("localhost:1", 1, 0)


# --- the .cu sources as host code ------------------------------------------

@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """csrc/*.cu built as host C++ with g++, bound like the CUDA build."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not available to build the kernels as host code")
    out = tmp_path_factory.mktemp("hostkernels") / "libntt_host.so"
    cmd = [gxx, "-x", "c++", "-std=c++17", "-O2", "-shared", "-fPIC",
           "-o", str(out), *[str(cuda.CSRC / s) for s in cuda.SOURCES]]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return cuda.bind(ctypes.CDLL(str(out)))


def _host_front(lib, u_b, pk, tb):
    c = torch.empty_like(pk)
    assert lib.ntt_encrypt_front(u_b.data_ptr(), pk.data_ptr(), c.data_ptr(),
                                 *tb.kernel_args(), tb.r, tb.logn, None) == 0
    return c


@pytest.mark.parametrize("where", ["n2048_rows2-4", "32k_9q_rows6-9"])
def test_host_encrypt_front(host_lib, where, rng):
    """Kernel 18 at n = 2048 and at 2^15 (one launch of a cluster per
    polynomial of u at the launchers' B, with no e)."""
    if where.startswith("32k"):
        pp, (lo, hi) = get_bfv_params("32k_9q"), (6, 9)
    else:
        pp, (lo, hi) = convert.params_from(_jax_params()), (2, 4)
    tb = ntt.NTTTables.build(pp.q[lo:hi], pp.psi[lo:hi], pp.n, device="cpu")
    u_b, _ = sampling.encrypt_draws_compact(pp.n, nonce=5, device="cpu")
    pk = _t(_rand_rows(rng, pp.q[lo:hi], pp.n, (2,)))
    assert torch.equal(_host_front(host_lib, u_b, pk, tb),
                       fused_ops.encrypt_front_plain(u_b, pk, tb))


# where -> (u_b, pk, tables, the plain front): every B of a case has the
# same inputs, so the plain version runs once per case
_FRONT = {}


@pytest.mark.parametrize("B", [0, 1, 2, 4, 8], ids=lambda B: f"B{B}")
@pytest.mark.parametrize("where", ["n2048_rows2-4", "32k_9q_rows6-9"])
def test_host_encrypt_front_cluster(host_lib, where, B):
    """Kernel 18 through the entry point that takes the cluster size B (0:
    the rule) at a rank's rows, n = 2048 and 2^15; B = 1 and 2 at 2^15 (two
    2^14 buffers a block) refused."""
    if where not in _FRONT:
        if where.startswith("32k"):
            pp, (lo, hi) = get_bfv_params("32k_9q"), (6, 9)
        else:
            pp, (lo, hi) = convert.params_from(_jax_params()), (2, 4)
        tb = ntt.NTTTables.build(pp.q[lo:hi], pp.psi[lo:hi], pp.n,
                                 device="cpu")
        u_b, _ = sampling.encrypt_draws_compact(pp.n, nonce=7, device="cpu")
        pk = _t(_rand_rows(np.random.default_rng(hi), pp.q[lo:hi], pp.n,
                           (2,)))
        threads = torch.get_num_threads()
        torch.set_num_threads(1)   # the suite's workers share the cores
        try:
            ref = fused_ops.encrypt_front_plain(u_b, pk, tb)
        finally:
            torch.set_num_threads(threads)
        _FRONT[where] = (u_b, pk, tb, ref)
    u_b, pk, tb, ref = _FRONT[where]
    c = torch.empty_like(pk)
    rc = host_lib.ntt_encrypt_front_cluster(
        u_b.data_ptr(), pk.data_ptr(), c.data_ptr(), *tb.kernel_args(), tb.r,
        tb.logn, B, None)
    if B and 2 * tb.n // B > 16384:
        assert rc != 0
        return
    assert rc == 0 and torch.equal(c, ref)


@pytest.mark.parametrize("band", BANDS, ids=lambda b: f"rows{b[0]}-{b[1]}")
def test_host_encrypt_tail_padded(host_lib, sets, band, rng):
    _, pp = sets
    lo, hi = band
    tc = bfv_tail.build_tail_consts_padded(pp, lo, hi)
    c = _t(_rand_rows(rng, pp.q[lo:hi], N, (2,)))
    e = _t(_rand_rows(rng, pp.q[lo:hi], N, (2,)))
    ra = torch.from_numpy(rng.integers(0, pp.q[-1], (2, N)))
    m = torch.from_numpy(rng.integers(0, pp.t, N))
    ct = torch.empty_like(c)
    assert host_lib.ntt_encrypt_tail_padded(
        c.data_ptr(), e.data_ptr(), ra.data_ptr(), m.data_ptr(),
        ct.data_ptr(), tc.per_mod.data_ptr(), tc.q_last, tc.fix_th, hi - lo,
        N, None) == 0
    assert torch.equal(ct, bfv_tail.encrypt_tail_padded_plain(c, e, ra, m,
                                                              tc))
    assert host_lib.ntt_encrypt_tail_padded(
        c.data_ptr(), None, ra.data_ptr(), m.data_ptr(), ct.data_ptr(),
        tc.per_mod.data_ptr(), tc.q_last, tc.fix_th, hi - lo, N, None) != 0


@pytest.mark.parametrize("case", ["rows0-2", "rows2-4", "level1_rows2-4"])
def test_host_decrypt_tail_partial(host_lib, sets, case, rng):
    _, pp = sets
    level = 1 if case.startswith("level1") else 0
    lo, hi = (0, 2) if case == "rows0-2" else (2, 4)
    cp = spmd._chain_params(pp, level)
    dc = bfv_tail.build_dec_tail_consts_padded(cp, lo, min(hi, cp.r),
                                               pad_to=hi)
    x = _t(_rand_rows(rng, pp.q[lo:hi], N))
    c0 = _t(_rand_rows(rng, pp.q[lo:hi], N))
    out = torch.empty((2, N), dtype=torch.int64)
    t = pp.t
    assert host_lib.ntt_decrypt_tail_partial(
        x.data_ptr(), c0.data_ptr(), out.data_ptr(), dc.per_mod.data_ptr(),
        dc.glob.data_ptr(), hi - lo, N, int(t & (t - 1) == 0), t, dc.nu_t,
        None) == 0
    want = bfv_tail.decrypt_tail_partial_plain(x, c0, dc)
    assert torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("band", [(0, 3), (6, 9), (0, 9)],
                         ids=lambda b: f"rows{b[0]}-{b[1]}")
def test_cuda_spmd_kernels_match_plain(cuda_device, band):
    pp = get_bfv_params("32k_9q")
    lo, hi = band
    rng = np.random.default_rng(lo + hi)
    dev = cuda_device
    tb = ntt.NTTTables.build(pp.q[lo:hi], pp.psi[lo:hi], pp.n, dev)
    u_b, _ = sampling.encrypt_draws_compact(pp.n, nonce=5, device=dev)
    pk = _t(_rand_rows(rng, pp.q[lo:hi], pp.n, (2,))).to(dev)
    assert torch.equal(fused_ops.encrypt_front(u_b, pk, tb),
                       fused_ops.encrypt_front_plain(u_b, pk, tb))
    tc = bfv_tail.build_tail_consts_padded(pp, lo, hi, dev)
    c, e = (_t(_rand_rows(rng, pp.q[lo:hi], pp.n, (2,))).to(dev)
            for _ in range(2))
    ra = torch.from_numpy(rng.integers(0, pp.q[-1], (2, pp.n))).to(dev)
    m = torch.from_numpy(rng.integers(0, pp.t, pp.n)).to(dev)
    assert torch.equal(bfv_tail.encrypt_tail_padded(c, e, ra, m, tc),
                       bfv_tail.encrypt_tail_padded_plain(c, e, ra, m, tc))
    dc = bfv_tail.build_dec_tail_consts_padded(pp, lo, hi, device=dev)
    x, c0 = (_t(_rand_rows(rng, pp.q[lo:hi], pp.n)).to(dev) for _ in range(2))
    got = bfv_tail.decrypt_tail_partial(x, c0, dc)
    want = bfv_tail.decrypt_tail_partial_plain(x, c0, dc)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.cuda.synchronize()
