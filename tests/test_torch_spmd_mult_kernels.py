"""The sharded EvalMult's kernels and constants (ntt_cuda_tpu_torch: kernel
20, the band forms of 21a-c, kernel 16's modulus-drop launch, the padded
banks and a rank's key draws) against the JAX package, exactly (tolerance
0).

* Kernel 20's plain version (fused_ops.keyswitch_front) against JAX's
  keyswitch_front_fused in interpret mode over the bands (0, 4), (0, 2)
  and (3, 1) of r = 4 moduli, as tests/test_fused_ops.py holds it against
  the unfused chain.
* The band conversions' plain versions against JAX's behz_pallas *_rows
  kernels in interpret mode and against the port's full plain conversions
  sliced, at (0, 1), (k, 1) and (0, k + 1), bsk_to_q's zero pad row
  included, as tests/test_behz_pallas.py holds JAX's.
* SpmdMultConsts against JAX's SpmdMultConsts.host_build for every
  published set.
* A rank's relinearization and Galois draws equal to the rows of the
  single-card draws.
* The .cu sources built as host code with g++ (as in
  tests/test_torch_kernels.py): the band conversions at r = 4, 4k_3q,
  32k_9q and 32k_16q constants, kernel 20 as the stage launches with
  r := rl (2^15 included), and the drop launch, each against its plain
  version.
* On the card (`-m gpu`): each kernel against its plain version at 32k_9q
  rank shapes.  JAX is imported inside the tests that use it, so that the
  card's machine, which has no jax, runs `python -m pytest --noconftest
  -p no:cacheprovider -m gpu tests/test_torch_spmd_mult_kernels.py`.
"""

import functools
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from ntt_cuda_tpu_torch import convert, cuda, get_bfv_params
from ntt_cuda_tpu_torch.ops import (behz, behz_kernels, bfv_tail, fused_ops,
                                    ntt, sampling)
from ntt_cuda_tpu_torch.params import BFV_SETS
from ntt_cuda_tpu_torch.parallel import spmd_mult
from ntt_cuda_tpu_torch.utils import primegen

ROOT = Path(__file__).resolve().parents[1]
N, BITS, R_MODULI = 2048, 40, 4
KS_N = 256      # kernel 20 in interpret mode: the smallest four-step ring
KS_BANDS = ((0, 4), (0, 2), (3, 1))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs, as in
    tests/test_torch_kernels.py: the suite runs in several worker processes
    at once, and oversubscribed torch threads slow the plain versions by
    two orders of magnitude."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.cache
def _jax():
    """The JAX package's modules these tests hold the port against."""
    import jax
    import jax.numpy as jnp
    from ntt_cuda_tpu import params
    from ntt_cuda_tpu.ops import behz as jbehz
    from ntt_cuda_tpu.ops import behz_pallas, fused_ops as jfused, ntt_pallas
    from ntt_cuda_tpu.parallel import spmd_mult as jspmd_mult
    from ntt_cuda_tpu.utils import primegen as jprimegen
    return types.SimpleNamespace(jax=jax, jnp=jnp, params=params,
                                 behz=jbehz, behz_pallas=behz_pallas,
                                 fused=jfused, ntt_pallas=ntt_pallas,
                                 spmd_mult=jspmd_mult, primegen=jprimegen)


def _rand_rows(rng, qs, n, lead=()):
    return np.stack([rng.integers(0, q, lead + (n,), dtype=np.uint64)
                     for q in qs], axis=-2)


def _t(a) -> torch.Tensor:
    return convert.to_torch(np.asarray(a), device="cpu")


def _u64(a) -> np.ndarray:
    return np.asarray(a).astype(np.uint64)


@functools.cache
def _consts(name: str):
    """(params, aux, SpmdMultConsts) of a published set or "r4" (n = 2048,
    four 40-bit moduli), on the CPU."""
    p = (primegen.make_bfv_params(N, BITS, R_MODULI) if name == "r4"
         else get_bfv_params(name))
    aux = behz.AuxBase.build(p)
    return p, aux, behz_kernels.SpmdMultConsts.build(p, aux)


# --- kernel 20 and the band conversions: plain against JAX ----------------
#
# JAX's interpret-mode kernels take 10-25 s each to lower and compile on the
# CPU, once per band width, so each group of cases runs in a subprocess of
# its own (this file as a script), all started together; inputs come from
# per-case seeds, made alike in both processes.

ROW_BANDS = ((0, 1), (3, 1), (0, 4))     # (0, 1), (k, 1), (0, k + 1)
JAX_GROUPS = [("ks", (b,)) for b in KS_BANDS] + [("rows", ROW_BANDS[:2]),
                                                 ("rows", ROW_BANDS[2:])]


def _band_id(b):
    return f"rows{b[0]}-{b[0] + b[1]}"


def _ks_inputs(band):
    """Kernel 20's case: the port's params at KS_N, c2 (k, n) and key rows
    (2, k, rl, n) over the band."""
    p = primegen.make_bfv_params(KS_N, BITS, R_MODULI)
    row0, rl = band
    rng = np.random.default_rng(200 + 10 * row0 + rl)
    k = p.r - 1
    c2 = _rand_rows(rng, p.q[:k], KS_N)
    ksk = np.stack([_rand_rows(rng, p.q[row0:row0 + rl], KS_N, (k,))
                    for _ in range(2)])
    return p, c2, ksk


def _row_inputs(band):
    """The band conversions' case at r = 4: xq (2, k, n) with the range
    ends, the band's Bsk rows xb (2, rl, n), and y (2, k + 1, n), a
    fast_floor output (bsk_to_q's domain, as in mul)."""
    pp, aux, mc = _consts("r4")
    row0, rl = band
    rng = np.random.default_rng(300 + 10 * row0 + rl)
    k = pp.r - 1
    xq = _rand_rows(rng, pp.q[:k], N, (2,))
    xq[..., :2] = [[0, q - 1] for q in pp.q[:k]]
    xb = _rand_rows(rng, aux.bsk, N, (2,))
    y = convert.to_numpy(behz_kernels.fast_floor_plain(_t(xq), _t(xb),
                                                       mc.banks))
    return xq, xb, y


def _jax_group(kind: str, bands, out: Path) -> None:
    """JAX's interpret-mode results of one group, as out/<kind>_<row0>_<rl>
    .npz (run in a subprocess)."""
    J = _jax()
    for row0, rl in bands:
        sl = slice(row0, row0 + rl)
        if kind == "ks":
            pp, c2, ksk = _ks_inputs((row0, rl))
            jp = J.primegen.make_bfv_params(KS_N, BITS, R_MODULI)
            assert tuple(jp.q) == pp.q
            ftab = J.jax.tree.map(lambda x: x[sl] if getattr(x, "ndim", 0)
                                  >= 2 and x.shape[0] == jp.r else x,
                                  J.ntt_pallas.tables_for(jp))
            nu = [(1 << 64) // int(q) for q in jp.q[sl]]
            nub = J.jnp.asarray(np.array([(v & 0xFFFFFFFF, v >> 32)
                                          for v in nu], dtype=np.uint32))
            res = {"ks": J.fused.keyswitch_front_fused(
                J.jnp.asarray(c2), J.jnp.asarray(ksk), ftab, nub,
                interpret=True)}
        else:
            xq, xb, y = _row_inputs((row0, rl))
            mpc = J.behz_pallas.MultPallasConsts.build(
                J.primegen.make_bfv_params(N, BITS, R_MODULI))
            jx, r0 = J.jnp.asarray(xq), J.jnp.int32(row0)
            res = {"a": J.behz_pallas.rns_to_bsk_rows(jx, mpc, r0, rl,
                                                      interpret=True),
                   "f": J.behz_pallas.fast_floor_rows(
                       jx, J.jnp.asarray(xb[..., sl, :]), mpc, r0, rl,
                       interpret=True),
                   "c": J.behz_pallas.bsk_to_q_rows(J.jnp.asarray(y), mpc,
                                                    r0, rl, interpret=True)}
        np.savez(out / f"{kind}_{row0}_{rl}.npz",
                 **{key: _u64(v) for key, v in res.items()})


@pytest.fixture(scope="module")
def jax_refs(tmp_path_factory):
    """The directory of JAX's results for every group of JAX_GROUPS."""
    out = tmp_path_factory.mktemp("jax_refs")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen(
        [sys.executable, __file__, kind, str(out),
         ",".join(f"{a}:{b}" for a, b in bands)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=str(ROOT)) for kind, bands in JAX_GROUPS]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=600)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for (kind, bands), proc, text in zip(JAX_GROUPS, procs, outs):
        assert proc.returncode == 0, f"JAX {kind} {bands}:\n{text}"
    return out


@pytest.mark.parametrize("band", KS_BANDS, ids=_band_id)
def test_keyswitch_front_plain_matches_jax(jax_refs, band):
    """Kernel 20's plain version against JAX's keyswitch_front_fused; the
    band holding q_last lifts the digits mod q_last too."""
    pp, c2, ksk = _ks_inputs(band)
    row0, rl = band
    tb = ntt.NTTTables.build(pp.q[row0:row0 + rl], pp.psi[row0:row0 + rl],
                             KS_N, device="cpu")
    got = fused_ops.keyswitch_front(_t(c2), _t(ksk), tb)
    ref = np.load(jax_refs / f"ks_{row0}_{rl}.npz")["ks"]
    np.testing.assert_array_equal(convert.to_numpy(got), ref)


@pytest.mark.parametrize("band", ROW_BANDS, ids=_band_id)
def test_band_conversions_match_jax_and_full(jax_refs, band):
    """r = 4 (k = 3): the three band conversions against JAX's *_rows and
    against the full plain conversions sliced.  bsk_to_q's band is rows
    of the padded layout: row k is 0."""
    pp, _, mc = _consts("r4")
    xq, xb, y = _row_inputs(band)
    k, (row0, rl) = pp.r - 1, band
    sl = slice(row0, row0 + rl)
    xq, xb, y = _t(xq), _t(xb), _t(y)
    full = {"a": behz_kernels.rns_to_bsk_plain(xq, mc.banks),
            "f": behz_kernels.fast_floor_plain(xq, xb, mc.banks),
            "c": behz_kernels.bsk_to_q_plain(y, mc.banks)}
    got = {"a": behz_kernels.rns_to_bsk_rows(xq, mc, row0, rl),
           "f": behz_kernels.fast_floor_rows(xq, xb[..., sl, :].contiguous(),
                                             mc, row0, rl),
           "c": behz_kernels.bsk_to_q_rows(y, mc, row0, rl)}
    ref = np.load(jax_refs / f"rows_{row0}_{rl}.npz")
    live = min(row0 + rl, k) - row0
    for key in "afc":
        np.testing.assert_array_equal(convert.to_numpy(got[key]), ref[key],
                                      err_msg=key)
        want = full[key][..., row0:row0 + (live if key == "c" else rl), :]
        assert torch.equal(got[key][..., :want.shape[-2], :], want), key
    assert (got["c"][..., live:, :] == 0).all()


def test_band_arguments_raise():
    _, _, mc = _consts("r4")
    x = torch.zeros((3, 64), dtype=torch.int64)
    with pytest.raises(ValueError, match="target rows"):
        behz_kernels.rns_to_bsk_rows(x, mc, 3, 2)
    with pytest.raises(ValueError, match="expected shape"):
        behz_kernels.bsk_to_q_rows(x, mc, 0, 1)
    with pytest.raises(ValueError, match="does not match"):
        behz_kernels.fast_floor_rows(x, torch.zeros((1, 32), dtype=torch.int64),
                                     mc, 0, 1)


# --- the padded banks, every published set ----------------------------------

@pytest.mark.parametrize("name", sorted(BFV_SETS))
def test_spmd_mult_consts_match_jax(name):
    J = _jax()
    jp, pp = J.params.get_bfv_params(name), get_bfv_params(name)
    jaux, aux = J.behz.AuxBase.build(jp), behz.AuxBase.build(pp)
    assert (jaux.bsk, jaux.bsk_psi) == (aux.bsk, aux.bsk_psi)
    ref = J.spmd_mult.SpmdMultConsts.host_build(jp, jaux)
    got = behz_kernels.SpmdMultConsts.host_build(pp, aux)
    assert sorted(got) == sorted(ref)
    for key, v in got.items():
        assert v.dtype == np.uint64, key
        np.testing.assert_array_equal(v, _u64(ref[key]), err_msg=key)
    mc = behz_kernels.SpmdMultConsts.build(pp, aux)
    for key, v in got.items():
        np.testing.assert_array_equal(convert.to_numpy(getattr(mc, key)), v,
                                      err_msg=key)


# --- a rank's key draws -----------------------------------------------------

@pytest.mark.parametrize("nonce", [0, 5])
def test_key_draws_rank_are_rows_of_the_full_draws(nonce):
    pp, _, _ = _consts("r4")
    n, r, k = pp.n, pp.r, pp.r - 1
    full = ntt.tables_for(pp, device="cpu").ms
    a, e = sampling.relin_draws(n, r, k, full, nonce=nonce)
    ga, ge = sampling.galois_draws(n, r, k, [3, 2 * n - 1], full, nonce=nonce)
    for rl in (1, 2, 4):
        for lo in range(0, r, rl):
            sl = slice(lo, lo + rl)
            ms = ntt.NTTTables.build(pp.q[sl], pp.psi[sl], n, device="cpu").ms
            got = sampling.relin_draws_rank(n, r, k, lo, lo + rl, ms,
                                            nonce=nonce)
            assert torch.equal(got[0], a[:, sl])
            assert torch.equal(got[1], e[:, sl])
            got = sampling.galois_draws_rank(n, r, k, [3, 2 * n - 1], lo,
                                             lo + rl, ms, nonce=nonce)
            assert torch.equal(got[0], ga[:, :, sl])
            assert torch.equal(got[1], ge[:, :, sl])


# --- the .cu sources as host code ------------------------------------------

@pytest.fixture(scope="module")
def host_lib():
    """csrc/*.cu built as host C++, once per checkout (cuda.host_library)."""
    try:
        return cuda.host_library()
    except cuda.NoHostCompiler as e:
        pytest.skip(str(e))


def _host_band(lib, which, x, xb, out, mc, row0, group=0):
    n, rl = x.shape[-1], out.shape[-2]
    return lib.ntt_behz(which, x.data_ptr(),
                        None if xb is None else xb.data_ptr(), out.data_ptr(),
                        *mc.banks.kernel_args(), out.numel() // (rl * n),
                        mc.k, n, row0, rl, group, None)


@pytest.mark.parametrize("name", ["r4", "4k_3q", "32k_9q", "32k_16q"])
def test_host_band_conversions(host_lib, name):
    """Every band of R = 1, 2, ... ranks that divides r, and one odd band;
    (2, 3) leads; every group size G of the kernels (0: the rule).  The
    conversions are per coefficient, so the 32k sets' constants are
    checked over n = 2048."""
    pp, aux, mc = _consts(name)
    k, n = mc.k, 2048
    rng = np.random.default_rng(k)
    xq = _t(_rand_rows(rng, pp.q[:k], n, (2, 3)))
    xb = _t(_rand_rows(rng, aux.bsk, n, (2, 3)))
    bands = {(lo, rl) for rl in range(1, k + 2) if (k + 1) % rl == 0
             for lo in range(0, k + 1, rl)} | {(1, k)}
    for row0, rl in sorted(bands):
        xbr = xb[..., row0:row0 + rl, :].contiguous()
        for which, args, plain in (
                (behz_kernels.RNS_TO_BSK, (xq, None),
                 behz_kernels.rns_to_bsk_rows_plain),
                (behz_kernels.FAST_FLOOR, (xq, xbr),
                 behz_kernels.fast_floor_rows_plain),
                (behz_kernels.BSK_TO_Q, (xb, None),
                 behz_kernels.bsk_to_q_rows_plain)):
            ref = plain(*[a for a in args if a is not None], mc, row0, rl)
            for G in (0,) + behz_kernels.GROUPS:
                out = torch.empty_like(ref)
                assert _host_band(host_lib, which, *args, out, mc, row0,
                                  G) == 0
                assert torch.equal(out, ref), (which, row0, rl, G)
    out = torch.empty((2, 3, 2, n), dtype=torch.int64)
    assert _host_band(host_lib, behz_kernels.BSK_TO_Q, xb, None, out, mc,
                      k) != 0                  # rows k, k + 1: past the pad


@pytest.mark.parametrize("where", ["r4_rows2-4_J2", "32k_9q_rows6-9"])
def test_host_keyswitch_front(host_lib, where, rng):
    """Kernel 20: the PRO_DIGIT forward and PRO_KSACC inverse with r := rl
    over a band holding q_last, against the plain front; at 2^15 the
    stage-0 passes beside the halves."""
    if where.startswith("32k"):
        pp, (lo, hi), J = get_bfv_params("32k_9q"), (6, 9), 1
    else:
        pp, (lo, hi), J = _consts("r4")[0], (2, 4), 2
    k, n, rl = pp.r - 1, pp.n, hi - lo
    tb = ntt.NTTTables.build(pp.q[lo:hi], pp.psi[lo:hi], n, device="cpu")
    c2 = _t(_rand_rows(rng, pp.q[:k], n, (J,)))
    ksk = _t(np.stack([_rand_rows(rng, pp.q[lo:hi], n, (k,))
                       for _ in range(2)]))
    dhat = torch.empty((J, k, rl, n), dtype=torch.int64)
    acc = torch.empty((J, 2, rl, n), dtype=torch.int64)
    assert host_lib.ntt_stage_forward(c2.data_ptr(), None, None,
                                      tb.ms.nu.data_ptr(), dhat.data_ptr(),
                                      *tb.kernel_args(), cuda.PRO_DIGIT,
                                      J * k * rl, rl, tb.logn, None, 0, 0, None) == 0
    assert host_lib.ntt_stage_inverse(dhat.data_ptr(), ksk.data_ptr(), None,
                                      acc.data_ptr(), *tb.kernel_args(),
                                      cuda.PRO_KSACC, k, J * 2 * rl, rl,
                                      tb.logn, None, 0, 0, None) == 0
    assert torch.equal(acc, fused_ops.keyswitch_front_plain(c2, ksk, tb))


@pytest.mark.parametrize("band", [(0, 2), (2, 4), (0, 4)],
                         ids=lambda b: f"rows{b[0]}-{b[1]}")
def test_host_drop_last_padded(host_lib, band, rng):
    """Kernel 16's launch with no e and no message against the JAX
    formula, the dropped row's inverse 0 included (rows 2-4, 0-4)."""
    pp, _, mc = _consts("r4")
    lo, hi = band
    tc = spmd_mult.drop_consts(mc, pp.q[-1], lo, hi)
    c = _t(_rand_rows(rng, pp.q[lo:hi], N, (2,)))
    ra = torch.from_numpy(rng.integers(0, pp.q[-1], (2, N)))
    ct = torch.empty_like(c)
    assert host_lib.ntt_drop_last_padded(c.data_ptr(), ra.data_ptr(),
                                         ct.data_ptr(), tc.tail_rows.data_ptr(),
                                         tc.q_last, hi - lo, N, None) == 0
    assert torch.equal(ct, bfv_tail.drop_last_padded_plain(c, ra, tc))
    if hi == pp.r:
        assert (ct[:, -1] == 0).all()
    assert host_lib.ntt_drop_last_padded(c.data_ptr(), None, ct.data_ptr(),
                                         tc.tail_rows.data_ptr(), tc.q_last,
                                         hi - lo, N, None) != 0


def test_drop_last_padded_plain_is_the_jax_formula(rng):
    """The plain drop against JAX's _keyswitch_shard tail written out
    (spmd_mult.py:331-341) on the padded banks, the dropped row 0."""
    pp, _, mc = _consts("r4")
    r, q_last = pp.r, pp.q[-1]
    cc = _rand_rows(rng, pp.q, N, (2,))
    ra = rng.integers(0, q_last, (2, N), dtype=np.uint64)
    tc = spmd_mult.drop_consts(mc, q_last, 0, r)
    got = bfv_tail.drop_last_padded_plain(_t(cc), _t(ra), tc)
    hm, iq = (convert.to_numpy(mc.half_mod)[:, 0],
              convert.to_numpy(mc.inv_qlast_mont)[:, 0])
    want = np.empty_like(cc)
    for i, q in enumerate(pp.q):
        inv = int(iq[i]) * pow(2, -64, q) % q
        for h in range(2):
            v = [(int(c) - (int(a) % q - int(hm[i]))) * inv % q
                 for c, a in zip(cc[h, i], ra[h])]
            want[h, i] = v
    np.testing.assert_array_equal(convert.to_numpy(got), want)


# --- on the card -------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("band", [(0, 3), (6, 9), (0, 9)],
                         ids=lambda b: f"rows{b[0]}-{b[1]}")
def test_cuda_spmd_mult_kernels_match_plain(cuda_device, band):
    """32k_9q rank shapes: kernel 20 over (k, n) digits, the band
    conversions over mul's (2, 2, ., n) and (3, ., n), the drop."""
    pp = get_bfv_params("32k_9q")
    lo, hi = band
    rl, k, n, dev = hi - lo, pp.r - 1, pp.n, cuda_device
    rng = np.random.default_rng(lo + hi)
    aux = behz.AuxBase.build(pp)
    mc = behz_kernels.SpmdMultConsts.build(pp, aux, dev)
    tb = ntt.NTTTables.build(pp.q[lo:hi], pp.psi[lo:hi], n, dev)
    c2 = _t(_rand_rows(rng, pp.q[:k], n)).to(dev)
    ksk = _t(np.stack([_rand_rows(rng, pp.q[lo:hi], n, (k,))
                       for _ in range(2)])).to(dev)
    assert torch.equal(fused_ops.keyswitch_front(c2, ksk, tb),
                       fused_ops.keyswitch_front_plain(c2, ksk, tb))
    xq = _t(_rand_rows(rng, pp.q[:k], n, (2, 2))).to(dev)
    pq = _t(_rand_rows(rng, pp.q[:k], n, (3,))).to(dev)
    pb = _t(_rand_rows(rng, aux.bsk[lo:hi], n, (3,))).to(dev)
    fl = _t(_rand_rows(rng, aux.bsk, n, (3,))).to(dev)
    for got, want in (
            (behz_kernels.rns_to_bsk_rows(xq, mc, lo, rl),
             behz_kernels.rns_to_bsk_rows_plain(xq, mc, lo, rl)),
            (behz_kernels.fast_floor_rows(pq, pb, mc, lo, rl),
             behz_kernels.fast_floor_rows_plain(pq, pb, mc, lo, rl)),
            (behz_kernels.bsk_to_q_rows(fl, mc, lo, rl),
             behz_kernels.bsk_to_q_rows_plain(fl, mc, lo, rl))):
        assert torch.equal(got, want)
    tc = spmd_mult.drop_consts(mc, pp.q[-1], lo, hi)
    cc = _t(_rand_rows(rng, pp.q[lo:hi], n, (2,))).to(dev)
    ra = torch.from_numpy(rng.integers(0, pp.q[-1], (2, n))).to(dev)
    assert torch.equal(bfv_tail.drop_last_padded(cc, ra, tc),
                       bfv_tail.drop_last_padded_plain(cc, ra, tc))
    torch.cuda.synchronize()


if __name__ == "__main__":
    torch.set_num_threads(1)
    _jax_group(sys.argv[1], [tuple(int(v) for v in b.split(":"))
                             for b in sys.argv[3].split(",")],
               Path(sys.argv[2]))
