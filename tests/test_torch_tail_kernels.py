"""Kernels 12, 14 and 15 of the port against the JAX package and against
their CUDA sources built as host code, exactly (tolerance 0).

* Kernel 12, `ntt_stage.ntt_forward` / `ntt_inverse` with `mod_idx`
  (each polynomial over its own modulus): the plain version against JAX's
  xla transform over the gathered moduli at 4k_3q and a generated n = 2048
  set, B = 2r + 1 polynomials in a permuted order, both directions; once
  against JAX's Pallas kernel (`ntt_pallas.ntt_forward(..., mod_idx=...,
  interpret=True)`, which no JAX test reaches) at n = 2048; the refusals
  (an index outside [0, r), a wrong length, no mod_idx for a batch that
  is not (J, r, n)).
* Kernel 14, `bfv_tail.encrypt_tail`: the plain version against JAX's
  `encrypt_tail` in interpret mode at 4k_3q, as tests/test_bfv_tail.py runs
  it.
* Kernel 15, `bfv_tail.decrypt_fused`: on the reference's golden
  ciphertext (tests/fixtures/dec4k_*.npy) against JAX's xla INTT(x (.) sk)
  and decrypt-tail chain, and to i % 10.
* The host build of csrc/ (tests/test_torch_kernels.py's pattern): the
  three launchers against the plain versions, at 4k_3q and 32k_9q, kernel
  15 also with an odd prime t and at every cluster size B (B = 1 at 2^15
  refused); the encrypt tail in each of its TailConsts forms (K5 at J = 1
  and 3, 14, 19's drop) also at 32k_16q, aligned and offset by 8 bytes.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ntt_cuda_tpu.ops import bfv_tail as jtail
from ntt_cuda_tpu.ops import modmath as jmm
from ntt_cuda_tpu.ops import ntt as jntt
from ntt_cuda_tpu.ops import ntt_pallas as jpallas
from ntt_cuda_tpu.ops import poly as jpoly
from ntt_cuda_tpu.params import get_bfv_params as jget
from ntt_cuda_tpu.utils import primegen as jprimegen
from ntt_cuda_tpu_torch import convert, cuda, get_bfv_params
from ntt_cuda_tpu_torch.ops import bfv_tail, ntt, ntt_stage, poly
from ntt_cuda_tpu_torch.utils import primegen


FIX = Path(__file__).parent / "fixtures"
SETS = {"4k_3q": lambda: jget("4k_3q"),
        "gen_2048": lambda: jprimegen.make_bfv_params(2048, 50, 4)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def host_lib():
    """csrc/*.cu built as host C++, once per checkout (cuda.host_library)."""
    try:
        return cuda.host_library()
    except cuda.NoHostCompiler as e:
        pytest.skip(str(e))


def _rand(rng, qs, n, lead=()):
    return np.stack([rng.integers(0, q, lead + (n,), dtype=np.uint64)
                     for q in qs], axis=-2)


def _permuted(rng, jp):
    """B = 2r + 1 polynomials, moduli in a permuted order (every modulus
    at least twice), each reduced by its own modulus."""
    idx = rng.permutation(np.arange(2 * jp.r + 1) % jp.r).astype(np.int32)
    x = np.stack([rng.integers(0, jp.q[i], jp.n, dtype=np.uint64)
                  for i in idx])
    return idx, x


# --- kernel 12 ----------------------------------------------------------------

@pytest.mark.parametrize("inverse", [False, True], ids=["fwd", "inv"])
@pytest.mark.parametrize("name", sorted(SETS))
def test_mod_idx_plain_matches_jax(name, inverse):
    jp = SETS[name]()
    idx, x = _permuted(np.random.default_rng(jp.n + inverse), jp)
    qs = [jp.q[i] for i in idx]
    jt = jntt.NTTTables.build(qs, [jp.psi[i] for i in idx], jp.n)
    jms = jmm.ModulusSet.from_moduli(qs)
    ref = (jntt.ntt_inverse_jit if inverse else jntt.ntt_forward_jit)(
        jnp.asarray(x), jt, jms)
    tb = ntt.tables_for(convert.params_from(jp), device="cpu")
    fn = ntt_stage.ntt_inverse if inverse else ntt_stage.ntt_forward
    got = fn(convert.to_torch(x, device="cpu").reshape(1, -1, jp.n), tb,
             mod_idx=torch.from_numpy(idx))
    np.testing.assert_array_equal(convert.to_numpy(got)[0], np.asarray(ref))


def test_mod_idx_plain_matches_pallas_interpret():
    """JAX's kernel 12 itself (interpret mode) on three polynomials at
    n = 2048, moduli (2, 0, 2)."""
    jp = SETS["gen_2048"]()
    rng = np.random.default_rng(7)
    idx = np.array([2, 0, 2], np.int32)
    x = np.stack([rng.integers(0, jp.q[i], jp.n, dtype=np.uint64)
                  for i in idx])
    ref = jpallas.ntt_forward(jnp.asarray(x), jpallas.tables_for(jp),
                              mod_idx=idx, interpret=True)
    got = ntt_stage.ntt_forward(
        convert.to_torch(x, device="cpu"),
        ntt.tables_for(convert.params_from(jp), device="cpu"), mod_idx=idx)
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(ref))


def test_mod_idx_refusals():
    p = get_bfv_params("4k_3q")
    tb = ntt.tables_for(p, device="cpu")
    x = torch.zeros((5, p.n), dtype=torch.int64)
    with pytest.raises(ValueError, match="outside"):
        ntt_stage.ntt_forward(x, tb, mod_idx=[0, 1, 2, 3, 0])
    with pytest.raises(ValueError, match="outside"):
        ntt_stage.ntt_inverse(x, tb, mod_idx=[0, 1, -1, 2, 0])
    with pytest.raises(ValueError, match="entries"):
        ntt_stage.ntt_forward(x, tb, mod_idx=[0, 1, 2])
    with pytest.raises(ValueError, match="expected shape"):
        ntt_stage.ntt_forward(x, tb)          # 5 is not a multiple of r


# --- kernel 14 ----------------------------------------------------------------

def test_encrypt_tail_plain_matches_jax_interpret():
    jp = jget("4k_3q")
    rng = np.random.default_rng(14)
    c, e = _rand(rng, jp.q, jp.n, (2,)), _rand(rng, jp.q, jp.n, (2,))
    m = rng.integers(0, jp.t, jp.n, dtype=np.uint64)
    ref = jtail.encrypt_tail(jnp.asarray(c), jnp.asarray(e), jnp.asarray(m),
                             jtail.TailConsts.build(jp), interpret=True)
    p = convert.params_from(jp)
    got = bfv_tail.encrypt_tail(convert.to_torch(c, device="cpu"),
                                convert.to_torch(e, device="cpu"),
                                convert.to_torch(m, device="cpu"),
                                bfv_tail.TailConsts.build(p))
    np.testing.assert_array_equal(convert.to_numpy(got), np.asarray(ref))


# --- kernel 15 ----------------------------------------------------------------

def test_decrypt_fused_golden_matches_jax():
    """decrypt's back half on the reference's golden ciphertext: x =
    NTT(c1), then kernel 15's plain version against JAX's xla INTT(x (.)
    sk) and the decrypt tail's poly chain."""
    jp = jget("4k_3q")
    c0, c1, sk = (np.load(FIX / f"dec4k_{f}.npy") for f in ("c0", "c1",
                                                            "sk_ntt"))
    jt, jms = jntt.tables_for(jp, jp.r - 1), jmm.modulus_set(jp, jp.r - 1)
    x = np.asarray(jntt.ntt_forward_jit(jnp.asarray(c1), jt, jms))
    y = jntt.ntt_inverse_jit(jntt.dyadic_mul_jit(jnp.asarray(x),
                                                 jnp.asarray(sk), jms),
                             jt, jms)
    dc = jpoly.DecryptConsts.build(jp)
    y = jpoly.poly_add(y, jnp.asarray(c0), jms)
    y = jpoly.poly_mul_scalar_mont(y, dc.prod_t_gamma_mont, jms)
    y = jpoly.poly_mul_scalar_mont(y, dc.inv_punctured_mont, jms)
    ref = np.asarray(jpoly.fast_convert_and_round(y, dc))
    p = convert.params_from(jp)
    got = bfv_tail.decrypt_fused(
        *(convert.to_torch(v, device="cpu") for v in (x, sk, c0)),
        ntt.tables_for(p, p.r - 1, device="cpu"),
        bfv_tail.DecTailConsts.build(p))
    np.testing.assert_array_equal(convert.to_numpy(got), ref)
    np.testing.assert_array_equal(ref, np.arange(p.n) % 10)


# --- the host build -------------------------------------------------------------

HOST_SETS = ("4k_3q", "32k_9q")


@pytest.mark.parametrize("name", HOST_SETS)
def test_host_mod_idx(host_lib, name):
    p = get_bfv_params(name)
    tb = ntt.tables_for(p, device="cpu")
    rng = np.random.default_rng(12)
    idx = torch.from_numpy(
        rng.permutation(np.arange(2 * p.r + 1) % p.r).astype(np.int32))
    x = torch.from_numpy(np.stack([rng.integers(0, p.q[i], p.n,
                                                dtype=np.int64)
                                   for i in idx.tolist()]))
    B = len(idx)
    for inverse in (False, True):
        out = torch.empty_like(x)
        if inverse:
            rc = host_lib.ntt_stage_inverse(
                x.data_ptr(), None, None, out.data_ptr(), *tb.kernel_args(),
                cuda.PRO_COPY, 1, B, p.r, tb.logn, idx.data_ptr(), 0, 0,
                None)
        else:
            rc = host_lib.ntt_stage_forward(
                x.data_ptr(), None, None, None, out.data_ptr(),
                *tb.kernel_args(), cuda.PRO_COPY, B, p.r, tb.logn,
                idx.data_ptr(), 0, 0, None)
        assert rc == 0
        ref = ntt_stage.ntt_transform_idx_plain(x, tb, idx, inverse=inverse)
        torch.testing.assert_close(out, ref, rtol=0, atol=0)


def _offset(t: torch.Tensor, align: str) -> torch.Tensor:
    """t itself ("aligned"), or a copy of it 8 bytes past a 16-byte
    boundary ("offset"): the encrypt tail then takes one coefficient a
    thread (V = 1) instead of two."""
    if align == "aligned":
        return t
    buf = torch.empty(t.numel() + 1, dtype=t.dtype)
    i = 1 if buf.data_ptr() % 16 == 0 else 0
    return buf[i:i + t.numel()].view(t.shape).copy_(t)


# the encrypt tail's launch forms (csrc/fused_ops.cu EncryptTail) that take
# TailConsts: K5's and 13's (J = 1, 3), 14's (e added) and 19's drop (no
# message)
TAIL_FORMS = ("K5_J1", "K5_J3", "14", "19_drop")


@pytest.mark.parametrize("align", ["aligned", "offset"])
@pytest.mark.parametrize("form", TAIL_FORMS)
@pytest.mark.parametrize("name", HOST_SETS + ("32k_16q",))
def test_host_encrypt_tail(host_lib, name, form, align):
    """Each form against its plain version, bit for bit: K5 and 19's drop
    on a (J, 2, r, n) scratch (divide_and_round_q_last, then add_message
    for K5), 14 (encrypt_tail_plain).  32k_16q's rk = 15 leaves its lanes
    unequal rows; "offset" takes the V = 1 path."""
    p = get_bfv_params(name)
    rng = np.random.default_rng(15)
    tc = bfv_tail.TailConsts.build(p)
    rk, n = p.r - 1, p.n
    J = 3 if form == "K5_J3" else 1
    c = torch.from_numpy(_rand(rng, p.q, n, (J, 2)).view(np.int64))
    m = torch.from_numpy(rng.integers(0, p.t, (J, n), dtype=np.int64))
    m[0, :4] = torch.tensor([0, p.t - 1, p.t // 2, p.t // 2 - 1])
    out = _offset(torch.empty((J, 2, rk, n), dtype=torch.int64), align)
    cv, mv = _offset(c, align), _offset(m, align)
    if form == "14":
        e = torch.from_numpy(_rand(rng, p.q, n, (2,)).view(np.int64))
        assert host_lib.ntt_encrypt_tail_e(
            cv.data_ptr(), _offset(e, align).data_ptr(), mv.data_ptr(),
            out.data_ptr(), tc.tail_rows.data_ptr(), tc.q_last, tc.half,
            tc.fix_th, p.r, n, None) == 0
        want = bfv_tail.encrypt_tail_plain(c[0], e, m[0], tc)[None]
    else:
        msg = form != "19_drop"
        assert host_lib.ntt_encrypt_tail(
            cv.data_ptr(), mv.data_ptr() if msg else None, out.data_ptr(),
            tc.tail_rows.data_ptr(), tc.q_last, tc.half, tc.fix_th, J, p.r,
            n, None) == 0
        want = poly.divide_and_round_q_last(c, tc.dr, tc.ms_drop, tc.ms_last)
        if msg:
            want[:, 0] = poly.add_message(want[:, 0], m, tc.msg)
    torch.testing.assert_close(out, want, rtol=0, atol=0)


def _odd_t_params():
    p = get_bfv_params("4k_3q")
    return primegen.make_bfv_params(p.n, 50, p.r,
                                    t=primegen.find_plain_modulus(p.n, 17))


@pytest.mark.parametrize("B", [1, 2, 4, 8])
@pytest.mark.parametrize("name", HOST_SETS + ("odd_t",))
def test_host_decrypt_fused(host_lib, name, B):
    """Kernel 15 at cluster size B: every residue's cluster (the stage
    inverse's two phases), then the tail; B = 1 at 2^15, whose n/B buffer
    does not fit a block, refused."""
    p = _odd_t_params() if name == "odd_t" else get_bfv_params(name)
    rk = p.r - 1
    td = ntt.tables_for(p, rk, device="cpu")
    dc = bfv_tail.DecTailConsts.build(p)
    rng = np.random.default_rng(16)
    x, sk, c0 = (torch.from_numpy(_rand(rng, p.q[:rk], p.n).view(np.int64))
                 for _ in range(3))
    out = torch.zeros((p.n,), dtype=torch.int64)
    scratch = torch.empty_like(x)
    pow2, t, neg_t, nu_t, inv_gt = bfv_tail._t_strategy(dc.tmeta)
    rc = host_lib.ntt_decrypt_fused(
        x.data_ptr(), sk.data_ptr(), c0.data_ptr(), scratch.data_ptr(),
        out.data_ptr(), *td.kernel_args(), dc.k2_rows.data_ptr(),
        dc.glob.data_ptr(), rk, td.logn, pow2, t, neg_t, nu_t, inv_gt, B,
        None)
    if p.n // B > cuda.BLOCK_MAX_N:
        assert rc != 0
        assert not out.any()
        return
    assert rc == 0
    torch.testing.assert_close(
        out, bfv_tail.decrypt_fused_plain(x, sk, c0, td, dc), rtol=0, atol=0)
