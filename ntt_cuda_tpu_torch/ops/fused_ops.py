"""Whole-BFV-op transforms: half_polymul, keygen_fused, encrypt_fused,
keyswitch_fused, and for the RNS-sharded programs encrypt_front
(encrypt_fused's transform alone) and keyswitch_front (keyswitch_fused's
transforms alone, over a band of moduli).

Counterpart of `ntt_cuda_tpu/ops/fused_ops.py` for the main path.  On a
CUDA device each wrapper launches its kernel in csrc/fused_ops.cu.
half_polymul and keygen_fused: one block per polynomial (message x
modulus), resident in shared memory for its whole forward -> dyadic ->
inverse chain; at n = 32768 two blocks per polynomial, one per 2^14 half,
beside elementwise stage-0 passes (three or four launches a call).
encrypt_fused's transform and encrypt_front: one thread-block cluster of
B blocks per polynomial of u, one launch at every n <= 32768 (`cluster=`
picks B; 0 is the launchers' rule, ntt_stage.cluster_size), then
encrypt_fused's tail launch.  The key switch runs as two launches of
csrc/ntt_stage.cu (its front) and the encrypt tail.  On the
CPU each wrapper runs the plain version beside it, composed from
ops/ntt.py, ops/poly.py and the compact-draw maps of ops/sampling.py: the
same computation the JAX package's xla pipelines run (models/bfv.py:933-937,
1016-1023 and 1185-1197).

Draws arrive compact (int32 planes shared by all moduli): s and u
ternary, e Gaussian; the residue map d < 0 -> q + d happens inside.
"""

from __future__ import annotations

import torch

from .. import cuda
from . import bfv_tail, modmath, ntt, ntt_stage, poly, sampling
from .bfv_tail import TailConsts
from .modmath import I64
from .ntt import NTTTables


# --- half_polymul ----------------------------------------------------------

def half_polymul_plain(x, y_ntt, tables: NTTTables) -> torch.Tensor:
    """INTT(NTT(x) (.) y_ntt): ntt_forward -> dyadic -> ntt_inverse."""
    fx = ntt.ntt_forward(x, tables)
    return ntt.ntt_inverse(ntt.dyadic_mul(fx, y_ntt, tables.ms), tables)


def half_polymul(x, y_ntt, tables: NTTTables) -> torch.Tensor:
    """INTT(NTT(x) (.) y_ntt) per modulus, the reference's
    half_poly_mul_device (poly_arithmetic.cuh:296-310) and decrypt's front.
    x (..., r, n) coefficient domain; y_ntt (r, n) NTT domain, shared by
    every leading index of x."""
    if x.device.type == "cpu":
        return half_polymul_plain(x, y_ntt, tables)
    dev = cuda.kernel_device("half_polymul", x, tables, cuda.TRANSFORM_MAX_N)
    r, n = tables.r, tables.n
    if x.dim() < 2 or tuple(x.shape[-2:]) != (r, n):
        raise ValueError(f"half_polymul: x shape {tuple(x.shape)}, expected "
                         f"(..., {r}, {n})")
    cuda.require("x", x, I64, tuple(x.shape), dev)
    cuda.require("y_ntt", y_ntt, I64, (r, n), dev)
    out = torch.empty_like(x)
    blocks = x.numel() // n
    cuda.launch("ntt_half_polymul", dev, x.data_ptr(), y_ntt.data_ptr(),
                out.data_ptr(), *tables.kernel_args(), blocks, r,
                tables.logn)
    half_polymul.launches += 1
    return out


half_polymul.launches = 0


# --- keygen_fused ----------------------------------------------------------

def keygen_fused_plain(s_b, a, e_d, tables: NTTTables):
    """sk = NTT(s); pk0 = NTT(-(INTT(a (.) sk) + e)) (bfv_keygen.cuh:120-145)."""
    ms = tables.ms
    sk = ntt.ntt_forward(sampling.small_res(s_b, ms.q), tables)
    x = ntt.ntt_inverse(ntt.dyadic_mul(a, sk, ms), tables)
    x = poly.poly_add_negate(x, sampling.small_res(e_d, ms.q), ms)
    return sk, ntt.ntt_forward(x, tables)


def keygen_fused(s_b, a, e_d, tables: NTTTables):
    """Compact (n,) int32 ternary s_b, (r, n) NTT-domain uniform a, compact
    (n,) int32 Gaussian e_d -> (sk, pk0), both (r, n) NTT domain."""
    if a.device.type == "cpu":
        return keygen_fused_plain(s_b, a, e_d, tables)
    dev = cuda.kernel_device("keygen_fused", a, tables, cuda.TRANSFORM_MAX_N)
    r, n = tables.r, tables.n
    cuda.require("s_b", s_b, torch.int32, (n,), dev)
    cuda.require("a", a, I64, (r, n), dev)
    cuda.require("e_d", e_d, torch.int32, (n,), dev)
    sk = torch.empty((r, n), dtype=I64, device=dev)
    pk0 = torch.empty((r, n), dtype=I64, device=dev)
    cuda.launch("ntt_keygen_fused", dev, s_b.data_ptr(), a.data_ptr(),
                e_d.data_ptr(), sk.data_ptr(), pk0.data_ptr(),
                *tables.kernel_args(), r, tables.logn)
    keygen_fused.launches += 1
    return sk, pk0


keygen_fused.launches = 0


# --- encrypt_fused ---------------------------------------------------------

def encrypt_fused_plain(u_b, pk, e_d, m_poly, tables: NTTTables,
                        consts: TailConsts):
    """Per message: u_ntt = NTT(u), then bfv_tail.encrypt_fused_plain.
    (J, n), (2, r, n), (J, 2, n), (J, n) -> (J, 2, r-1, n); the J axis may
    be left out."""
    u_ntt = ntt.ntt_forward(sampling.small_res(u_b, tables.ms.q), tables)
    return bfv_tail.encrypt_fused_plain(u_ntt, pk, e_d, m_poly, tables,
                                        consts)


def encrypt_transform_plain(u_b, pk, e_d, tables: NTTTables) -> torch.Tensor:
    """What encrypt_fused's transform leaves in its scratch, before the
    tail: c_h = INTT(NTT(u) (.) pk_h) +> e_h over all r moduli.  (J, n),
    (2, r, n), (J, 2, n) -> (J, 2, r, n).  The tail's modulus drop rounds
    a small e away almost everywhere, so the ciphertext alone hardly shows
    which e row was added: a check of the transform compares this."""
    ms = tables.ms
    u_ntt = ntt.ntt_forward(sampling.small_res(u_b, ms.q), tables)
    c = ntt.ntt_inverse(ntt.dyadic_mul(u_ntt[..., None, :, :], pk, ms), tables)
    return poly.poly_add(c, sampling.small_res(e_d, ms.q), ms)


def encrypt_fused(u_b, pk, e_d, m_poly, tables: NTTTables,
                  consts: TailConsts, *, cluster: int = 0):
    """The whole encryption after the draws, J-batched.  u_b (J, n) compact
    ternary, pk (2, r, n) NTT domain, e_d (J, 2, n) compact Gaussian,
    m_poly (J, n) int64 messages -> (J, 2, r-1, n) ciphertexts; the J axis
    may be left out for one message.  On the card: the transform, one
    cluster of `cluster` blocks per polynomial of u (0, which every
    caller in the package passes: the launchers' rule; other B exist for
    the per-B tests and timings, and a B whose two n/B buffers do not fit
    a block raises), into a
    (J, 2, r, n) scratch (J 2 r n 8 bytes: 75 MB at 32k_9q, J = 16), then
    the elementwise tail."""
    if pk.device.type == "cpu":
        return encrypt_fused_plain(u_b, pk, e_d, m_poly, tables, consts)
    dev = cuda.kernel_device("encrypt_fused", pk, tables,
                             cuda.TRANSFORM_MAX_N)
    single = u_b.dim() == 1
    if single:
        u_b, e_d, m_poly = u_b[None], e_d[None], m_poly[None]
    J = u_b.shape[0]
    r, n = tables.r, tables.n
    cuda.require("u_b", u_b, torch.int32, (J, n), dev)
    cuda.require("pk", pk, I64, (2, r, n), dev)
    cuda.require("e_d", e_d, torch.int32, (J, 2, n), dev)
    cuda.require("m_poly", m_poly, I64, (J, n), dev)
    scratch = torch.empty((J, 2, r, n), dtype=I64, device=dev)
    ct = torch.empty((J, 2, r - 1, n), dtype=I64, device=dev)
    cuda.launch("ntt_encrypt_transform_cluster", dev, u_b.data_ptr(),
                pk.data_ptr(), e_d.data_ptr(), scratch.data_ptr(),
                *tables.kernel_args(), J, r, tables.logn, cluster)
    cuda.launch("ntt_encrypt_tail", dev, scratch.data_ptr(),
                m_poly.data_ptr(), ct.data_ptr(), consts.per_mod.data_ptr(),
                consts.q_last,
                consts.half, consts.fix_th, J, r, n)
    encrypt_fused.launches += 1
    return ct[0] if single else ct


encrypt_fused.launches = 0


# --- encrypt_front: c_h = INTT(NTT(u) (.) pk_h), no tail -------------------

def encrypt_front_plain(u_b, pk, tables: NTTTables) -> torch.Tensor:
    """NTT(u) once, then INTT(NTT(u) (.) pk_h) for both halves: (n,),
    (2, r, n) -> (2, r, n)."""
    u_ntt = ntt.ntt_forward(sampling.small_res(u_b, tables.ms.q), tables)
    return ntt.ntt_inverse(ntt.dyadic_mul(u_ntt[None], pk, tables.ms), tables)


def encrypt_front(u_b, pk, tables: NTTTables, *,
                  cluster: int = 0) -> torch.Tensor:
    """Kernel 18, encryption's transform front (the JAX package's
    encrypt_front, used by the RNS-sharded program, whose tail needs an
    all-reduce first): compact (n,) int32 ternary u_b and (2, r, n)
    NTT-domain pk over the tables' moduli -> (2, r, n) c with c[h] =
    INTT(NTT(u) (.) pk[h]).  On the card: K5's transform with no e, one
    launch at every n <= 32768; cluster as encrypt_fused's."""
    r, n = tables.r, tables.n
    for name, t, shape in (("u_b", u_b, (n,)), ("pk", pk, (2, r, n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
    if pk.device.type == "cpu":
        return encrypt_front_plain(u_b, pk, tables)
    dev = cuda.kernel_device("encrypt_front", pk, tables,
                             cuda.TRANSFORM_MAX_N)
    cuda.require("u_b", u_b, torch.int32, (n,), dev)
    cuda.require("pk", pk, I64, (2, r, n), dev)
    c = torch.empty((2, r, n), dtype=I64, device=dev)
    cuda.launch("ntt_encrypt_front_cluster", dev, u_b.data_ptr(),
                pk.data_ptr(), c.data_ptr(), *tables.kernel_args(), r,
                tables.logn, cluster)
    encrypt_front.launches += 1
    return c


encrypt_front.launches = 0


# --- keyswitch_front (kernel 20) and keyswitch_fused (19): c2's digits
# through a switching key, then (19) / q_last ------------------------------

def keyswitch_front_plain(c2, ksk, tables: NTTTables) -> torch.Tensor:
    """The JAX package's unfused key-switch front (parallel/spmd_mult.py:
    316-327): digits d_j = [c2_j] lifted to the tables' moduli, NTT,
    sum_j d^_j (.) ksk[h, j], INTT.  c2 (..., k, n), ksk (2, k, rl, n) ->
    (..., 2, rl, n) canonical accumulators, with no modulus drop."""
    ms = tables.ms
    d = modmath.mod_u64(c2[..., :, None, :], ms.q, ms.nu)
    dhat = ntt.ntt_forward(d, tables)                    # (..., k, rl, n)
    acc0 = acc1 = None
    for j in range(c2.shape[-2]):
        dj = dhat[..., j, :, :]
        t0 = ntt.dyadic_mul(dj, ksk[0, j], ms)
        t1 = ntt.dyadic_mul(dj, ksk[1, j], ms)
        acc0 = t0 if acc0 is None else modmath.add_mod(acc0, t0, ms.q)
        acc1 = t1 if acc1 is None else modmath.add_mod(acc1, t1, ms.q)
    return ntt.ntt_inverse(torch.stack([acc0, acc1], dim=-3), tables)


def _front_args(c2, ksk, tables: NTTTables) -> tuple[int, int]:
    """(J, k) of a key switch of c2 (k, n) or (J, k, n) through ksk (2, k,
    tables.r, n); raises on any other shape."""
    r, n = tables.r, tables.n
    if c2.dim() not in (2, 3) or c2.shape[-1] != n:
        raise ValueError(f"c2: expected shape (k, {n}) or (J, k, {n}), got "
                         f"{tuple(c2.shape)}")
    k = c2.shape[-2]
    if tuple(ksk.shape) != (2, k, r, n):
        raise ValueError(f"ksk: expected shape {(2, k, r, n)}, got "
                         f"{tuple(ksk.shape)}")
    return (1 if c2.dim() == 2 else c2.shape[0]), k


def _front_launch(dev, c2, ksk, tables: NTTTables, J: int,
                  k: int) -> torch.Tensor:
    """The key-switch front on the card, two launches of csrc/ntt_stage.cu
    over the tables' r moduli: the PRO_DIGIT forward into d^ (J, k, r, n)
    (polynomial (J k + j) r + mi reads digit row J k + j, reduced with the
    tables' nu = floor(2^64 / q)), then the PRO_KSACC inverse into
    (J, 2, r, n)."""
    r, n = tables.r, tables.n
    cuda.require("c2", c2, I64, tuple(c2.shape), dev)
    cuda.require("ksk", ksk, I64, (2, k, r, n), dev)
    dhat = torch.empty((J, k, r, n), dtype=I64, device=dev)
    acc = torch.empty((J, 2, r, n), dtype=I64, device=dev)
    ntt_stage.forward_launch(dev, c2, None, dhat, tables, cuda.PRO_DIGIT,
                             nu=tables.ms.nu)
    cuda.launch("ntt_stage_inverse", dev, dhat.data_ptr(), ksk.data_ptr(),
                None, acc.data_ptr(), *tables.kernel_args(), cuda.PRO_KSACC,
                k, J * 2 * r, r, tables.logn, None, 0, 0)
    return acc


def keyswitch_front(c2, ksk, tables: NTTTables) -> torch.Tensor:
    """Kernel 20, the key-switch front over a band of moduli (the JAX
    package's keyswitch_front_fused, run by one rank of the sharded key
    switch): c2 (k, n) or (J, k, n) digit sources, ksk (2, k, rl, n) key
    rows over the tables' rl moduli -> (2, rl, n) or (J, 2, rl, n)
    accumulators, with no modulus drop.  On the card kernel 19's first two
    launches with r := rl."""
    J, k = _front_args(c2, ksk, tables)
    if c2.device.type == "cpu":
        return keyswitch_front_plain(c2, ksk, tables)
    dev = cuda.kernel_device("keyswitch_front", c2, tables,
                             cuda.TRANSFORM_MAX_N)
    acc = _front_launch(dev, c2, ksk, tables, J, k)
    keyswitch_front.launches += 1
    return acc[0] if c2.dim() == 2 else acc


keyswitch_front.launches = 0


def keyswitch_fused_plain(c2, ksk, tables: NTTTables,
                          consts: TailConsts) -> torch.Tensor:
    """The JAX package's xla key switch (models/bfv.py:1185-1197): the
    front over all r moduli, then divide_and_round_q_last.  c2 (..., k, n),
    ksk (2, k, r, n) -> (..., 2, k, n)."""
    return poly.divide_and_round_q_last(keyswitch_front_plain(c2, ksk, tables),
                                        consts.dr, consts.ms_drop,
                                        consts.ms_last)


def keyswitch_fused(c2, ksk, tables: NTTTables,
                    consts: TailConsts) -> torch.Tensor:
    """Key switch of c2 (k, n) or (J, k, n) through ksk (2, k, r, n), NTT
    domain over all r moduli -> (2, k, n) or (J, 2, k, n), k = r-1.  On the
    card: the front's two launches (_front_launch) and the encrypt tail
    without a message."""
    r, n = tables.r, tables.n
    k = r - 1
    if c2.dim() not in (2, 3) or tuple(c2.shape[-2:]) != (k, n):
        raise ValueError(f"c2: expected shape ({k}, {n}) or (J, {k}, {n}), "
                         f"got {tuple(c2.shape)}")
    J, _ = _front_args(c2, ksk, tables)
    if c2.device.type == "cpu":
        return keyswitch_fused_plain(c2, ksk, tables, consts)
    dev = cuda.kernel_device("keyswitch_fused", c2, tables,
                             cuda.TRANSFORM_MAX_N)
    acc = _front_launch(dev, c2, ksk, tables, J, k)
    out = torch.empty((J, 2, k, n), dtype=I64, device=dev)
    cuda.launch("ntt_encrypt_tail", dev, acc.data_ptr(), None,
                out.data_ptr(), consts.per_mod.data_ptr(), consts.q_last,
                consts.half, consts.fix_th, J, r, n)
    keyswitch_fused.launches += 1
    return out[0] if c2.dim() == 2 else out


keyswitch_fused.launches = 0
