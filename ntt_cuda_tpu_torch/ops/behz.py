"""BEHZ RNS machinery for homomorphic multiplication (EvalMult): the
auxiliary base, its constants, and the plain base conversions.

Counterpart of `ntt_cuda_tpu/ops/behz.py` (Bajard-Eynard-Hasan-Zucca 2016,
the RNS evaluator of SEAL 3.5), generalizing the reference's decrypt-side
fast base conversion (fast_convert_array_kernels,
poly_arithmetic.cuh:217-251):

  1. `rns_to_bsk`: extend from base q to Bsk = B u {m_sk} with the
     m_tilde = 2^32 Montgomery trick (sm_mrq removes the q-overflow);
  2. the tensor product in NTT form over q and Bsk (models/bfv.py);
  3. `fast_floor`: floor(t * x / q) in Bsk;
  4. `bsk_to_q`: Shenoy-Kumaresan exact conversion back to q.

The functions here are the plain versions of the conversion kernels
(ops/behz_kernels.py, csrc/behz.cu): int64 tensor code on ops/modmath.py
with the JAX package's Montgomery-scaled constants, so every value equals
the JAX package's.  Base-q tensors are (..., k, n) with k = r-1; Bsk
tensors (..., k+1, n).  Leading batch dims broadcast.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import hostmath as hm
from ..utils import primegen
from . import modmath
from .modmath import I64, ModulusSet, const

M32 = (1 << 32) - 1
M_TILDE = 1 << 32   # power of two: mod-m_tilde arithmetic is a mask
AUX_BITS = 60       # < 2^61: inside every kernel's headroom


def prod(vals) -> int:
    out = 1
    for v in vals:
        out *= int(v)
    return out


@dataclasses.dataclass(frozen=True)
class AuxBase:
    """The auxiliary RNS base of one BFV set: k 60-bit primes B plus m_sk,
    all NTT-friendly for n and distinct from q and gamma, scanned downward
    from 2^AUX_BITS."""

    b: tuple[int, ...]
    b_psi: tuple[int, ...]
    m_sk: int
    m_sk_psi: int
    m_tilde: int = M_TILDE

    @property
    def bsk(self) -> tuple[int, ...]:
        return self.b + (self.m_sk,)

    @property
    def bsk_psi(self) -> tuple[int, ...]:
        return self.b_psi + (self.m_sk_psi,)

    @staticmethod
    def build(params) -> "AuxBase":
        k = params.r - 1
        primes = primegen.generate_moduli(
            params.n, AUX_BITS, k + 1,
            exclude=set(params.q) | {params.gamma})
        psis = [primegen.find_primitive_2n_root(p, params.n) for p in primes]
        aux = AuxBase(b=tuple(primes[:k]), b_psi=tuple(psis[:k]),
                      m_sk=primes[k], m_sk_psi=psis[k])
        aux.validate(params)
        return aux

    def validate(self, params) -> None:
        """The pipeline's correctness bounds (ops/behz.py of the JAX
        package): the Shenoy-Kumaresan range, the combined base against
        the tensor product, and m_tilde against the conversion overflow."""
        k = params.r - 1
        q_prod, b_prod = prod(params.q[:-1]), prod(self.b)
        n, t = params.n, params.t
        if b_prod <= 2 * (4 * n * t * q_prod + k + 1):
            raise ValueError("aux base too small for Shenoy-Kumaresan bound")
        if q_prod * b_prod * self.m_sk <= 8 * n * t * q_prod * q_prod:
            raise ValueError("combined base too small for tensor product")
        if self.m_tilde < 4 * (k + 1):
            raise ValueError("m_tilde too small for sm_mrq")


def _row(vals, device) -> torch.Tensor:
    return torch.tensor([modmath.as_i64(int(v)) for v in vals], dtype=I64,
                        device=device)


def _scalar(v: int, device) -> torch.Tensor:
    return torch.tensor(modmath.as_i64(int(v)), dtype=I64, device=device)


@dataclasses.dataclass(frozen=True)
class MultConsts:
    """Montgomery-scaled constants of the BEHZ pipeline over one (params,
    aux base) pair, field for field the JAX package's MultConsts (same
    names, shapes and values; int64 bit patterns on one device)."""

    ms_q: ModulusSet
    ms_bsk: ModulusSet
    ms_b: ModulusSet
    # q -> Bsk u {m_tilde}
    mt_mont_q: torch.Tensor          # (k, 1) m_tilde * R mod q_j
    inv_punct_q_mont: torch.Tensor   # (k, 1) (q/q_j)^-1 * R mod q_j
    bcm_q_bsk_mont: torch.Tensor     # (k+1, k) (q/q_j mod m) * R mod m
    bcm_q_mt: torch.Tensor           # (k,) (q/q_j) mod m_tilde
    neg_inv_q_mt: torch.Tensor       # () -(prod q)^-1 mod m_tilde
    prodq_mont_bsk: torch.Tensor     # (k+1, 1) prod(q) * R mod m
    inv_mt_mont_bsk: torch.Tensor    # (k+1, 1) m_tilde^-1 * R mod m
    # fast_floor
    t_mont_q: torch.Tensor           # (k, 1)
    t_mont_bsk: torch.Tensor         # (k+1, 1)
    inv_prodq_mont_bsk: torch.Tensor  # (k+1, 1)
    # Shenoy-Kumaresan B -> q
    inv_punct_b_mont: torch.Tensor   # (k, 1) (B/b_j)^-1 * R mod b_j
    bcm_b_q_mont: torch.Tensor       # (k, k) (B/b_j mod q_i) * R mod q_i
    bcm_b_msk_mont: torch.Tensor     # (k, 1) (B/b_j mod m_sk) * R mod m_sk
    inv_prodb_mont_msk: torch.Tensor  # () prod(B)^-1 * R mod m_sk
    prodb_mont_q: torch.Tensor       # (k, 1) prod(B) * R mod q_i
    msk: torch.Tensor                # () m_sk
    msk_qinv_neg: torch.Tensor       # () -m_sk^-1 mod 2^64
    msk_half: torch.Tensor           # () m_sk >> 1
    k: int

    @staticmethod
    def build(params, aux: AuxBase | None = None,
              device=None) -> "MultConsts":
        aux = aux or AuxBase.build(params)
        k = params.r - 1
        qs, bsk, msk, mt = params.q[:-1], aux.bsk, aux.m_sk, aux.m_tilde
        q_prod, b_prod = prod(qs), prod(aux.b)
        punct_q = [q_prod // qj for qj in qs]
        punct_b = [b_prod // bj for bj in aux.b]
        mont = hm.to_mont

        def mat(rows):
            return torch.tensor([[modmath.as_i64(v) for v in row]
                                 for row in rows], dtype=I64, device=device)

        return MultConsts(
            ms_q=ModulusSet.from_moduli(qs, device),
            ms_bsk=ModulusSet.from_moduli(bsk, device),
            ms_b=ModulusSet.from_moduli(aux.b, device),
            mt_mont_q=const([mont(mt % qj, qj) for qj in qs], device),
            inv_punct_q_mont=const([mont(hm.modinv(pj % qj, qj), qj)
                                    for pj, qj in zip(punct_q, qs)], device),
            bcm_q_bsk_mont=mat([[mont(pj % m, m) for pj in punct_q]
                                for m in bsk]),
            bcm_q_mt=_row([pj % mt for pj in punct_q], device),
            neg_inv_q_mt=_scalar((-pow(q_prod, -1, mt)) % mt, device),
            prodq_mont_bsk=const([mont(q_prod % m, m) for m in bsk], device),
            inv_mt_mont_bsk=const([mont(hm.modinv(mt % m, m), m)
                                   for m in bsk], device),
            t_mont_q=const([mont(params.t % qj, qj) for qj in qs], device),
            t_mont_bsk=const([mont(params.t % m, m) for m in bsk], device),
            inv_prodq_mont_bsk=const([mont(hm.modinv(q_prod % m, m), m)
                                      for m in bsk], device),
            inv_punct_b_mont=const([mont(hm.modinv(pj % bj, bj), bj)
                                    for pj, bj in zip(punct_b, aux.b)],
                                   device),
            bcm_b_q_mont=mat([[mont(pj % qi, qi) for pj in punct_b]
                              for qi in qs]),
            bcm_b_msk_mont=const([mont(pj % msk, msk) for pj in punct_b],
                                 device),
            inv_prodb_mont_msk=_scalar(
                mont(hm.modinv(b_prod % msk, msk), msk), device),
            prodb_mont_q=const([mont(b_prod % qi, qi) for qi in qs], device),
            msk=_scalar(msk, device),
            msk_qinv_neg=_scalar(hm.mont_qinv_neg(msk), device),
            msk_half=_scalar(msk >> 1, device),
            k=k,
        )


def _conv(xp, bcm_mont, ms_t: ModulusSet):
    """Fast base conversion inner product: xp (..., k, n), already scaled
    by the source base's punctured inverses -> (..., kt, n) with
    out[m] = sum_j xp_j * (src/src_j mod m) mod m."""
    out = None
    for j in range(xp.shape[-2]):
        term = modmath.mont_mul(xp[..., j:j + 1, :], bcm_mont[:, j:j + 1],
                                ms_t.q, ms_t.qinv_neg)
        out = term if out is None else modmath.add_mod(out, term, ms_t.q)
    return out


def rns_to_bsk(x, mc: MultConsts):
    """Extend x (..., k, n) from base q to Bsk (..., k+1, n): times m_tilde,
    fast conversion to Bsk u {m_tilde}, then sm_mrq.  The m_tilde channel
    wraps mod 2^64 and keeps its low 32 bits."""
    qq, qinv = mc.ms_q.q, mc.ms_q.qinv_neg
    z = modmath.mont_mul(x, mc.mt_mont_q, qq, qinv)
    zp = modmath.mont_mul(z, mc.inv_punct_q_mont, qq, qinv)
    y = _conv(zp, mc.bcm_q_bsk_mont, mc.ms_bsk)
    ymt = torch.zeros(zp.shape[:-2] + zp.shape[-1:], dtype=I64,
                      device=zp.device)
    for j in range(mc.k):
        ymt = ymt + zp[..., j, :] * mc.bcm_q_mt[j]
    ymt = ymt & M32
    # sm_mrq: r = -Y/q mod m_tilde, centered; out = (Y + r*q) / m_tilde
    rb = ((ymt * mc.neg_inv_q_mt) & M32)[..., None, :]
    temp = torch.where(rb >= M_TILDE // 2, rb + (mc.ms_bsk.q - M_TILDE), rb)
    corr = modmath.mont_mul(temp, mc.prodq_mont_bsk, mc.ms_bsk.q,
                            mc.ms_bsk.qinv_neg)
    s = modmath.add_mod(y, corr, mc.ms_bsk.q)
    return modmath.mont_mul(s, mc.inv_mt_mont_bsk, mc.ms_bsk.q,
                            mc.ms_bsk.qinv_neg)


def fast_floor(xq, xbsk, mc: MultConsts):
    """floor(t * x / q) in Bsk (error in [0, k]): xq (..., k, n) and xbsk
    (..., k+1, n), the same value in both bases -> (..., k+1, n)."""
    yq = modmath.mont_mul(xq, mc.t_mont_q, mc.ms_q.q, mc.ms_q.qinv_neg)
    yb = modmath.mont_mul(xbsk, mc.t_mont_bsk, mc.ms_bsk.q,
                          mc.ms_bsk.qinv_neg)
    zp = modmath.mont_mul(yq, mc.inv_punct_q_mont, mc.ms_q.q,
                          mc.ms_q.qinv_neg)
    conv = _conv(zp, mc.bcm_q_bsk_mont, mc.ms_bsk)
    diff = modmath.sub_mod(yb, conv, mc.ms_bsk.q)
    return modmath.mont_mul(diff, mc.inv_prodq_mont_bsk, mc.ms_bsk.q,
                            mc.ms_bsk.qinv_neg)


def bsk_to_q(x, mc: MultConsts):
    """Shenoy-Kumaresan (..., k+1, n) in Bsk -> (..., k, n) in q, for
    centered magnitudes below prod(B)/2; the m_sk channel recovers the
    overflow and its sign (strict `>` on alpha)."""
    k = mc.k
    xb, xm = x[..., :k, :], x[..., k, :]
    xp = modmath.mont_mul(xb, mc.inv_punct_b_mont, mc.ms_b.q,
                          mc.ms_b.qinv_neg)
    cq = _conv(xp, mc.bcm_b_q_mont, mc.ms_q)
    cm = None
    for j in range(k):
        term = modmath.mont_mul(xp[..., j, :], mc.bcm_b_msk_mont[j, 0],
                                mc.msk, mc.msk_qinv_neg)
        cm = term if cm is None else modmath.add_mod(cm, term, mc.msk)
    alpha = modmath.mont_mul(modmath.sub_mod(cm, xm, mc.msk),
                             mc.inv_prodb_mont_msk, mc.msk, mc.msk_qinv_neg)
    neg = alpha > mc.msk_half
    mag = torch.where(neg, mc.msk - alpha, alpha)[..., None, :]
    corr = modmath.mont_mul(mag, mc.prodb_mont_q, mc.ms_q.q,
                            mc.ms_q.qinv_neg)
    return torch.where(neg[..., None, :],
                       modmath.add_mod(cq, corr, mc.ms_q.q),
                       modmath.sub_mod(cq, corr, mc.ms_q.q))


def scale_and_round(xq, xbsk, mc: MultConsts):
    """fast_floor then bsk_to_q: round(t * x / q) back in base q."""
    return bsk_to_q(fast_floor(xq, xbsk, mc), mc)
