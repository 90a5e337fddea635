"""Polynomial / RNS arithmetic (the reference's poly_arithmetic.cuh).

Counterpart of `ntt_cuda_tpu/ops/poly.py` for the ops on the main path:
elementwise ops over (..., r, n) residue tensors plus BFV's two
cross-residue steps, the last-modulus divide-and-round and the BEHZ fast
base conversion to {t, gamma} with the decryption rounding.  These are the
bodies of the plain versions of the decrypt and encrypt kernels
(ops/bfv_tail.py, ops/fused_ops.py) and of the ciphertext ops.  The
reference's strict-`>` add is reproduced, not fixed; its poly_sub, which
never subtracts, is not: `poly_sub` is the corrected subtraction, as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..utils import hostmath as hm
from . import modmath
from .modmath import I64, ModulusSet, const


def poly_add(a, b, ms: ModulusSet):
    """c = a + b mod q with the reference's `>` quirk (poly_add_xq,
    bfv_encryption.cuh:180-191)."""
    return modmath.add_mod_lazy_gt(a, b, ms.q)


def poly_negate(a, ms: ModulusSet):
    """c = -a mod q, canonical 0 -> 0 (poly_negate,
    poly_arithmetic.cuh:332-343)."""
    return modmath.negate_mod(a, ms.q)


def poly_add_scalar(a, c, ms: ModulusSet):
    """a + c mod q for a scalar (or (r, 1) per-modulus) addend in [0, q)
    (poly_add_integer, poly_arithmetic.cuh:155-165)."""
    c = c if torch.is_tensor(c) else modmath.as_i64(int(c))
    s = a + c
    return s - ms.q * (s >= ms.q).to(I64)


def poly_sub(a, b, ms: ModulusSet):
    """c = a - b mod q.  The reference's poly_sub kernel never subtracts b
    (poly_arithmetic.cuh:167-178; unused by its pipeline): this is the
    corrected subtraction of the JAX package, not the bug."""
    d = a - b
    return torch.where(a >= b, d, d + ms.q)


def poly_add_negate(a, b, ms: ModulusSet):
    """c = -(a + b) mod q (poly_add_negate_xq, bfv_keygen.cuh:81-93)."""
    return modmath.add_negate_mod(a, b, ms.q)


def poly_mul_scalar_mont(a, c_mont, ms: ModulusSet):
    """a * c mod q with a Montgomery-scaled per-modulus scalar c (r, 1)
    (poly_mul_int_xq_*, bfv_decryption.cuh:25-57)."""
    return modmath.mont_mul(a, c_mont, ms.q, ms.qinv_neg)


def poly_mul_scalar_mod_t(a, c: int, t: int):
    """(a * c) & (t-1), the low 64 bits of the product, t a power of two
    (the mod_t kernel, poly_arithmetic.cuh:128-141)."""
    return (a * modmath.as_i64(int(c))) & (t - 1)


@dataclasses.dataclass(frozen=True)
class DivideRoundConsts:
    half: int                     # floor(q_last / 2)
    half_mod: torch.Tensor        # (r-1, 1) half mod q_i
    inv_q_last_mont: torch.Tensor  # (r-1, 1) (q_last mod q_i)^-1 * R mod q_i

    @staticmethod
    def build(params, device=None) -> "DivideRoundConsts":
        inv_m = [hm.to_mont(x, qi)
                 for x, qi in zip(params.inv_q_last_mod_q, params.q[:-1])]
        return DivideRoundConsts(
            half=params.half_last_modulus,
            half_mod=const(params.half_mod_q, device),
            inv_q_last_mont=const(inv_m, device))


def divide_and_round_q_last(c, dr: DivideRoundConsts, ms: ModulusSet,
                            ms_last: ModulusSet):
    """Drop the last RNS modulus of a (..., r, n) tensor -> (..., r-1, n)
    (divide_and_round_q_last_inplace_add_x2 + _loop_xq,
    bfv_encryption.cuh:111-178):
      last += half (mod q_last);
      for i < r-1: tmp = (last mod q_i) -_safe half_mod_i;
                   c_i = (c_i -_safe tmp) * inv_q_last_mod_q_i  mod q_i.
    `ms` covers the first r-1 moduli; `ms_last` the dropped one."""
    last = c[..., -1:, :]
    qlast = ms_last.q
    ra = last + dr.half
    ra = ra - qlast * (ra >= qlast).to(I64)
    rest = c[..., :-1, :]
    tmp = modmath.mod_u64(ra, ms.q, ms.nu)
    tmp = tmp + ms.q * (tmp < dr.half_mod).to(I64) - dr.half_mod
    v = rest + ms.q * (rest < tmp).to(I64) - tmp
    return modmath.mont_mul(v, dr.inv_q_last_mont, ms.q, ms.qinv_neg)


@dataclasses.dataclass(frozen=True)
class MessageConsts:
    qi_div_t: torch.Tensor  # (r-1, 1)
    nu: torch.Tensor        # (r-1, 1) floor(2^64 / q_i)
    q: torch.Tensor         # (r-1, 1)
    t: int

    @staticmethod
    def build(params, device=None) -> "MessageConsts":
        qs = params.q[:-1]
        return MessageConsts(
            qi_div_t=const(params.qi_div_t[: params.r - 1], device),
            nu=const([(1 << 64) // qi for qi in qs], device),
            q=const(qs, device), t=params.t)


def add_message(c0, m_poly, mc: MessageConsts):
    """c0_i += Delta_i * m + fix, mod q_i (weird_m_stuff,
    bfv_encryption.cuh:193-213).  c0: (..., r-1, n); m_poly: (..., n) in
    [0, t)."""
    t = mc.t
    m = m_poly.to(I64)[..., None, :]
    fix = torch.div(m + ((t + 1) >> 1), t, rounding_mode="floor")
    v = c0 + m * mc.qi_div_t + fix
    return modmath.mod_u64(v, mc.q, mc.nu)


def sub_message(c0, m_poly, mc: MessageConsts):
    """c0_i -= Delta_i * m + fix, mod q_i: the exact inverse of add_message
    (SEAL's sub_plain; no reference counterpart)."""
    t = mc.t
    m = m_poly.to(I64)[..., None, :]
    fix = torch.div(m + ((t + 1) >> 1), t, rounding_mode="floor")
    d = modmath.mod_u64(m * mc.qi_div_t + fix, mc.q, mc.nu)
    return modmath.sub_mod(c0, d, mc.q)


@dataclasses.dataclass(frozen=True)
class DecryptConsts:
    """Constants of the decryption back half (demo.cu:98-123).  The odd-t
    fields hold 0 when t is a power of two (the masked path is used)."""

    prod_t_gamma_mont: torch.Tensor   # (r-1, 1) t*gamma mod q_i, Mont
    inv_punctured_mont: torch.Tensor  # (r-1, 1) punctured^-1 mod q_i, Mont
    bcm_t: torch.Tensor               # (r-1, 1) prod_{k!=j} q_k mod t
    bcm_g_mont: torch.Tensor          # (r-1, 1) same mod gamma, Mont(gamma)
    bcm_t_mont: torch.Tensor          # (r-1, 1) bcm_t * R mod t (odd t)
    gamma: int
    gamma_qinv_neg: int               # int64 bit pattern of -gamma^-1 mod 2^64
    gamma_div_2: int
    neg_g_mont: int                   # neg_inv_q mod gamma, Mont(gamma)
    t_qinv_neg: int                   # int64 bit pattern of -t^-1 (odd t)
    neg_t_mont: int                   # neg_t * R mod t (odd t)
    nu_t: int                         # floor(2^64 / t) (int64 bit pattern)
    inv_gamma_t_mont: int             # (gamma mod t)^-1 * R mod t (odd t)
    t: int
    neg_t: int                        # neg_inv_q mod t

    @staticmethod
    def build(params, device=None) -> "DecryptConsts":
        qs = params.q[:-1]
        g, t = params.gamma, params.t
        bcm_t, bcm_g = params.base_change_matrix
        neg_t, neg_g = params.neg_inv_q_mod_t_gamma
        odd = t % 2 == 1
        return DecryptConsts(
            prod_t_gamma_mont=const([hm.to_mont(x, qi) for x, qi in
                                     zip(params.prod_t_gamma_mod_q, qs)], device),
            inv_punctured_mont=const([hm.to_mont(x, qi) for x, qi in
                                      zip(params.inv_punctured_q, qs)], device),
            bcm_t=const(bcm_t, device),
            bcm_g_mont=const([hm.to_mont(x, g) for x in bcm_g], device),
            bcm_t_mont=const([hm.to_mont(x, t) for x in bcm_t] if odd
                             else [0] * len(qs), device),
            gamma=g,
            gamma_qinv_neg=modmath.as_i64(hm.mont_qinv_neg(g)),
            gamma_div_2=params.gamma_div_2,
            neg_g_mont=hm.to_mont(neg_g, g),
            t_qinv_neg=modmath.as_i64(hm.mont_qinv_neg(t)) if odd else 0,
            neg_t_mont=hm.to_mont(neg_t, t) if odd else 0,
            nu_t=modmath.as_i64((1 << 64) // t),
            inv_gamma_t_mont=(hm.to_mont(pow(g % t, -1, t), t) if odd else 0),
            t=t, neg_t=neg_t)


def _scalar(v: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=I64, device=like.device)


def fast_convert_and_round(c1, dc: DecryptConsts):
    """(..., r-1, n) residues (already * prod_t_gamma * inv_punctured) ->
    (..., n) plaintext in [0, t) (fast_convert_array_kernel_t / _gamma and
    dec_round, poly_arithmetic.cuh:217-263):
      x_t = (sum_i (c1_i * bcm_t_i mod 2^64) & (t-1)) & (t-1)
      x_g = sum_i (c1_i * bcm_g_i mod gamma)  mod gamma."""
    pow2_t = dc.t & (dc.t - 1) == 0
    gamma = _scalar(dc.gamma, c1)
    ginv = _scalar(dc.gamma_qinv_neg, c1)
    if pow2_t:
        mask = dc.t - 1
        x_t = ((c1 * dc.bcm_t) & mask).sum(dim=-2) & mask
        x_t = (x_t * dc.neg_t) & mask
    else:
        # odd t (batching prime): exact Montgomery mod-t arithmetic in
        # place of the reference's power-of-two masks
        tt, tqi = _scalar(dc.t, c1), _scalar(dc.t_qinv_neg, c1)
        part_t = modmath.mont_mul(c1, dc.bcm_t_mont, tt, tqi)
        x_t = part_t[..., 0, :]
        for i in range(1, part_t.shape[-2]):
            x_t = modmath.add_mod(x_t, part_t[..., i, :], tt)
        x_t = modmath.mont_mul(x_t, _scalar(dc.neg_t_mont, c1), tt, tqi)

    part_g = modmath.mont_mul(c1, dc.bcm_g_mont, gamma, ginv)
    x_g = part_g[..., 0, :]
    for i in range(1, part_g.shape[-2]):
        x_g = modmath.add_mod(x_g, part_g[..., i, :], gamma)
    x_g = modmath.mont_mul(x_g, _scalar(dc.neg_g_mont, c1), gamma, ginv)

    # dec_round_kernel: `> gamma/2` (strict) branch
    over = x_g > dc.gamma_div_2
    if pow2_t:
        return torch.where(over, x_t + (gamma - x_g), x_t - x_g) & mask
    nu_t = _scalar(dc.nu_t, c1)
    plus = modmath.add_mod(x_t, modmath.mod_u64(gamma - x_g, tt, nu_t), tt)
    minus = modmath.sub_mod(x_t, modmath.mod_u64(x_g, tt, nu_t), tt)
    corr = torch.where(over, plus, minus)
    # the rounded value is gamma*m mod t: undo gamma (trivial for the
    # reference's gamma === 1 mod t; required for batching primes)
    return modmath.mont_mul(corr, _scalar(dc.inv_gamma_t_mont, c1), tt, tqi)


# --- Galois automorphisms a(x) -> a(x^g) mod x^n + 1 (SEAL's apply_galois;
# beyond the reference, which stops at encrypt/decrypt) ---------------------

@functools.lru_cache(maxsize=1024)
def galois_maps(n: int, g: int) -> tuple[np.ndarray, np.ndarray]:
    """(perm int32 (n,), neg bool (n,)) for tau_g: out[j] = +-a[perm[j]].

    Output index j has the unique source i0 = j g^-1 mod 2n; its
    coefficient is a[i0 mod n], negated when i0 >= n (the negacyclic
    wrap).  g must be odd with 0 < g < 2n.  Host numpy, cached."""
    if not (0 < g < 2 * n) or g % 2 == 0:
        raise ValueError(f"galois element must be odd in (0, {2 * n}), "
                         f"got {g}")
    ginv = pow(g, -1, 2 * n)
    i0 = (np.arange(n, dtype=np.int64) * ginv) % (2 * n)
    return (i0 % n).astype(np.int32), i0 >= n


def galois_apply(x, perm, neg, ms: ModulusSet):
    """tau_g of (..., r, n) residues: one gather on the coefficient axis
    (perm, an int64 tensor on x's device) and a modular negate where `neg`
    (a bool tensor) holds, 0 staying 0."""
    y = x[..., perm]
    return torch.where(neg, modmath.negate_mod(y, ms.q), y)
