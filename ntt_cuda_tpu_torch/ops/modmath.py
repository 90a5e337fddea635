"""Modular arithmetic on u64 values carried in `torch.int64` tensors.

Counterpart of `ntt_cuda_tpu/ops/modmath.py`, with the semantics of
`ops/limb32.py` where they matter.  PyTorch's CPU `uint64` is a shell
dtype (`+`, `>>` and `<` raise), so every u64 lives in an int64 tensor as
its two's-complement bit pattern:

* residues, keys, ciphertexts and moduli are below 2^62, so they are
  plain non-negative int64 values and compare as such;
* products wrap mod 2^64 (int64 multiply keeps the low 64 bits), and
  `mulhi_u64` rebuilds the high half from 32-bit limbs;
* every right shift is arithmetic in int64, so it is masked.

These are the bodies of the plain versions of the kernels.  The CUDA
kernels do not use them: they have native u64, `__umul64hi` and Shoup
multiplies (csrc/modarith.cuh).

All functions broadcast: the coefficient axis is last, the RNS-modulus
axis second to last, and per-modulus constants are (r, 1) tensors.
"""

from __future__ import annotations

import dataclasses

import torch

from ..utils import hostmath as hm

I64 = torch.int64
MASK32 = 0xFFFFFFFF


def as_i64(v: int) -> int:
    """Python int in [0, 2^64) -> the int64 with the same bit pattern."""
    v &= hm.MASK64
    return v - (1 << 64) if v >> 63 else v


def as_u64(v: int) -> int:
    """int64 bit pattern -> the Python int in [0, 2^64) it stands for."""
    return v & hm.MASK64


def const(vals, device=None) -> torch.Tensor:
    """(r,) Python ints in [0, 2^64) -> (r, 1) int64 bit-pattern column."""
    return torch.tensor([as_i64(int(v)) for v in vals], dtype=I64,
                        device=device).reshape(-1, 1)


def mulhi_u64(a, b):
    """High 64 bits of the 128-bit product of two u64 bit patterns
    (reference: mul64, uint128.h:353-373), from 32-bit limb products."""
    a0 = a & MASK32
    a1 = (a >> 32) & MASK32
    b0 = b & MASK32
    b1 = (b >> 32) & MASK32
    p01 = a0 * b1
    p10 = a1 * b0
    mid = ((a0 * b0 >> 32) & MASK32) + (p01 & MASK32) + (p10 & MASK32)
    return (a1 * b1 + ((p01 >> 32) & MASK32) + ((p10 >> 32) & MASK32)
            + (mid >> 32))


def mont_mul(a, b_mont, q, qinv_neg):
    """Montgomery product a * b_mont * 2^-64 mod q, in [0, q).

    Valid for any u64 `a` and `b_mont < q < 2^62` (or vice versa): the
    sum before the final subtract is below 2q."""
    t_lo = a * b_mont
    t_hi = mulhi_u64(a, b_mont)
    m = t_lo * qinv_neg
    t = t_hi + mulhi_u64(m, q) + (t_lo != 0).to(I64)
    return t - q * (t >= q).to(I64)


def mulmod(a, b, q, qinv_neg, r2):
    """Exact a*b mod q for two runtime operands (b < q): lift a into
    Montgomery form with r2 = 2^128 mod q, then one REDC."""
    return mont_mul(mont_mul(a, r2, q, qinv_neg), b, q, qinv_neg)


def add_mod(a, b, q):
    """(a + b) mod q for a, b in [0, q)."""
    s = a + b
    return s - q * (s >= q).to(I64)


def add_mod_lazy_gt(a, b, q):
    """poly_add's `if (ra > q) ra -= q` quirk (poly_arithmetic.cuh:143-153):
    a sum equal to exactly q is NOT reduced."""
    s = a + b
    return s - q * (s > q).to(I64)


def sub_mod(a, b, q):
    """(a - b) mod q for a, b in [0, q)."""
    return a + q * (a < b).to(I64) - b


def negate_mod(x, q):
    """q - x with the 0 fixup (poly_negate, poly_arithmetic.cuh:332-338):
    0 stays 0."""
    r = q - x
    return r * (r != q).to(I64)


def halve_mod(x, q):
    """x * 2^-1 mod q for x in [0, q): `(x>>1) + ((q+1)>>1)*(x&1)`."""
    return (x >> 1) + ((q + 1) >> 1) * (x & 1)


def add_negate_mod(a, b, q):
    """-(a + b) mod q fused, with the 0 fixup (poly_add_negate_xq,
    bfv_keygen.cuh:81-93)."""
    s = add_mod(a, b, q)
    r = q - s
    return r * (r != q).to(I64)


def mod_u64(x, q, nu):
    """x mod q for any u64 bit pattern x, with nu = floor(2^64 / q).

    est = floor(x*nu / 2^64) satisfies x/q - 2 < est <= x/q, so the
    wrapped difference x - est*q is the true remainder plus at most one q."""
    est = mulhi_u64(x, nu)
    r = x - est * q
    return r - q * (r >= q).to(I64)


@dataclasses.dataclass(frozen=True)
class ModulusSet:
    """Per-modulus scalars as (r, 1) int64 columns on one device (the
    reference's `__constant__` banks, ntt_60bit.cuh:8-13)."""

    q: torch.Tensor         # moduli
    qinv_neg: torch.Tensor  # -q^-1 mod 2^64 (bit pattern)
    r2: torch.Tensor        # 2^128 mod q
    nu: torch.Tensor        # floor(2^64 / q)

    @property
    def r(self) -> int:
        return self.q.shape[0]

    @staticmethod
    def from_moduli(qs, device=None) -> "ModulusSet":
        qs = [int(q) for q in qs]
        return ModulusSet(
            q=const(qs, device),
            qinv_neg=const([hm.mont_qinv_neg(q) for q in qs], device),
            r2=const([hm.mont_r2(q) for q in qs], device),
            nu=const([(1 << 64) // q for q in qs], device),
        )


def modulus_set(params, count: int | None = None, device=None) -> ModulusSet:
    """ModulusSet over the first `count` moduli of a BFV parameter set."""
    qs = params.q if count is None else params.q[:count]
    return ModulusSet.from_moduli(qs, device)
