"""Host-side exact modular arithmetic in arbitrary-precision Python ints.

Counterpart of `ntt_cuda_tpu/utils/hostmath.py` (the reference's
`BFV_Scheme/helper.h:8-70` and `uint128.h:314-341`), pure Python: the JAX
package's optional g++ helper for the power tables is not carried over.
Nothing in this module touches a tensor.
"""

from __future__ import annotations

MASK64 = (1 << 64) - 1
R64 = 1 << 64


def modinv(a: int, q: int) -> int:
    """Inverse of `a` mod prime `q` via Fermat (reference: modinv128, helper.h:52-56)."""
    return pow(a, q - 2, q)


def bit_reverse(a: int, bit_length: int) -> int:
    """Reverse the low `bit_length` bits of `a` (reference: bitReverse, helper.h:58-70)."""
    res = 0
    for _ in range(bit_length):
        res = (res << 1) | (a & 1)
        a >>= 1
    return res


def mu_barrett(q: int, qbit: int) -> int:
    """Barrett constant mu = floor(2^(2*qbit) / q) (reference: demo.cu:156-165)."""
    return (1 << (2 * qbit)) // q


def q_bit_length(q: int) -> int:
    """Bit length as the reference computes it (demo.cu:67-71)."""
    return q.bit_length()


# Montgomery (R = 2^64) constants: the plain tensor path and the kernels'
# dyadic products use REDC, which returns exactly a*b mod q when one
# operand carries the factor R.

def mont_qinv_neg(q: int) -> int:
    """-q^{-1} mod 2^64 for Montgomery REDC (q odd)."""
    return (-pow(q, -1, R64)) & MASK64


def mont_r2(q: int) -> int:
    """R^2 mod q = 2^128 mod q (used to lift runtime operands)."""
    return (R64 * R64) % q


def to_mont(x: int, q: int) -> int:
    """x * R mod q."""
    return (x << 64) % q


def shoup(w: int, q: int) -> int:
    """Shoup companion floor(w * 2^64 / q) of a constant w < q: the
    kernels' x*w mod q is then one mulhi, two low multiplies and one
    conditional subtract, for any 64-bit x."""
    return (w << 64) // q


def psi_tables(psi: int, psiinv: int, q: int, n: int) -> tuple[list[int], list[int]]:
    """Bit-reversed-ordered power tables of psi and psi^-1.

    Matches the reference's ``fillTablePsi128`` (parameter.h:5-12):
    ``table[i] = psi ** bit_reverse(i, log2 n) mod q``.  This ordering is
    what lets the merged negacyclic NTT address its twiddle as
    ``psi_powers[length + psi_step]``.
    """
    logn = n.bit_length() - 1
    perm = [bit_reverse(i, logn) for i in range(n)]

    def table(base):
        powers = [1] * n
        for i in range(1, n):
            powers[i] = powers[i - 1] * base % q
        return [powers[k] for k in perm]

    return table(psi), table(psiinv)
