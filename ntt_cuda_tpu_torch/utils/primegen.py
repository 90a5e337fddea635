"""NTT-friendly prime and root generation (pure Python ints).

Counterpart of `ntt_cuda_tpu/utils/primegen.py`: primes q = k*2n + 1,
scanned downward from 2^bits, and a primitive 2n-th root psi of each (the
EvalMult setup, `ops/behz.AuxBase.build`, draws its auxiliary base here),
the batching plaintext prime t === 1 mod 2n, and generated BFV parameter
sets.  A copy, not an import: the port never imports the JAX package.
"""

from __future__ import annotations

from .. import params as params_mod

_MR_WITNESSES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)  # deterministic < 3.3e24


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24."""
    if n < 2:
        return False
    for p in _MR_WITNESSES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_WITNESSES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = (x * x) % n
            if x == n - 1:
                break
        else:
            return False
    return True


def find_primitive_2n_root(q: int, n: int) -> int:
    """psi with psi^n == -1 mod q (primitive 2n-th root of unity)."""
    order = q - 1
    if order % (2 * n):
        raise ValueError(f"q={q} is not 1 mod 2n={2 * n}")
    exp = order // (2 * n)
    g = 2
    while True:
        psi = pow(g, exp, q)
        if pow(psi, n, q) == q - 1:
            return psi
        g += 1
        if g > 1000:
            raise ValueError(f"no generator found for q={q}")


def generate_moduli(n: int, bits: int, count: int, multiple: int = 1,
                    exclude=()) -> list[int]:
    """`count` distinct primes of `bits` bits with q === 1 mod 2n*multiple,
    scanning downward from 2^bits (like SEAL's CoeffModulus), skipping the
    values in `exclude`."""
    step = 2 * n * multiple
    q = ((1 << bits) - 1) // step * step + 1
    out: list[int] = []
    exclude = set(exclude)
    while len(out) < count and q > (1 << (bits - 1)):
        if q not in exclude and is_prime(q):
            out.append(q)
        q -= step
    if len(out) < count:
        raise ValueError(f"not enough {bits}-bit NTT primes for n={n} "
                         f"(congruent 1 mod {step})")
    return out


def find_plain_modulus(n: int, bits: int) -> int:
    """Smallest `bits`-bit prime t with t === 1 mod 2n (SEAL's
    PlainModulus::Batching): the congruence that gives R_t a full set of
    CRT slots for the batching encoder (models/encoder.py)."""
    step = 2 * n
    t = (1 << (bits - 1)) // step * step + 1
    while t < (1 << bits):
        if t > (1 << (bits - 1)) and is_prime(t):
            return t
        t += step
    raise ValueError(f"no {bits}-bit batching prime for n={n}")


def make_bfv_params(n: int, bits: int, r: int, t: int = params_mod.T_DEFAULT,
                    name: str | None = None) -> params_mod.BFVParams:
    """A generated BFVParams set: r moduli of `bits` bits for ring degree
    n.  Encryption's Delta-embedding assumes q === 1 mod t
    (bfv_encryption.cuh:194): primes k*2n + 1 meet it for a power-of-two
    t <= 2n, and for an odd t (a batching prime) the moduli are generated
    with the congruence forced."""
    qs = generate_moduli(n, bits, r, multiple=t if t % 2 else 1)
    psis = [find_primitive_2n_root(q, n) for q in qs]
    return params_mod.BFVParams(name=name or f"gen_{n}_{bits}b_{r}q", n=n,
                                q=tuple(qs), psi=tuple(psis), t=t)
