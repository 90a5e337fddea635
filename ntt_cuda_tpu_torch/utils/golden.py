"""Golden models: the schoolbook negacyclic product (the NTT tests') and
the reference's double-precision uniform draw (uniform_ref_double).

Counterpart of `schoolbook_negacyclic` in `ntt_cuda_tpu/utils/golden.py`
(the reference's refPolyMul128, helper.h:95-126), which calls the JAX
package's native C++ helper; that helper is not ported.  Here the O(n^2)
product is plain tensor code on a given device, independent of any NTT:
c = sum_i a_i x^i b, where x^i b is b rotated negacyclically by i
(coefficients that wrap past x^n change sign), taken a chunk of rotations
at a time.
"""

from __future__ import annotations

import torch

from ..ops import modmath
from ..ops.modmath import I64

_CHUNK_ELEMS = 1 << 22    # rotations of b held at once: chunk * n values


def schoolbook_negacyclic(a, b, q: int, n: int, device=None) -> torch.Tensor:
    """a * b in Z_q[x]/(x^n + 1), (n,) int64 on `device` (None: a's device
    if a is a tensor, else the CPU).  a and b hold n values in [0, q).
    q < 2^31 multiplies exactly in int64; a larger q must be odd and below
    2^62 (the Montgomery mulmod of ops/modmath.py)."""
    if device is None:
        device = a.device if isinstance(a, torch.Tensor) else "cpu"
    a = torch.as_tensor(a, device=device).to(I64).reshape(n)
    b = torch.as_tensor(b, device=device).to(I64).reshape(n)
    small = q < (1 << 31)
    if not small and (q % 2 == 0 or q >= (1 << 62)):
        raise ValueError(f"q={q}: an odd q below 2^62 (or any q < 2^31)")
    ms = modmath.ModulusSet.from_moduli([q], device) if not small else None
    qt = torch.tensor(q, dtype=I64, device=device)
    chunk = max(1, min(n, _CHUNK_ELEMS // n))
    k = torch.arange(n, device=device)
    acc = torch.zeros(n, dtype=I64, device=device)
    for i0 in range(0, n, chunk):
        i = torch.arange(i0, min(i0 + chunk, n), device=device)[:, None]
        rot = b[(k - i) % n]                       # (chunk, n): b[k - i]
        rot = torch.where(k < i, modmath.negate_mod(rot, qt), rot)
        ai = a[i]                                  # (chunk, 1)
        if small:
            part = (ai * rot) % q                  # < 2^31 each
            s = part.sum(dim=0) % q
        else:
            part = modmath.mulmod(rot, ai, ms.q[0], ms.qinv_neg[0], ms.r2[0])
            # each < 2^62: sum the 31-bit halves apart, then recombine
            lo = (part & ((1 << 31) - 1)).sum(dim=0) % q
            hi = (part >> 31).sum(dim=0) % q
            s = modmath.add_mod(
                modmath.mulmod(hi, qt.new_tensor(pow(2, 31, q)), ms.q[0],
                               ms.qinv_neg[0], ms.r2[0]), lo, qt)
        acc = modmath.add_mod(acc, s, qt)
    return acc


def uniform_ref_double(u64_vals, q: int) -> list[int]:
    """The reference's uniform draw in IEEE doubles, on the host (the JAX
    package's golden.uniform_ref_double; uniform_dist_xq,
    bfv_keygen.cuh:33-45): d = (double)u; d /= (double)UINT64_MAX;
    d *= (double)(q - 1); the cast truncates.  Python floats are IEEE
    doubles, and float(int) rounds to nearest even as the C cast does."""
    top = float((1 << 64) - 1)
    return [int(float(int(u)) / top * float(q - 1)) for u in u64_vals]
