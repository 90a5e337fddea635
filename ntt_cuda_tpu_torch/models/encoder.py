"""CRT batching encoder (SEAL BatchEncoder semantics).

Counterpart of `ntt_cuda_tpu/models/encoder.py`.  For a prime plaintext
modulus t === 1 mod 2n (utils/primegen.find_plain_modulus) R_t =
Z_t[x]/(x^n + 1) splits into n CRT slots, the evaluations at the
primitive 2n-th roots of unity mod t.  The values form a 2 x (n/2) matrix;
elementwise ciphertext ops act slotwise, BFVContext.rotate_rows(ct, steps,
gks) rotates both rows cyclically and BFVContext.rotate_columns(ct, gks)
swaps them (the Galois elements 3^steps and 2n - 1).

Slot j of row 0 evaluates at psi^(3^j), row 1 at psi^(-3^j) (SEAL's
matrix_reps_index_map); the forward transform puts the evaluation at
psi^e at index bitrev((e - 1) / 2).  `encode` is a scatter and then kernel
7's inverse over the one-modulus tables of t, `decode` kernel 7's forward
and then a gather (the plain versions on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import cuda
from ..ops import ntt, ntt_stage
from ..ops.modmath import I64
from ..utils import hostmath as hm, primegen


def rotation_element(n: int, steps: int) -> int:
    """The Galois element of rotate_rows(steps): 3^steps mod 2n (negative
    steps rotate the other way; step 0 is the identity)."""
    return pow(3, steps % (n // 2), 2 * n)


def column_element(n: int) -> int:
    """The Galois element of rotate_columns: 2n - 1."""
    return 2 * n - 1


class BatchEncoder:
    """encode: (n,) slot values in [0, t) -> (n,) plaintext polynomial mod
    t; decode: the inverse.  Build once per parameter set and device
    (`device` None is the current CUDA device, raising where there is
    none)."""

    def __init__(self, params, device=None):
        t, n = params.t, params.n
        if t % 2 == 0 or t % (2 * n) != 1 or not primegen.is_prime(t):
            raise ValueError(
                f"batching needs a prime plaintext modulus t === 1 mod 2n "
                f"(got t={t}); generate one with "
                f"primegen.find_plain_modulus(n, bits)")
        self.params = params
        self.device = cuda.default_device(device, "BatchEncoder")
        psi = primegen.find_primitive_2n_root(t, n)
        self.tables = ntt.NTTTables.build([t], [psi], n, self.device)
        logn = n.bit_length() - 1
        idx = np.empty(n, dtype=np.int64)
        pos = 1
        for j in range(n // 2):
            idx[j] = hm.bit_reverse((pos - 1) >> 1, logn)
            idx[j + n // 2] = hm.bit_reverse((2 * n - pos - 1) >> 1, logn)
            pos = pos * 3 % (2 * n)
        self._idx = torch.from_numpy(idx).to(self.device)

    def _vector(self, name: str, x) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x, dtype=np.int64) if not isinstance(
            x, torch.Tensor) else x)
        n = self.params.n
        if tuple(x.shape) != (n,):
            raise ValueError(f"{name}: expected shape ({n},), got "
                             f"{tuple(x.shape)}")
        return x.to(device=self.device, dtype=I64)

    def encode(self, values) -> torch.Tensor:
        """(n,) slot values in [0, t) -> (n,) plaintext coefficients."""
        values = self._vector("values", values)
        hat = torch.zeros_like(values)
        hat[self._idx] = values
        return ntt_stage.ntt_inverse(hat[None], self.tables)[0]

    def decode(self, plain) -> torch.Tensor:
        """(n,) plaintext coefficients in [0, t) -> (n,) slot values."""
        plain = self._vector("plain", plain)
        return ntt_stage.ntt_forward(plain[None].contiguous(),
                                     self.tables)[0][self._idx]
