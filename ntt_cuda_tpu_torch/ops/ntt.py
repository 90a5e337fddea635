"""Negacyclic NTT / inverse NTT: the plain tensor transform and the
twiddle tables the kernels read.

Counterpart of `ntt_cuda_tpu/ops/ntt.py` with the same index algebra as
the reference (ntt_60bit.cuh:63-265): the forward transform is CT,
natural order in, bit-reversed order out, twiddle
`psi[length + psi_step]` from a bit-reverse-ordered power table; the
inverse is GS with per-stage halving, which folds n^-1 into the stages.
This plain version is the oracle every kernel is held against.

`NTTTables` also carries what the CUDA kernels read (the counterpart of
`ntt_pallas.tables_for`, in the reference's own layout rather than the
TPU's four-step one): the plain bit-reversed psi / psi^-1 powers, their
Shoup companions, and per modulus q, -q^-1 mod 2^64 and n^-1 * 2^64 mod q
with its Shoup companion.  The kernels' inverse skips the halving and
ends with one multiply by n^-1 * 2^64, which also cancels the 2^-64 of
the Montgomery dyadic product in front of it.

Shapes: transforms act on the last axis; the RNS-modulus axis is second
to last.  x: (..., r, n); tables: (r, n).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import cuda
from ..utils import hostmath as hm
from . import modmath
from .modmath import I64, ModulusSet


@functools.lru_cache(maxsize=32)
def _host_tables(psi: int, q: int, n: int) -> np.ndarray:
    """(6, n) int64 rows for one modulus: psi^brv, its Montgomery form,
    its Shoup companion, then the same three for psi^-1."""
    rows = []
    for tbl in hm.psi_tables(psi, hm.modinv(psi, q), q, n):
        rows.append(tbl)
        rows.append([(x << 64) % q for x in tbl])
        rows.append([modmath.as_i64(hm.shoup(x, q)) for x in tbl])
    return np.array(rows, dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class NTTTables:
    """Twiddle tables for r moduli, (r, n) int64 tensors on one device.

    psi_mont / psiinv_mont feed the plain transform (one REDC per
    butterfly, as in the JAX package); psi, psi_shoup, psiinv,
    psiinv_shoup and `consts` feed the kernels.  `consts` is (r, 4):
    q, -q^-1 mod 2^64, n^-1 * 2^64 mod q and its Shoup companion."""

    psi_mont: torch.Tensor
    psiinv_mont: torch.Tensor
    psi: torch.Tensor
    psi_shoup: torch.Tensor
    psiinv: torch.Tensor
    psiinv_shoup: torch.Tensor
    consts: torch.Tensor
    ms: ModulusSet
    n: int

    @property
    def r(self) -> int:
        return self.psi.shape[0]

    @property
    def device(self) -> torch.device:
        return self.psi.device

    @property
    def logn(self) -> int:
        return self.n.bit_length() - 1

    def kernel_args(self) -> tuple:
        """The kernels' table arguments: psi, its Shoup companions, psi^-1,
        its Shoup companions and consts, as data pointers."""
        return (self.psi.data_ptr(), self.psi_shoup.data_ptr(),
                self.psiinv.data_ptr(), self.psiinv_shoup.data_ptr(),
                self.consts.data_ptr())

    @staticmethod
    def build(qs, psis, n: int, device=None) -> "NTTTables":
        """The tables of moduli qs with 2n-th roots psis on `device`: None
        is the current CUDA device, and raises where there is none;
        "cpu" for the plain versions."""
        device = cuda.default_device(device, "NTTTables.build")
        host = np.stack([_host_tables(int(p), int(q), n)
                         for q, p in zip(qs, psis)])        # (r, 6, n)
        t = torch.from_numpy(host).to(device)
        consts = []
        for q in qs:
            q = int(q)
            ninv_mont = hm.to_mont(hm.modinv(n, q), q)
            consts.append([q, hm.mont_qinv_neg(q), ninv_mont,
                           hm.shoup(ninv_mont, q)])
        consts_t = torch.tensor([[modmath.as_i64(v) for v in row]
                                 for row in consts], dtype=I64, device=device)
        return NTTTables(
            psi=t[:, 0].contiguous(), psi_mont=t[:, 1].contiguous(),
            psi_shoup=t[:, 2].contiguous(), psiinv=t[:, 3].contiguous(),
            psiinv_mont=t[:, 4].contiguous(),
            psiinv_shoup=t[:, 5].contiguous(),
            consts=consts_t, ms=ModulusSet.from_moduli(qs, device), n=n)


def tables_for(params, count: int | None = None, device=None) -> NTTTables:
    """NTTTables of params' first `count` moduli (all: None) on `device`
    (None: the current CUDA device, as NTTTables.build)."""
    qs = params.q if count is None else params.q[:count]
    psis = params.psi if count is None else params.psi[:count]
    return NTTTables.build(qs, psis, params.n, device)


def _col(c: torch.Tensor, tail_ndim: int) -> torch.Tensor:
    """Reshape an (r, 1) constant to (r, 1, ..., 1) with `tail_ndim` ones
    so that it broadcasts against (..., r, *tail)."""
    return c.reshape((c.shape[0],) + (1,) * tail_ndim)


def ntt_forward(x: torch.Tensor, tables: NTTTables) -> torch.Tensor:
    """Forward negacyclic NTT on the last axis.  Natural order in,
    bit-reversed order out; values stay in [0, q)."""
    n = tables.n
    logn = n.bit_length() - 1
    shape = x.shape
    lead = shape[:-1]
    q2 = _col(tables.ms.q, 2)
    qi2 = _col(tables.ms.qinv_neg, 2)
    for s in range(logn):
        length = 1 << s
        step = n >> (s + 1)
        xr = x.reshape(lead + (length, 2, step))
        u = xr[..., 0, :]
        v = xr[..., 1, :]
        w = tables.psi_mont[:, length:2 * length, None]     # (r, length, 1)
        t = modmath.mont_mul(v, w, q2, qi2)
        x = torch.stack([modmath.add_mod(u, t, q2),
                         modmath.sub_mod(u, t, q2)], dim=-2).reshape(shape)
    return x


def ntt_inverse(x: torch.Tensor, tables: NTTTables) -> torch.Tensor:
    """Inverse negacyclic NTT on the last axis.  Bit-reversed order in,
    natural order out; the per-stage halving folds in n^-1
    (GSBasedINTT*, ntt_60bit.cuh:125-190)."""
    n = tables.n
    logn = n.bit_length() - 1
    shape = x.shape
    lead = shape[:-1]
    q2 = _col(tables.ms.q, 2)
    qi2 = _col(tables.ms.qinv_neg, 2)
    for s in reversed(range(logn)):
        length = 1 << s
        step = n >> (s + 1)
        xr = x.reshape(lead + (length, 2, step))
        u = xr[..., 0, :]
        v = xr[..., 1, :]
        w = tables.psiinv_mont[:, length:2 * length, None]
        s_ = modmath.add_mod(u, v, q2)
        d_ = modmath.mont_mul(modmath.sub_mod(u, v, q2), w, q2, qi2)
        x = torch.stack([modmath.halve_mod(s_, q2),
                         modmath.halve_mod(d_, q2)], dim=-2).reshape(shape)
    return x


def dyadic_mul(a: torch.Tensor, b: torch.Tensor, ms: ModulusSet) -> torch.Tensor:
    """Pointwise a*b mod q in the NTT domain (barrett_batch,
    poly_arithmetic.cuh:36-66)."""
    return modmath.mulmod(a, b, ms.q, ms.qinv_neg, ms.r2)


def negacyclic_polymul(a: torch.Tensor, b: torch.Tensor,
                       tables: NTTTables) -> torch.Tensor:
    """INTT(NTT(a) . NTT(b)), the negacyclic product mod (x^n + 1, q_i)
    (full_poly_mul, poly_arithmetic.cuh:277-294), plain."""
    return ntt_inverse(dyadic_mul(ntt_forward(a, tables),
                                  ntt_forward(b, tables), tables.ms), tables)
