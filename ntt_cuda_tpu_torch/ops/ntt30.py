"""The 30-bit family's negacyclic NTT (q < 2^30, n up to 65536): its
tables, the plain tensor transform and kernel 22's wrappers.

Counterpart of `ntt_cuda_tpu/ops/ntt_pallas30.py` (the reference's
u32-coefficient pipeline, old/ntt_30bit.cuh): the same function, forward
natural order in and bit-reversed out, inverse back, every value in
[0, q), bit-identical to the 64-bit transform of `ops/ntt.py` on the same
modulus.  The arithmetic is the 32-bit Shoup multiply of `_shoup32`
(ntt_pallas30.py:154-156): t = v w - mulhi32(v, wp) q mod 2^32 with
wp = floor(w 2^32 / q), in [0, 2q), then one conditional subtract.  The
inverse is GS without halving and ends with one Shoup multiply by n^-1.

`NTTTables30` is laid out as the reference's tables (bit-reversed psi and
psi^-1 powers, `ops/ntt.py`), not as the TPU's four-step planes: u32
values as int32 bit patterns, each table with its Shoup companions, and
per modulus (q, n^-1, n^-1's companion, 0).

x has shape (..., n) with a number of polynomials B that is a multiple of
r; polynomial p (in row-major order) has modulus p % r, so (..., r, n) is
the RNS layout.  int32 (30-bit residues fit it exactly) or int64 in, the
same dtype out.  `ntt_forward` / `ntt_inverse` launch kernel 22
(csrc/ntt30.cu: one thread-block cluster of B blocks per polynomial, one
launch at every n; `cluster=` picks B, 0 the launchers' rule) on a CUDA
tensor and run the plain version on a CPU one.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import cuda
from ..utils import hostmath as hm
from ..utils import tracing
from . import modmath
from .modmath import I64, MASK32

I32 = torch.int32


def _bits32(vals) -> np.ndarray:
    """u32 values -> int32 bit patterns."""
    return np.asarray(vals, dtype=np.uint32).view(np.int32)


@functools.lru_cache(maxsize=16)
def _host_tables30(psi: int, q: int, n: int) -> np.ndarray:
    """(4, n) int32 rows for one modulus: psi^brv, its Shoup companions,
    then the same two for psi^-1."""
    rows = []
    for tbl in hm.psi_tables(psi, hm.modinv(psi, q), q, n):
        rows.append(_bits32(tbl))
        rows.append(_bits32([(w << 32) // q for w in tbl]))
    return np.stack(rows)


@dataclasses.dataclass(frozen=True)
class NTTTables30:
    """Kernel 22's tables for r moduli below 2^30 on one device: (r, n)
    int32 bit patterns of u32 psi / psi^-1 powers and their Shoup
    companions floor(w 2^32 / q); `consts` (r, 4) q, n^-1, its companion
    and 0."""

    psi: torch.Tensor
    psi_shoup: torch.Tensor
    psiinv: torch.Tensor
    psiinv_shoup: torch.Tensor
    consts: torch.Tensor
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
        return (self.psi.data_ptr(), self.psi_shoup.data_ptr(),
                self.psiinv.data_ptr(), self.psiinv_shoup.data_ptr(),
                self.consts.data_ptr())

    @staticmethod
    def build(qs, psis, n: int, device=None) -> "NTTTables30":
        """The tables on `device`: None is the current CUDA device, and
        raises where there is none; "cpu" for the plain versions."""
        device = cuda.default_device(device, "NTTTables30.build")
        qs = [int(q) for q in qs]
        for q in qs:
            if not 2 < q < (1 << 30):
                raise ValueError(f"30-bit path requires q < 2^30, got {q}")
        host = np.stack([_host_tables30(int(p), q, n)
                         for q, p in zip(qs, psis)])       # (r, 4, n)
        t = torch.from_numpy(host).to(device)
        consts = []
        for q in qs:
            ninv = hm.modinv(n, q)
            consts.append([q, ninv, (ninv << 32) // q, 0])
        return NTTTables30(
            psi=t[:, 0].contiguous(), psi_shoup=t[:, 1].contiguous(),
            psiinv=t[:, 2].contiguous(), psiinv_shoup=t[:, 3].contiguous(),
            consts=torch.from_numpy(_bits32(consts)).to(device), n=n)


def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> the u32 values as int64."""
    return t.to(I64) & MASK32


def _shoup32(v, w, ws, q):
    """v * w mod q in [0, q) for v in [0, 2^32) (int64 values): the
    kernel's mul_shoup32.  v * ws may pass 2^63 and wrap, so the high
    word is masked after the shift."""
    hi = ((v * ws) >> 32) & MASK32
    r = (v * w - hi * q) & MASK32
    return r - q * (r >= q).to(I64)


def _polys(name: str, x: torch.Tensor, tables: NTTTables30) -> int:
    """The number of polynomials in x; raises on what the transform does
    not take."""
    if x.dtype not in (I32, I64):
        raise TypeError(f"{name}: dtype {x.dtype}, expected int32 or int64")
    if x.dim() < 1 or x.shape[-1] != tables.n:
        raise ValueError(f"{name}: expected shape (..., {tables.n}), got "
                         f"{tuple(x.shape)}")
    polys = x.numel() // tables.n
    if polys % tables.r:
        raise ValueError(f"{name}: {polys} polynomials, not a multiple of "
                         f"r={tables.r}")
    return polys


def _transform_plain(x: torch.Tensor, tables: NTTTables30,
                     inverse: bool) -> torch.Tensor:
    polys = _polys("x", x, tables)
    r, n = tables.r, tables.n
    y = x.reshape(polys // r, r, n).to(I64)
    cols = _u32(tables.consts)
    q, ninv, ninv_sh = (cols[:, k:k + 1] for k in range(3))    # (r, 1)
    q3 = q[:, :, None]
    w_all = _u32(tables.psiinv if inverse else tables.psi)
    ws_all = _u32(tables.psiinv_shoup if inverse else tables.psi_shoup)
    stages = range(tables.logn)
    for s in (reversed(stages) if inverse else stages):
        length, step = 1 << s, n >> (s + 1)
        yr = y.reshape(polys // r, r, length, 2, step)
        u, v = yr[..., 0, :], yr[..., 1, :]
        w = w_all[:, length:2 * length, None]                   # (r, len, 1)
        ws = ws_all[:, length:2 * length, None]
        if inverse:
            pair = (modmath.add_mod(u, v, q3),
                    _shoup32(modmath.sub_mod(u, v, q3), w, ws, q3))
        else:
            t = _shoup32(v, w, ws, q3)
            pair = (modmath.add_mod(u, t, q3), modmath.sub_mod(u, t, q3))
        y = torch.stack(pair, dim=-2).reshape(polys // r, r, n)
    if inverse:
        y = _shoup32(y, ninv, ninv_sh, q)
    return y.reshape(x.shape).to(x.dtype)


def ntt_forward_plain(x, tables: NTTTables30) -> torch.Tensor:
    return _transform_plain(x, tables, inverse=False)


def ntt_inverse_plain(x, tables: NTTTables30) -> torch.Tensor:
    return _transform_plain(x, tables, inverse=True)


def _launch(name: str, x: torch.Tensor, tables: NTTTables30,
            inverse: bool, cluster: int) -> torch.Tensor:
    """Kernel 22 on x's card: int64 input goes to the card's u32 layout
    (int32) and back around the launch."""
    polys = _polys(name, x, tables)
    dev = cuda.kernel_device(name, x, tables, cuda.TRANSFORM30_MAX_N)
    x32 = x.to(I32).contiguous()
    cuda.require("x", x32, I32, tuple(x.shape), dev)
    out = torch.empty_like(x32)
    cuda.launch("ntt30_transform", dev, x32.data_ptr(), out.data_ptr(),
                *tables.kernel_args(), int(inverse), polys, tables.r,
                tables.logn, cluster)
    return out.to(x.dtype)


def ntt_forward(x, tables: NTTTables30, *, cluster: int = 0) -> torch.Tensor:
    """Forward NTT (30-bit family) on the last axis: natural order in,
    bit-reversed out, values in [0, q).  On the card: one launch, one
    cluster of `cluster` blocks per polynomial (0, which every caller in the
    package passes: the launchers' rule, 8; a B whose n/B buffer passes
    128 KB of a block, such as 1 at n = 65536, raises)."""
    if x.device.type == "cpu":
        return ntt_forward_plain(x, tables)
    with tracing.launch("ntt30.ntt_forward"):
        out = _launch("ntt30.ntt_forward", x, tables, False, cluster)
    return out


def ntt_inverse(x, tables: NTTTables30, *, cluster: int = 0) -> torch.Tensor:
    """Inverse NTT (30-bit family): bit-reversed in, natural out; `cluster`
    as ntt_forward's."""
    if x.device.type == "cpu":
        return ntt_inverse_plain(x, tables)
    with tracing.launch("ntt30.ntt_inverse"):
        out = _launch("ntt30.ntt_inverse", x, tables, True, cluster)
    return out
