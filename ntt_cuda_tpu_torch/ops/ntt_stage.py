"""Stage-schedule transforms: one forward or inverse NTT per call, with an
elementwise prologue fused in.

Counterpart of the public API of `ntt_cuda_tpu/ops/ntt_pallas.py`
(`ntt_forward`, `ntt_inverse`, `ntt_inverse_mul`, `ntt_forward_ternary`,
`ntt_forward_addneg_gauss`, `ntt_forward_addneg`), the kernels of the JAX
package's `fusion="stage"` schedule and of its EvalMult path.  On a CUDA
device each wrapper launches csrc/ntt_stage.cu (n <= 32768); on the CPU
it runs the plain version beside it, composed from ops/ntt.py,
ops/poly.py and the compact-draw map of ops/sampling.py.

Standard RNS layout: x is (r, n) for one message or (J, r, n) for J, and
polynomial (j, i) has modulus i.  A compact i32 draw is (n,) or (J, n),
one row per message, shared by its r moduli.  Shapes are explicit: a
mismatch raises, and no (J, r) order is guessed from a flat batch.  The
one exception is `ntt_forward` / `ntt_inverse` with `mod_idx` (kernel
12): x is any (..., n) batch of B polynomials and polynomial b has modulus
mod_idx[b].

The launchers also take a coefficient shard (`logc`, `shard`): shard c of
C = 2^logc runs the local stages of a C n-point transform over the full
tables (parallel/coef_kernels.py).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import cuda
from . import ntt, poly, sampling
from .modmath import I64
from .ntt import NTTTables


def _residue_lead(name: str, x: torch.Tensor, tables: NTTTables) -> tuple:
    """() for an (r, n) x, (J,) for a (J, r, n) one; raises otherwise."""
    r, n = tables.r, tables.n
    if x.dim() in (2, 3) and tuple(x.shape[-2:]) == (r, n):
        return tuple(x.shape[:-2])
    raise ValueError(f"{name}: expected shape ({r}, {n}) or (J, {r}, {n}), "
                     f"got {tuple(x.shape)}")


def _draw_lead(name: str, d: torch.Tensor, n: int) -> tuple:
    """() for an (n,) compact draw, (J,) for a (J, n) one; raises
    otherwise."""
    if d.dtype != torch.int32:
        raise TypeError(f"{name}: expected a compact int32 draw, got "
                        f"{d.dtype}")
    if d.dim() in (1, 2) and d.shape[-1] == n:
        return tuple(d.shape[:-1])
    raise ValueError(f"{name}: expected shape ({n},) or (J, {n}), got "
                     f"{tuple(d.shape)}")


def _kernel_device(name: str, t: torch.Tensor,
                   tables: NTTTables) -> torch.device:
    return cuda.kernel_device(name, t, tables, cuda.TRANSFORM_MAX_N)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def forward_launch(dev, x, d, out, tables: NTTTables, pro: int, y=None,
                   nu=None, mod_idx=None, logc: int = 0,
                   shard: int = 0) -> None:
    """Launch the forward kernel with prologue `pro` (cuda.PRO_*) on
    prologue inputs x, d, y, nu into out (P, n'), where n' = n / 2^logc is
    shard `shard`'s width (n' = n unsharded); mod_idx (P,) int32 or None
    (polynomial p has modulus p % r)."""
    n = tables.n >> logc
    cuda.launch("ntt_stage_forward", dev, _ptr(x), _ptr(d), _ptr(y), _ptr(nu),
                out.data_ptr(), *tables.kernel_args(), pro, out.numel() // n,
                tables.r, n.bit_length() - 1, _ptr(mod_idx), logc, shard)


def inverse_launch(dev, x, y, e, out, tables: NTTTables, mod_idx=None,
                   logc: int = 0, shard: int = 0) -> None:
    """Launch the inverse kernel: out = INTT(x (.) y) (+> e) when y is
    given, else INTT(x).  y's rows are taken in turn per polynomial (row
    p % rows), e's per message (row p / r).  mod_idx, logc and shard as
    forward_launch's."""
    n = tables.n >> logc
    pro = cuda.PRO_COPY if y is None else cuda.PRO_MONT
    ny = 1 if y is None else y.numel() // n
    cuda.launch("ntt_stage_inverse", dev, _ptr(x), _ptr(y), _ptr(e),
                out.data_ptr(), *tables.kernel_args(), pro, ny,
                out.numel() // n, tables.r, n.bit_length() - 1,
                _ptr(mod_idx), logc, shard)


# --- kernel 12: a per-polynomial modulus index ------------------------------

def _mod_idx(name: str, x, mod_idx, tables: NTTTables) -> torch.Tensor:
    """mod_idx as a (B,) int32 tensor on x's device, B = x's polynomial
    count; raises on a length or an index outside [0, r) before any launch
    (on the TPU such an index reads outside the tables).  The check reads
    the index on the host: a CUDA mod_idx waits for the device, a host one
    goes to the card through pinned memory without a stream sync."""
    if x.dim() < 1 or x.shape[-1] != tables.n:
        raise ValueError(f"{name}: expected shape (..., {tables.n}), got "
                         f"{tuple(x.shape)}")
    idx = torch.as_tensor(mod_idx).reshape(-1)
    B = x.numel() // tables.n
    if idx.numel() != B:
        raise ValueError(f"{name}: mod_idx has {idx.numel()} entries for "
                         f"{B} polynomials")
    if idx.dtype.is_floating_point or idx.dtype.is_complex:
        raise TypeError(f"{name}: mod_idx must be integers, got {idx.dtype}")
    if B and (int(idx.min()) < 0 or int(idx.max()) >= tables.r):
        raise ValueError(f"{name}: mod_idx outside [0, {tables.r})")
    idx = idx.to(dtype=torch.int32).contiguous()
    if x.is_cuda and not idx.is_cuda:
        idx = idx.pin_memory()
    return idx.to(x.device, non_blocking=True)


def ntt_transform_idx_plain(x, tables: NTTTables, mod_idx,
                            inverse: bool = False) -> torch.Tensor:
    """Kernel 12's plain version: ops/ntt.py's transform of x's B
    polynomials as B rows, over the tables' rows gathered by mod_idx."""
    idx = _mod_idx("x", x, mod_idx, tables).to(tables.device, torch.int64)
    ms = tables.ms
    rows = dataclasses.replace(
        tables, psi_mont=tables.psi_mont[idx],
        psiinv_mont=tables.psiinv_mont[idx],
        ms=dataclasses.replace(ms, q=ms.q[idx], qinv_neg=ms.qinv_neg[idx]))
    fn = ntt.ntt_inverse if inverse else ntt.ntt_forward
    return fn(x.reshape(-1, tables.n), rows).reshape(x.shape)


def ntt_transform_idx(x, tables: NTTTables, mod_idx,
                      inverse: bool = False) -> torch.Tensor:
    """Kernel 12: forward (or inverse) NTT of every polynomial of x
    (..., n), polynomial b over modulus mod_idx[b]; one launch."""
    if x.device.type == "cpu":
        return ntt_transform_idx_plain(x, tables, mod_idx, inverse)
    idx = _mod_idx("ntt_transform_idx", x, mod_idx, tables)
    dev = _kernel_device("ntt_transform_idx", x, tables)
    cuda.require("x", x, I64, tuple(x.shape), dev)
    out = torch.empty_like(x)
    if out.numel():
        if inverse:
            inverse_launch(dev, x, None, None, out, tables, mod_idx=idx)
        else:
            forward_launch(dev, x, None, out, tables, cuda.PRO_COPY,
                           mod_idx=idx)
        ntt_transform_idx.launches += 1
    return out


ntt_transform_idx.launches = 0


# --- kernel 7: forward and inverse ------------------------------------------

def ntt_forward_plain(x, tables: NTTTables) -> torch.Tensor:
    return ntt.ntt_forward(x, tables)


def ntt_forward(x, tables: NTTTables, mod_idx=None) -> torch.Tensor:
    """Forward NTT of (r, n) or (J, r, n) coefficient-domain residues; with
    mod_idx, of any (..., n) batch, polynomial b over modulus mod_idx[b]
    (kernel 12, counted on ntt_transform_idx)."""
    if mod_idx is not None:
        return ntt_transform_idx(x, tables, mod_idx)
    _residue_lead("x", x, tables)
    if x.device.type == "cpu":
        return ntt_forward_plain(x, tables)
    dev = _kernel_device("ntt_forward", x, tables)
    cuda.require("x", x, I64, tuple(x.shape), dev)
    out = torch.empty_like(x)
    forward_launch(dev, x, None, out, tables, cuda.PRO_COPY)
    ntt_forward.launches += 1
    return out


ntt_forward.launches = 0


def ntt_inverse_plain(x, tables: NTTTables) -> torch.Tensor:
    return ntt.ntt_inverse(x, tables)


def ntt_inverse(x, tables: NTTTables, mod_idx=None) -> torch.Tensor:
    """Inverse NTT of (r, n) or (J, r, n) NTT-domain residues; mod_idx as
    ntt_forward's."""
    if mod_idx is not None:
        return ntt_transform_idx(x, tables, mod_idx, inverse=True)
    _residue_lead("x", x, tables)
    if x.device.type == "cpu":
        return ntt_inverse_plain(x, tables)
    dev = _kernel_device("ntt_inverse", x, tables)
    cuda.require("x", x, I64, tuple(x.shape), dev)
    out = torch.empty_like(x)
    inverse_launch(dev, x, None, None, out, tables)
    ntt_inverse.launches += 1
    return out


ntt_inverse.launches = 0


# --- kernel 8: INTT(x (.) y) ------------------------------------------------

def ntt_inverse_mul_plain(x, y, tables: NTTTables) -> torch.Tensor:
    return ntt.ntt_inverse(ntt.dyadic_mul(x, y, tables.ms), tables)


def ntt_inverse_mul(x, y, tables: NTTTables) -> torch.Tensor:
    """INTT(x (.) y), both NTT domain: x (r, n) or (J, r, n); y (r, n),
    shared by every message, or x's shape."""
    _residue_lead("x", x, tables)
    if tuple(y.shape) not in (tuple(x.shape), (tables.r, tables.n)):
        raise ValueError(f"y: expected shape ({tables.r}, {tables.n}) or "
                         f"{tuple(x.shape)}, got {tuple(y.shape)}")
    if x.device.type == "cpu":
        return ntt_inverse_mul_plain(x, y, tables)
    dev = _kernel_device("ntt_inverse_mul", x, tables)
    cuda.require("x", x, I64, tuple(x.shape), dev)
    cuda.require("y", y, I64, tuple(y.shape), dev)
    out = torch.empty_like(x)
    inverse_launch(dev, x, y, None, out, tables)
    ntt_inverse_mul.launches += 1
    return out


ntt_inverse_mul.launches = 0


# --- kernel 9: NTT of a compact ternary draw --------------------------------

def ntt_forward_ternary_plain(u_b, tables: NTTTables) -> torch.Tensor:
    return ntt.ntt_forward(sampling.small_res(u_b, tables.ms.q), tables)


def ntt_forward_ternary(u_b, tables: NTTTables) -> torch.Tensor:
    """(n,) or (J, n) compact int32 ternary draw -> (r, n) or (J, r, n)
    NTT-domain residues (keygen's s, encryption's u)."""
    lead = _draw_lead("u_b", u_b, tables.n)
    if u_b.device.type == "cpu":
        return ntt_forward_ternary_plain(u_b, tables)
    dev = _kernel_device("ntt_forward_ternary", u_b, tables)
    cuda.require("u_b", u_b, torch.int32, tuple(u_b.shape), dev)
    out = torch.empty(lead + (tables.r, tables.n), dtype=I64, device=dev)
    forward_launch(dev, None, u_b, out, tables, cuda.PRO_TERNARY)
    ntt_forward_ternary.launches += 1
    return out


ntt_forward_ternary.launches = 0


# --- kernel 10: NTT(-(x + e)) with a compact Gaussian e ---------------------

def ntt_forward_addneg_gauss_plain(x, e_d, tables: NTTTables) -> torch.Tensor:
    ms = tables.ms
    return ntt.ntt_forward(
        poly.poly_add_negate(x, sampling.small_res(e_d, ms.q), ms), tables)


def ntt_forward_addneg_gauss(x, e_d, tables: NTTTables) -> torch.Tensor:
    """NTT(-(x + e) mod q): x (r, n) or (J, r, n) coefficient domain, e_d
    the matching (n,) or (J, n) compact int32 Gaussian (keygen's pk0)."""
    lead = _residue_lead("x", x, tables)
    if _draw_lead("e_d", e_d, tables.n) != lead:
        raise ValueError(f"e_d: shape {tuple(e_d.shape)} does not match x "
                         f"{tuple(x.shape)}: one row per message")
    if x.device.type == "cpu":
        return ntt_forward_addneg_gauss_plain(x, e_d, tables)
    dev = _kernel_device("ntt_forward_addneg_gauss", x, tables)
    cuda.require("x", x, I64, tuple(x.shape), dev)
    cuda.require("e_d", e_d, torch.int32, tuple(e_d.shape), dev)
    out = torch.empty_like(x)
    forward_launch(dev, x, e_d, out, tables, cuda.PRO_ADDNEG_GAUSS)
    ntt_forward_addneg_gauss.launches += 1
    return out


ntt_forward_addneg_gauss.launches = 0


# --- kernel 11: NTT(-(x + e)) with a u64 e ----------------------------------

def ntt_forward_addneg_plain(x, e, tables: NTTTables) -> torch.Tensor:
    return ntt.ntt_forward(poly.poly_add_negate(x, e, tables.ms), tables)


def ntt_forward_addneg(x, e, tables: NTTTables) -> torch.Tensor:
    """NTT(-(x + e) mod q) with the 0 fixup: x (r, n) or (J, r, n)
    coefficient domain, e canonical residues of x's shape, read at x's
    index (the switching keys' key0 rows)."""
    _residue_lead("x", x, tables)
    if tuple(e.shape) != tuple(x.shape):
        raise ValueError(f"e: shape {tuple(e.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if x.device.type == "cpu":
        return ntt_forward_addneg_plain(x, e, tables)
    dev = _kernel_device("ntt_forward_addneg", x, tables)
    cuda.require("x", x, I64, tuple(x.shape), dev)
    cuda.require("e", e, I64, tuple(x.shape), dev)
    out = torch.empty_like(x)
    forward_launch(dev, x, None, out, tables, cuda.PRO_ADDNEG, y=e)
    ntt_forward_addneg.launches += 1
    return out


ntt_forward_addneg.launches = 0
