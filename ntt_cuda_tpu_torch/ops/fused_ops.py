"""Whole-BFV-op transforms: half_polymul, keygen_fused, encrypt_fused.

Counterpart of `ntt_cuda_tpu/ops/fused_ops.py` for the main path.  On a
CUDA device each wrapper launches its kernel in csrc/fused_ops.cu: one
block per polynomial (message x modulus), resident in shared memory for
its whole forward -> dyadic -> inverse chain.  On the CPU it runs the
plain version beside it, composed from ops/ntt.py, ops/poly.py and the
compact-draw maps of ops/sampling.py: the same computation the JAX
package's xla pipelines run (models/bfv.py:933-937 and 1016-1023).

Draws arrive compact (int32 planes shared by all moduli): s and u
ternary, e Gaussian; the residue map d < 0 -> q + d happens inside.
"""

from __future__ import annotations

import torch

from .. import cuda
from . import ntt, poly, sampling
from .bfv_tail import TailConsts
from .modmath import I64
from .ntt import NTTTables


def _tables_args(tb: NTTTables):
    return (tb.psi.data_ptr(), tb.psi_shoup.data_ptr(), tb.psiinv.data_ptr(),
            tb.psiinv_shoup.data_ptr(), tb.consts.data_ptr())


def _kernel_device(name: str, x: torch.Tensor, tb: NTTTables) -> torch.device:
    """The device the kernel runs on; raises for anything but CUDA and for
    sizes the block-resident transform does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    if not 2 <= tb.n <= cuda.MAX_N:
        raise ValueError(f"{name}: n={tb.n} outside the block-resident "
                         f"transform's range [2, {cuda.MAX_N}]")
    return tb.device


# --- half_polymul ----------------------------------------------------------

def half_polymul_plain(x, y_ntt, tables: NTTTables) -> torch.Tensor:
    """INTT(NTT(x) (.) y_ntt): ntt_forward -> dyadic -> ntt_inverse."""
    fx = ntt.ntt_forward(x, tables)
    return ntt.ntt_inverse(ntt.dyadic_mul(fx, y_ntt, tables.ms), tables)


def half_polymul(x, y_ntt, tables: NTTTables) -> torch.Tensor:
    """INTT(NTT(x) (.) y_ntt) per modulus, the reference's
    half_poly_mul_device (poly_arithmetic.cuh:296-310) and decrypt's front.
    x (..., r, n) coefficient domain; y_ntt (r, n) NTT domain, shared by
    every leading index of x."""
    if x.device.type == "cpu":
        return half_polymul_plain(x, y_ntt, tables)
    dev = _kernel_device("half_polymul", x, tables)
    r, n = tables.r, tables.n
    if x.dim() < 2 or tuple(x.shape[-2:]) != (r, n):
        raise ValueError(f"half_polymul: x shape {tuple(x.shape)}, expected "
                         f"(..., {r}, {n})")
    cuda.require("x", x, I64, tuple(x.shape), dev)
    cuda.require("y_ntt", y_ntt, I64, (r, n), dev)
    out = torch.empty_like(x)
    blocks = x.numel() // n
    cuda.launch("ntt_half_polymul", dev, x.data_ptr(), y_ntt.data_ptr(),
                out.data_ptr(), *_tables_args(tables), blocks, r,
                n.bit_length() - 1)
    half_polymul.launches += 1
    return out


half_polymul.launches = 0


# --- keygen_fused ----------------------------------------------------------

def keygen_fused_plain(s_b, a, e_d, tables: NTTTables):
    """sk = NTT(s); pk0 = NTT(-(INTT(a (.) sk) + e)) (bfv_keygen.cuh:120-145)."""
    ms = tables.ms
    sk = ntt.ntt_forward(sampling.small_res(s_b, ms.q), tables)
    x = ntt.ntt_inverse(ntt.dyadic_mul(a, sk, ms), tables)
    x = poly.poly_add_negate(x, sampling.small_res(e_d, ms.q), ms)
    return sk, ntt.ntt_forward(x, tables)


def keygen_fused(s_b, a, e_d, tables: NTTTables):
    """Compact (n,) int32 ternary s_b, (r, n) NTT-domain uniform a, compact
    (n,) int32 Gaussian e_d -> (sk, pk0), both (r, n) NTT domain."""
    if a.device.type == "cpu":
        return keygen_fused_plain(s_b, a, e_d, tables)
    dev = _kernel_device("keygen_fused", a, tables)
    r, n = tables.r, tables.n
    cuda.require("s_b", s_b, torch.int32, (n,), dev)
    cuda.require("a", a, I64, (r, n), dev)
    cuda.require("e_d", e_d, torch.int32, (n,), dev)
    sk = torch.empty((r, n), dtype=I64, device=dev)
    pk0 = torch.empty((r, n), dtype=I64, device=dev)
    cuda.launch("ntt_keygen_fused", dev, s_b.data_ptr(), a.data_ptr(),
                e_d.data_ptr(), sk.data_ptr(), pk0.data_ptr(),
                *_tables_args(tables), r, n.bit_length() - 1)
    keygen_fused.launches += 1
    return sk, pk0


keygen_fused.launches = 0


# --- encrypt_fused ---------------------------------------------------------

def encrypt_fused_plain(u_b, pk, e_d, m_poly, tables: NTTTables,
                        consts: TailConsts):
    """Per message: c_h = INTT(NTT(u) (.) pk_h) +> e_h, the modulus drop,
    then c0 += Delta*m + fix.  (J, n), (2, r, n), (J, 2, n), (J, n) ->
    (J, 2, r-1, n); the J axis may be left out."""
    ms = tables.ms
    u_ntt = ntt.ntt_forward(sampling.small_res(u_b, ms.q), tables)
    c = ntt.ntt_inverse(ntt.dyadic_mul(u_ntt[..., None, :, :], pk, ms), tables)
    c = poly.poly_add(c, sampling.small_res(e_d, ms.q), ms)
    c = poly.divide_and_round_q_last(c, consts.dr, consts.ms_drop,
                                     consts.ms_last)
    c0 = poly.add_message(c[..., 0, :, :], m_poly, consts.msg)
    return torch.stack([c0, c[..., 1, :, :]], dim=-3)


def encrypt_fused(u_b, pk, e_d, m_poly, tables: NTTTables,
                  consts: TailConsts):
    """The whole encryption after the draws, J-batched.  u_b (J, n) compact
    ternary, pk (2, r, n) NTT domain, e_d (J, 2, n) compact Gaussian,
    m_poly (J, n) int64 messages -> (J, 2, r-1, n) ciphertexts; the J axis
    may be left out for one message.  Two launches on the card: the
    transforms into a (J, 2, r, n) scratch, then the elementwise tail."""
    if pk.device.type == "cpu":
        return encrypt_fused_plain(u_b, pk, e_d, m_poly, tables, consts)
    dev = _kernel_device("encrypt_fused", pk, tables)
    single = u_b.dim() == 1
    if single:
        u_b, e_d, m_poly = u_b[None], e_d[None], m_poly[None]
    J = u_b.shape[0]
    r, n = tables.r, tables.n
    cuda.require("u_b", u_b, torch.int32, (J, n), dev)
    cuda.require("pk", pk, I64, (2, r, n), dev)
    cuda.require("e_d", e_d, torch.int32, (J, 2, n), dev)
    cuda.require("m_poly", m_poly, I64, (J, n), dev)
    scratch = torch.empty((J, 2, r, n), dtype=I64, device=dev)
    ct = torch.empty((J, 2, r - 1, n), dtype=I64, device=dev)
    cuda.launch("ntt_encrypt_transform", dev, u_b.data_ptr(), pk.data_ptr(),
                e_d.data_ptr(), scratch.data_ptr(), *_tables_args(tables), J,
                r, n.bit_length() - 1)
    cuda.launch("ntt_encrypt_tail", dev, scratch.data_ptr(),
                m_poly.data_ptr(), ct.data_ptr(), consts.per_mod.data_ptr(),
                consts.q_last,
                consts.half, consts.fix_th, J, r, n)
    encrypt_fused.launches += 1
    return ct[0] if single else ct


encrypt_fused.launches = 0
