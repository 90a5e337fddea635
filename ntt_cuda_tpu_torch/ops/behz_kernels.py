"""The BEHZ base-conversion kernels of EvalMult and their wrappers.

Counterpart of `ntt_cuda_tpu/ops/behz_pallas.py` (TPU kernels 21a-c):
`rns_to_bsk`, `fast_floor`, `bsk_to_q` and `scale_and_round` (21b then
21c).  On a CUDA device each wrapper launches csrc/behz.cu; on the CPU it
runs the plain version, the ops/behz.py chain, with the same integers out.

`MultBanks` holds both the plain version's `behz.MultConsts` and the
kernels' constant banks: native u64 (value, Shoup quotient) pairs, the
counterparts of `MultPallasConsts` (behz_pallas.py:104-166) without the
TPU's u32 limb pairs.  Layouts are in csrc/behz.cu.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import cuda
from ..utils import hostmath as hm
from . import behz, modmath
from .behz import AuxBase, MultConsts
from .modmath import I64

# csrc/behz.cu BEHZ_*
RNS_TO_BSK, FAST_FLOOR, BSK_TO_Q = range(3)
MAX_K = 16


def _wws(w: int, m: int) -> tuple[int, int]:
    """A constant mod m and its Shoup companion floor(w 2^64 / m)."""
    w %= m
    return w, hm.shoup(w, m)


@dataclasses.dataclass(frozen=True)
class MultBanks:
    mc: MultConsts          # the plain version's constants
    qsrc: torch.Tensor      # (k, 6)
    tgt: torch.Tensor       # (k+1, 9)
    amat: torch.Tensor      # (k+1, k, 2)
    bsrc: torch.Tensor      # (k, 5)
    bmat: torch.Tensor      # (k, k, 2)
    bfin: torch.Tensor      # (k, 2)
    glob: torch.Tensor      # (5,)

    @property
    def k(self) -> int:
        return self.mc.k

    @property
    def device(self) -> torch.device:
        return self.qsrc.device

    def kernel_args(self) -> tuple:
        return tuple(b.data_ptr() for b in (self.qsrc, self.tgt, self.amat,
                                            self.bsrc, self.bmat, self.bfin,
                                            self.glob))

    @staticmethod
    def build(params, aux: AuxBase | None = None,
              device=None) -> "MultBanks":
        aux = aux or AuxBase.build(params)
        k = params.r - 1
        if k > MAX_K:
            raise ValueError(f"k = r-1 = {k} > {MAX_K}: the conversion "
                             f"kernels hold at most {MAX_K} source residues")
        qs, bsk, msk, mt, t = (params.q[:-1], aux.bsk, aux.m_sk, aux.m_tilde,
                               params.t)
        q_prod, b_prod = behz.prod(qs), behz.prod(aux.b)
        punct_q = [q_prod // qj for qj in qs]
        punct_b = [b_prod // bj for bj in aux.b]

        def bank(rows):
            return torch.tensor([[modmath.as_i64(v) for v in row]
                                 for row in rows], dtype=I64, device=device)

        inv = hm.modinv
        return MultBanks(
            mc=MultConsts.build(params, aux, device),
            qsrc=bank([(qj,) + _wws(mt * inv(pj % qj, qj), qj)
                       + _wws(t * inv(pj % qj, qj), qj) + (pj % mt,)
                       for pj, qj in zip(punct_q, qs)]),
            tgt=bank([(m,) + _wws(q_prod, m) + _wws(inv(mt % m, m), m)
                      + _wws(t, m) + _wws(inv(q_prod % m, m), m)
                      for m in bsk]),
            amat=bank([[c for pj in punct_q for c in _wws(pj, m)]
                       for m in bsk]).reshape(k + 1, k, 2),
            bsrc=bank([(bj,) + _wws(inv(pj % bj, bj), bj) + _wws(pj, msk)
                       for pj, bj in zip(punct_b, aux.b)]),
            bmat=bank([[c for pj in punct_b for c in _wws(pj, qi)]
                       for qi in qs]).reshape(k, k, 2),
            bfin=bank([_wws(b_prod, qi) for qi in qs]),
            glob=bank([(msk, msk >> 1) + _wws(inv(b_prod % msk, msk), msk)
                       + ((-pow(q_prod, -1, mt)) % mt,)])[0],
        )


def _lead(name: str, x: torch.Tensor, rows: int) -> tuple:
    if x.dim() < 2 or x.shape[-2] != rows:
        raise ValueError(f"{name}: expected shape (..., {rows}, n), got "
                         f"{tuple(x.shape)}")
    return tuple(x.shape[:-2])


def _launch(which: int, x, xb, out, mb: MultBanks) -> None:
    k, n = mb.k, x.shape[-1]
    C = out.numel() // (out.shape[-2] * n)
    cuda.launch("ntt_behz", mb.device, which, x.data_ptr(),
                None if xb is None else xb.data_ptr(), out.data_ptr(),
                *mb.kernel_args(), C, k, n)


def _kernel_device(name: str, x: torch.Tensor, mb: MultBanks):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {x.device}")
    return mb.device


# --- kernel 21a: q -> Bsk ----------------------------------------------------

def rns_to_bsk_plain(x, mb: MultBanks) -> torch.Tensor:
    return behz.rns_to_bsk(x, mb.mc)


def rns_to_bsk(x, mb: MultBanks) -> torch.Tensor:
    """(..., k, n) base-q residues -> (..., k+1, n) in Bsk."""
    lead = _lead("x", x, mb.k)
    if x.device.type == "cpu":
        return rns_to_bsk_plain(x, mb)
    dev = _kernel_device("rns_to_bsk", x, mb)
    cuda.require("x", x, I64, tuple(x.shape), dev)
    out = torch.empty(lead + (mb.k + 1, x.shape[-1]), dtype=I64, device=dev)
    _launch(RNS_TO_BSK, x, None, out, mb)
    rns_to_bsk.launches += 1
    return out


rns_to_bsk.launches = 0


# --- kernel 21b: floor(t x / q) in Bsk ---------------------------------------

def fast_floor_plain(xq, xbsk, mb: MultBanks) -> torch.Tensor:
    return behz.fast_floor(xq, xbsk, mb.mc)


def fast_floor(xq, xbsk, mb: MultBanks) -> torch.Tensor:
    """(..., k, n) and (..., k+1, n), the same value in q and Bsk ->
    floor(t x / q) in Bsk, (..., k+1, n)."""
    lead = _lead("xq", xq, mb.k)
    if _lead("xbsk", xbsk, mb.k + 1) != lead or xbsk.shape[-1] != xq.shape[-1]:
        raise ValueError(f"xbsk: shape {tuple(xbsk.shape)} does not match "
                         f"xq {tuple(xq.shape)}")
    if xq.device.type == "cpu":
        return fast_floor_plain(xq, xbsk, mb)
    dev = _kernel_device("fast_floor", xq, mb)
    cuda.require("xq", xq, I64, tuple(xq.shape), dev)
    cuda.require("xbsk", xbsk, I64, tuple(xbsk.shape), dev)
    out = torch.empty_like(xbsk)
    _launch(FAST_FLOOR, xq, xbsk, out, mb)
    fast_floor.launches += 1
    return out


fast_floor.launches = 0


# --- kernel 21c: Shenoy-Kumaresan Bsk -> q -----------------------------------

def bsk_to_q_plain(x, mb: MultBanks) -> torch.Tensor:
    return behz.bsk_to_q(x, mb.mc)


def bsk_to_q(x, mb: MultBanks) -> torch.Tensor:
    """(..., k+1, n) in Bsk -> (..., k, n) in q."""
    lead = _lead("x", x, mb.k + 1)
    if x.device.type == "cpu":
        return bsk_to_q_plain(x, mb)
    dev = _kernel_device("bsk_to_q", x, mb)
    cuda.require("x", x, I64, tuple(x.shape), dev)
    out = torch.empty(lead + (mb.k, x.shape[-1]), dtype=I64, device=dev)
    _launch(BSK_TO_Q, x, None, out, mb)
    bsk_to_q.launches += 1
    return out


bsk_to_q.launches = 0


def scale_and_round_plain(xq, xbsk, mb: MultBanks) -> torch.Tensor:
    return behz.scale_and_round(xq, xbsk, mb.mc)


def scale_and_round(xq, xbsk, mb: MultBanks) -> torch.Tensor:
    """round(t x / q) in base q: 21b then 21c (behz_pallas.py:406)."""
    return bsk_to_q(fast_floor(xq, xbsk, mb), mb)
