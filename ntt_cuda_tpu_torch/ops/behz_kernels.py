"""The BEHZ base-conversion kernels of EvalMult and their wrappers.

Counterpart of `ntt_cuda_tpu/ops/behz_pallas.py` (TPU kernels 21a-c):
`rns_to_bsk`, `fast_floor`, `bsk_to_q` and `scale_and_round` (21b and
21c in one launch).  On a CUDA device each wrapper launches csrc/behz.cu
(G = 1 or 2 threads a coefficient, by the launchers' rule); on the CPU it
runs the plain version, the ops/behz.py chain, with the same integers
out.

`MultBanks` holds both the plain version's `behz.MultConsts` and the
kernels' constant banks: native u64 (value, Shoup quotient) pairs, the
counterparts of `MultPallasConsts` (behz_pallas.py:104-166) without the
TPU's u32 limb pairs, each target's per-target multiplies folded into its
constants.  Layouts are in csrc/behz.cu.

The band forms `rns_to_bsk_rows`, `fast_floor_rows` and `bsk_to_q_rows`
(behz_pallas.py:431-489) compute target rows [row0, row0 + rl) alone from
every source row, for one rank of the RNS-sharded EvalMult
(parallel/spmd_mult.py): the same kernels with a band.  They take
`SpmdMultConsts`, the JAX package's padded constant banks of that program
(parallel/spmd_mult.py:55-166), on which their plain versions (the JAX
package's shard-local chains, spmd_mult.py:176-256) run, with the
kernels' MultBanks beside them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import cuda
from ..utils import hostmath as hm
from ..utils import tracing
from . import behz, modmath
from .behz import AuxBase, MultConsts
from .modmath import I64

# csrc/behz.cu BEHZ_*
RNS_TO_BSK, FAST_FLOOR, BSK_TO_Q, SCALE_AND_ROUND = range(4)
MAX_K = 16
GROUPS = (1, 2)   # the group sizes G of the kernels (the rule picks one)


def _wws(w: int, m: int) -> tuple[int, int]:
    """A constant mod m and its Shoup companion floor(w 2^64 / m)."""
    w %= m
    return w, hm.shoup(w, m)


def _red(m: int) -> tuple[int, int, int]:
    """The once-per-target reduction of an exact 128-bit linear form
    (csrc/behz.cu Lin): 2^64 mod m with its Shoup companion, and
    floor(2^64 / m)."""
    return _wws(1 << 64, m) + ((1 << 64) // m,)


@dataclasses.dataclass(frozen=True)
class MultBanks:
    """The conversion kernels' constants: every target of 21a-c one linear
    form sum_j x_j c_j + e c_e over the prescaled sources and one more
    input, its constants folding the plain chain's per-target multiplies
    (layouts in csrc/behz.cu)."""
    mc: MultConsts          # the plain version's constants
    qsrc: torch.Tensor      # (k, 6)
    tgt: torch.Tensor       # (k+1, 12)
    amat: torch.Tensor      # (3, k+1, k, 2): 21a, 21b, scale_and_round
    bsrc: torch.Tensor      # (k, 5)
    bmat: torch.Tensor      # (k, k, 2)
    bfin: torch.Tensor      # (k, 8)
    glob: torch.Tensor      # (8,)

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
        inv = hm.modinv
        # per Bsk target m_i: 1 / m_tilde, 1 / prod(q), and below k
        # 1 / (B/b_i) (scale_and_round's xp folded into its floor)
        mtinv = [inv(mt % m, m) for m in bsk]
        qinv = [inv(q_prod % m, m) for m in bsk]
        binv = [inv(pb % bj, bj) for pb, bj in zip(punct_b, aux.b)] + [0]
        pbinv = inv(b_prod % msk, msk)

        def bank(rows):
            return torch.tensor([[modmath.as_i64(v) for v in row]
                                 for row in rows], dtype=I64, device=device)

        forms = [[[c for pj in punct_q for c in _wws(f(pj, i), m)]
                  for i, m in enumerate(bsk)]
                 for f in (lambda pj, i: pj * mtinv[i],
                           lambda pj, i: -pj * qinv[i],
                           lambda pj, i: -pj * qinv[i] * binv[i])]
        return MultBanks(
            mc=MultConsts.build(params, aux, device),
            qsrc=bank([(qj,) + _wws(mt * inv(pj % qj, qj), qj)
                       + _wws(t * inv(pj % qj, qj), qj) + (pj % mt,)
                       for pj, qj in zip(punct_q, qs)]),
            tgt=bank([(m,) + _wws(q_prod * mtinv[i], m)
                      + _wws(t * qinv[i], m) + _wws(t * qinv[i] * binv[i], m)
                      + _red(m) + (0, 0) for i, m in enumerate(bsk)]),
            amat=bank([row for form in forms for row in form]).reshape(
                3, k + 1, k, 2),
            bsrc=bank([(bj,) + _wws(binv[j], bj) + _wws(pj * pbinv, msk)
                       for j, (pj, bj) in enumerate(zip(punct_b, aux.b))]),
            bmat=bank([[c for pj in punct_b for c in _wws(pj, qi)]
                       for qi in qs]).reshape(k, k, 2),
            bfin=bank([_wws(b_prod, qi) + _wws(-b_prod, qi) + _red(qi) + (0,)
                       for qi in qs]),
            glob=bank([(msk, msk >> 1) + _wws(-pbinv, msk) + _red(msk)
                       + ((-pow(q_prod, -1, mt)) % mt,)])[0],
        )


def _lead(name: str, x: torch.Tensor, rows: int) -> tuple:
    if x.dim() < 2 or x.shape[-2] != rows:
        raise ValueError(f"{name}: expected shape (..., {rows}, n), got "
                         f"{tuple(x.shape)}")
    return tuple(x.shape[:-2])


def _launch(which: int, x, xb, out, mb: MultBanks, row0: int = 0) -> None:
    """One conversion into out (..., rl, n), target rows [row0, row0 +
    rl), G by the launchers' rule."""
    n, rl = x.shape[-1], out.shape[-2]
    cuda.launch("ntt_behz", mb.device, which, x.data_ptr(),
                None if xb is None else xb.data_ptr(), out.data_ptr(),
                *mb.kernel_args(), out.numel() // (rl * n), mb.k, n, row0, rl,
                0)


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
    with tracing.launch("behz_kernels.rns_to_bsk"):
        dev = _kernel_device("rns_to_bsk", x, mb)
        cuda.require("x", x, I64, tuple(x.shape), dev)
        out = torch.empty(lead + (mb.k + 1, x.shape[-1]), dtype=I64,
                          device=dev)
        _launch(RNS_TO_BSK, x, None, out, mb)
    return out


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
    with tracing.launch("behz_kernels.fast_floor"):
        dev = _kernel_device("fast_floor", xq, mb)
        cuda.require("xq", xq, I64, tuple(xq.shape), dev)
        cuda.require("xbsk", xbsk, I64, tuple(xbsk.shape), dev)
        out = torch.empty_like(xbsk)
        _launch(FAST_FLOOR, xq, xbsk, out, mb)
    return out


# --- kernel 21c: Shenoy-Kumaresan Bsk -> q -----------------------------------

def bsk_to_q_plain(x, mb: MultBanks) -> torch.Tensor:
    return behz.bsk_to_q(x, mb.mc)


def bsk_to_q(x, mb: MultBanks) -> torch.Tensor:
    """(..., k+1, n) in Bsk -> (..., k, n) in q."""
    lead = _lead("x", x, mb.k + 1)
    if x.device.type == "cpu":
        return bsk_to_q_plain(x, mb)
    with tracing.launch("behz_kernels.bsk_to_q"):
        dev = _kernel_device("bsk_to_q", x, mb)
        cuda.require("x", x, I64, tuple(x.shape), dev)
        out = torch.empty(lead + (mb.k, x.shape[-1]), dtype=I64, device=dev)
        _launch(BSK_TO_Q, x, None, out, mb)
    return out


def scale_and_round_plain(xq, xbsk, mb: MultBanks) -> torch.Tensor:
    return behz.scale_and_round(xq, xbsk, mb.mc)


def scale_and_round(xq, xbsk, mb: MultBanks) -> torch.Tensor:
    """round(t x / q) in base q (behz_pallas.py:406, 21b then 21c): one
    launch, each coefficient's k+1 floors kept on chip and converted back
    to q, (..., k, n) and (..., k+1, n) -> (..., k, n)."""
    lead = _lead("xq", xq, mb.k)
    if _lead("xbsk", xbsk, mb.k + 1) != lead or xbsk.shape[-1] != xq.shape[-1]:
        raise ValueError(f"xbsk: shape {tuple(xbsk.shape)} does not match "
                         f"xq {tuple(xq.shape)}")
    if xq.device.type == "cpu":
        return scale_and_round_plain(xq, xbsk, mb)
    with tracing.launch("behz_kernels.scale_and_round"):
        dev = _kernel_device("scale_and_round", xq, mb)
        cuda.require("xq", xq, I64, tuple(xq.shape), dev)
        cuda.require("xbsk", xbsk, I64, tuple(xbsk.shape), dev)
        out = torch.empty_like(xq)
        _launch(SCALE_AND_ROUND, xq, xbsk, out, mb)
    return out


# --- the band forms, for one rank of the RNS-sharded EvalMult ---------------

_U64 = np.uint64


@dataclasses.dataclass(frozen=True)
class SpmdMultConsts:
    """The RNS-sharded EvalMult's replicated constant banks, field for
    field the JAX package's SpmdMultConsts (parallel/spmd_mult.py:55-94):
    every (r, ...) bank padded to r rows, the dropped modulus's row (base
    q) and m_sk's (as a B source) zeroed; int64 bit patterns on one device.
    `banks` is the conversion kernels' MultBanks."""

    banks: MultBanks
    # q side (row r-1, the dropped modulus, zeroed where padded)
    q_all: torch.Tensor               # (r, 1) every modulus, q_last too
    qinv_all: torch.Tensor            # (r, 1)
    nu_all: torch.Tensor              # (r, 1) floor(2^64 / q)
    mt_mont_q: torch.Tensor           # (r, 1), pad 0
    inv_punct_q_mont: torch.Tensor    # (r, 1), pad 0
    t_mont_q: torch.Tensor            # (r, 1), pad 0
    bcm_q_mt: torch.Tensor            # (r,), pad 0
    neg_inv_q_mt: torch.Tensor        # ()
    # Bsk side (r = k + 1 real rows)
    bsk_q_all: torch.Tensor           # (r, 1)
    bsk_qinv_all: torch.Tensor        # (r, 1)
    bcm_q_bsk_mont: torch.Tensor      # (r, r) [Bsk target, q source], pad 0
    prodq_mont_bsk: torch.Tensor      # (r, 1)
    inv_mt_mont_bsk: torch.Tensor     # (r, 1)
    t_mont_bsk: torch.Tensor          # (r, 1)
    inv_prodq_mont_bsk: torch.Tensor  # (r, 1)
    # Shenoy-Kumaresan B -> q
    inv_punct_b_mont: torch.Tensor    # (r, 1), row r-1 (m_sk) 0
    bcm_b_q_mont: torch.Tensor        # (r, r) [q target, B source], pads 0
    bcm_b_msk_mont: torch.Tensor      # (r,), pad 0
    inv_prodb_mont_msk: torch.Tensor  # ()
    prodb_mont_q: torch.Tensor        # (r, 1), pad 0
    msk: torch.Tensor                 # ()
    msk_qinv_neg: torch.Tensor        # ()
    msk_half: torch.Tensor            # ()
    # the key switch's modulus drop (P = q_last)
    p_mont_q: torch.Tensor            # (r, 1) P R mod q_i, pad 0
    half: torch.Tensor                # () floor(q_last / 2)
    half_mod: torch.Tensor            # (r, 1) half mod q_i, pad 0
    inv_qlast_mont: torch.Tensor      # (r, 1), pad 0

    @property
    def k(self) -> int:
        return self.banks.k

    @staticmethod
    def host_build(params, aux: AuxBase) -> dict[str, np.ndarray]:
        """Every bank as a numpy uint64 array of the JAX package's shape
        (its SpmdMultConsts.host_build, spmd_mult.py:106-166)."""
        k = params.r - 1
        qs, q_last, bsk, msk, mt = (params.q[:k], params.q[-1], aux.bsk,
                                    aux.m_sk, aux.m_tilde)
        q_prod, b_prod = behz.prod(qs), behz.prod(aux.b)
        punct_q = [q_prod // qj for qj in qs]
        punct_b = [b_prod // bj for bj in aux.b]
        mont, inv = hm.to_mont, hm.modinv

        def col(vals):
            return np.array(list(vals), dtype=_U64).reshape(-1, 1)

        def pad0(vals):
            return col(list(vals) + [0])

        return dict(
            q_all=col(params.q),
            qinv_all=col(hm.mont_qinv_neg(q) for q in params.q),
            nu_all=col((1 << 64) // q for q in params.q),
            mt_mont_q=pad0(mont(mt % qj, qj) for qj in qs),
            inv_punct_q_mont=pad0(mont(inv(pj % qj, qj), qj)
                                  for pj, qj in zip(punct_q, qs)),
            t_mont_q=pad0(mont(params.t % qj, qj) for qj in qs),
            bcm_q_mt=np.array([pj % mt for pj in punct_q] + [0], dtype=_U64),
            neg_inv_q_mt=np.array((-pow(q_prod, -1, mt)) % mt, dtype=_U64),
            bsk_q_all=col(bsk),
            bsk_qinv_all=col(hm.mont_qinv_neg(m) for m in bsk),
            bcm_q_bsk_mont=np.array([[mont(pj % m, m) for pj in punct_q] + [0]
                                     for m in bsk], dtype=_U64),
            prodq_mont_bsk=col(mont(q_prod % m, m) for m in bsk),
            inv_mt_mont_bsk=col(mont(inv(mt % m, m), m) for m in bsk),
            t_mont_bsk=col(mont(params.t % m, m) for m in bsk),
            inv_prodq_mont_bsk=col(mont(inv(q_prod % m, m), m) for m in bsk),
            inv_punct_b_mont=pad0(mont(inv(pj % bj, bj), bj)
                                  for pj, bj in zip(punct_b, aux.b)),
            bcm_b_q_mont=np.array([[mont(pj % qi, qi) for pj in punct_b] + [0]
                                   for qi in qs] + [[0] * (k + 1)],
                                  dtype=_U64),
            bcm_b_msk_mont=np.array([mont(pj % msk, msk) for pj in punct_b]
                                    + [0], dtype=_U64),
            inv_prodb_mont_msk=np.array(mont(inv(b_prod % msk, msk), msk),
                                        dtype=_U64),
            prodb_mont_q=pad0(mont(b_prod % qi, qi) for qi in qs),
            msk=np.array(msk, dtype=_U64),
            msk_qinv_neg=np.array(hm.mont_qinv_neg(msk), dtype=_U64),
            msk_half=np.array(msk >> 1, dtype=_U64),
            p_mont_q=pad0(mont(q_last % qj, qj) for qj in qs),
            half=np.array(params.half_last_modulus, dtype=_U64),
            half_mod=pad0(params.half_mod_q),
            inv_qlast_mont=pad0(mont(x, qi) for x, qi in
                                zip(params.inv_q_last_mod_q, qs)),
        )

    @staticmethod
    def build(params, aux: AuxBase | None = None,
              device=None) -> "SpmdMultConsts":
        aux = aux or AuxBase.build(params)
        banks = {name: torch.from_numpy(v.view(np.int64)).to(device)
                 for name, v in SpmdMultConsts.host_build(params,
                                                          aux).items()}
        return SpmdMultConsts(banks=MultBanks.build(params, aux, device),
                              **banks)


def _band_lead(name: str, x: torch.Tensor, rows: int, row0: int, rl: int,
               k: int) -> tuple:
    if not (0 <= row0 and 1 <= rl and row0 + rl <= k + 1):
        raise ValueError(f"{name}: target rows [{row0}, {row0 + rl}) outside "
                         f"[0, {k + 1})")
    return _lead(name, x, rows)


def _conv_band(zp, bcm, row0: int, rl: int, k: int, m, minv):
    """Target rows [row0, row0 + rl) of the inner products of the JAX
    package's _conv_local (spmd_mult.py:176-187): sources j < k ascending,
    add_mod."""
    bcm_b = bcm[row0:row0 + rl]
    out = None
    for j in range(k):
        term = modmath.mont_mul(zp[..., j:j + 1, :], bcm_b[:, j:j + 1], m,
                                minv)
        out = term if out is None else modmath.add_mod(out, term, m)
    return out


def _bsk_band(mc: SpmdMultConsts, row0: int, rl: int):
    sl = slice(row0, row0 + rl)
    return mc.bsk_q_all[sl], mc.bsk_qinv_all[sl], sl


# --- kernel 21a on a band ----------------------------------------------------

def rns_to_bsk_rows_plain(x, mc: SpmdMultConsts, row0: int,
                          rl: int) -> torch.Tensor:
    """The JAX package's _rns_to_bsk_shard after its all-gather
    (spmd_mult.py:189-214), on the k live rows of the gathered x."""
    k = mc.k
    bq, bqinv, sl = _bsk_band(mc, row0, rl)
    qq, qinv = mc.q_all[:k], mc.qinv_all[:k]
    z = modmath.mont_mul(x, mc.mt_mont_q[:k], qq, qinv)
    zp = modmath.mont_mul(z, mc.inv_punct_q_mont[:k], qq, qinv)
    y = _conv_band(zp, mc.bcm_q_bsk_mont, row0, rl, k, bq, bqinv)
    ymt = torch.zeros(zp.shape[:-2] + zp.shape[-1:], dtype=I64,
                      device=zp.device)
    for j in range(k):
        ymt = ymt + zp[..., j, :] * mc.bcm_q_mt[j]
    rb = (((ymt & behz.M32) * mc.neg_inv_q_mt) & behz.M32)[..., None, :]
    temp = torch.where(rb >= behz.M_TILDE // 2, rb + (bq - behz.M_TILDE), rb)
    corr = modmath.mont_mul(temp, mc.prodq_mont_bsk[sl], bq, bqinv)
    s = modmath.add_mod(y, corr, bq)
    return modmath.mont_mul(s, mc.inv_mt_mont_bsk[sl], bq, bqinv)


def rns_to_bsk_rows(x, mc: SpmdMultConsts, row0: int,
                    rl: int) -> torch.Tensor:
    """(..., k, n) base-q residues -> rows [row0, row0 + rl) of
    rns_to_bsk's (..., k+1, n)."""
    lead = _band_lead("x", x, mc.k, row0, rl, mc.k)
    if x.device.type == "cpu":
        return rns_to_bsk_rows_plain(x, mc, row0, rl)
    with tracing.launch("behz_kernels.rns_to_bsk_rows"):
        mb = mc.banks
        dev = _kernel_device("rns_to_bsk_rows", x, mb)
        cuda.require("x", x, I64, tuple(x.shape), dev)
        out = torch.empty(lead + (rl, x.shape[-1]), dtype=I64, device=dev)
        _launch(RNS_TO_BSK, x, None, out, mb, row0)
    return out


# --- kernel 21b on a band ----------------------------------------------------

def fast_floor_rows_plain(xq, xb, mc: SpmdMultConsts, row0: int,
                          rl: int) -> torch.Tensor:
    """The JAX package's _fast_floor_shard after its all-gather
    (spmd_mult.py:216-232), on the k live rows of the gathered xq."""
    k = mc.k
    bq, bqinv, sl = _bsk_band(mc, row0, rl)
    qq, qinv = mc.q_all[:k], mc.qinv_all[:k]
    yq = modmath.mont_mul(xq, mc.t_mont_q[:k], qq, qinv)
    zp = modmath.mont_mul(yq, mc.inv_punct_q_mont[:k], qq, qinv)
    conv = _conv_band(zp, mc.bcm_q_bsk_mont, row0, rl, k, bq, bqinv)
    yb = modmath.mont_mul(xb, mc.t_mont_bsk[sl], bq, bqinv)
    diff = modmath.sub_mod(yb, conv, bq)
    return modmath.mont_mul(diff, mc.inv_prodq_mont_bsk[sl], bq, bqinv)


def fast_floor_rows(xq, xb, mc: SpmdMultConsts, row0: int,
                    rl: int) -> torch.Tensor:
    """(..., k, n) base-q and the band's own (..., rl, n) Bsk rows of the
    same value -> rows [row0, row0 + rl) of fast_floor."""
    lead = _band_lead("xq", xq, mc.k, row0, rl, mc.k)
    if _lead("xb", xb, rl) != lead or xb.shape[-1] != xq.shape[-1]:
        raise ValueError(f"xb: shape {tuple(xb.shape)} does not match xq "
                         f"{tuple(xq.shape)} over {rl} rows")
    if xq.device.type == "cpu":
        return fast_floor_rows_plain(xq, xb, mc, row0, rl)
    with tracing.launch("behz_kernels.fast_floor_rows"):
        mb = mc.banks
        dev = _kernel_device("fast_floor_rows", xq, mb)
        cuda.require("xq", xq, I64, tuple(xq.shape), dev)
        cuda.require("xb", xb, I64, tuple(xb.shape), dev)
        out = torch.empty_like(xb)
        _launch(FAST_FLOOR, xq, xb, out, mb, row0)
    return out


# --- kernel 21c on a band ----------------------------------------------------

def bsk_to_q_rows_plain(x, mc: SpmdMultConsts, row0: int,
                        rl: int) -> torch.Tensor:
    """The JAX package's _bsk_to_q_shard after its all-gather
    (spmd_mult.py:234-256): the padded q rows, pad target r-1 0."""
    k = mc.k
    sl = slice(row0, row0 + rl)
    q, qinv = mc.q_all[sl], mc.qinv_all[sl]
    xp = modmath.mont_mul(x, mc.inv_punct_b_mont, mc.bsk_q_all,
                          mc.bsk_qinv_all)               # m_sk row -> 0
    cq = _conv_band(xp, mc.bcm_b_q_mont, row0, rl, k, q, qinv)
    cm = None
    for j in range(k):
        term = modmath.mont_mul(xp[..., j, :], mc.bcm_b_msk_mont[j], mc.msk,
                                mc.msk_qinv_neg)
        cm = term if cm is None else modmath.add_mod(cm, term, mc.msk)
    alpha = modmath.mont_mul(modmath.sub_mod(cm, x[..., k, :], mc.msk),
                             mc.inv_prodb_mont_msk, mc.msk, mc.msk_qinv_neg)
    neg = alpha > mc.msk_half
    mag = torch.where(neg, mc.msk - alpha, alpha)[..., None, :]
    corr = modmath.mont_mul(mag, mc.prodb_mont_q[sl], q, qinv)
    return torch.where(neg[..., None, :], modmath.add_mod(cq, corr, q),
                       modmath.sub_mod(cq, corr, q))


def bsk_to_q_rows(x, mc: SpmdMultConsts, row0: int,
                  rl: int) -> torch.Tensor:
    """(..., k+1, n) in Bsk -> rows [row0, row0 + rl) of bsk_to_q's output
    in the padded (..., k+1, n) layout, row k (the dropped modulus's
    slot) 0."""
    lead = _band_lead("x", x, mc.k + 1, row0, rl, mc.k)
    if x.device.type == "cpu":
        return bsk_to_q_rows_plain(x, mc, row0, rl)
    with tracing.launch("behz_kernels.bsk_to_q_rows"):
        mb = mc.banks
        dev = _kernel_device("bsk_to_q_rows", x, mb)
        cuda.require("x", x, I64, tuple(x.shape), dev)
        out = torch.empty(lead + (rl, x.shape[-1]), dtype=I64, device=dev)
        _launch(BSK_TO_Q, x, None, out, mb, row0)
    return out
