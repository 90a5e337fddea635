"""Decryption tail and the tail constants of encryption.

Counterpart of `ntt_cuda_tpu/ops/bfv_tail.py` for the main path:

* `decrypt_tail`: (x +> c0) * t*gamma * inv_punctured mod q_i, the BEHZ
  fast conversion to {t, gamma} and dec_round.  On a CUDA device it
  launches csrc/decrypt_tail.cu; on the CPU it runs `decrypt_tail_plain`,
  the ops/poly.py chain (poly_add -> two scalar Montgomery multiplies ->
  fast_convert_and_round).
* `TailConsts`: the per-modulus constants of encryption's tail (modulus
  drop and Delta*m + fix), read by the encrypt kernel in ops/fused_ops.py.
* `DecTailConsts` and `_t_strategy`: the decrypt kernel's constants and
  its static mod-t strategy (pow2 masks, or Barrett-by-t for odd t < 2^31).

Constants are int64 bit-pattern tensors on the context's device, rows of
u64 words in the order the kernels read them.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import cuda
from ..utils import hostmath as hm
from . import modmath, poly
from .modmath import I64, ModulusSet


def _fix_threshold(t: int) -> int:
    """weird_m_stuff's fix = floor((m + (t+1)//2) / t) for m in [0, t) is
    exactly [m >= t - (t+1)//2]: one compare, valid for any t."""
    if not 1 < t < (1 << 32):
        raise ValueError(f"plaintext modulus {t} must fit u32")
    return t - ((t + 1) >> 1)


def _rows(rows, device) -> torch.Tensor:
    return torch.tensor([[modmath.as_i64(v) for v in row] for row in rows],
                        dtype=I64, device=device)


@dataclasses.dataclass(frozen=True)
class TailConsts:
    per_mod: torch.Tensor  # (r-1, 6): q, -q^-1, nu, half_mod,
    #                        inv_q_last (Montgomery form), q_i // t
    q_last: int
    half: int              # floor(q_last / 2)
    fix_th: int            # message-fix compare threshold (_fix_threshold)
    dr: poly.DivideRoundConsts  # the same constants for the plain chain
    msg: poly.MessageConsts
    ms_drop: ModulusSet         # the r-1 kept moduli
    ms_last: ModulusSet         # the dropped modulus

    @staticmethod
    def build(params, device=None) -> "TailConsts":
        rows = [(q, hm.mont_qinv_neg(q), (1 << 64) // q, params.half_mod_q[i],
                 hm.to_mont(params.inv_q_last_mod_q[i], q), params.qi_div_t[i])
                for i, q in enumerate(params.q[:-1])]
        return TailConsts(
            per_mod=_rows(rows, device), q_last=params.q[-1],
            half=params.half_last_modulus, fix_th=_fix_threshold(params.t),
            dr=poly.DivideRoundConsts.build(params, device),
            msg=poly.MessageConsts.build(params, device),
            ms_drop=modmath.modulus_set(params, params.r - 1, device),
            ms_last=ModulusSet.from_moduli(params.q[-1:], device))


@dataclasses.dataclass(frozen=True)
class DecTailConsts:
    per_mod: torch.Tensor  # (r-1, 6): q, -q^-1, prod_t_gamma (Mont),
    #                        inv_punctured (Mont), bcm_t, bcm_g (Mont(gamma))
    glob: torch.Tensor     # (4,): gamma, -gamma^-1, gamma // 2, neg_g (Mont)
    dec: poly.DecryptConsts  # the same constants for the plain chain
    ms: ModulusSet           # the r-1 kept moduli
    t: int
    neg_t: int
    nu_t: int              # floor(2^64 / t), odd t only (0 for pow2)
    inv_gt: int            # (gamma mod t)^-1 mod t, odd t only (0 for pow2)

    @property
    def tmeta(self) -> tuple:
        return (self.t, self.neg_t, self.nu_t, self.inv_gt)

    @staticmethod
    def build(params, device=None) -> "DecTailConsts":
        qs = params.q[:-1]
        g, t = params.gamma, params.t
        bcm_t, bcm_g = params.base_change_matrix
        neg_t, neg_g = params.neg_inv_q_mod_t_gamma
        if t & (t - 1) == 0:
            nu_t = inv_gt = 0
        elif t % 2 == 1 and t < (1 << 31):
            nu_t, inv_gt = (1 << 64) // t, pow(g % t, -1, t)
        else:
            raise ValueError(f"decrypt tail needs a power-of-two t or an odd "
                             f"t < 2^31, got {t}")
        rows = [(q, hm.mont_qinv_neg(q),
                 hm.to_mont(params.prod_t_gamma_mod_q[i], q),
                 hm.to_mont(params.inv_punctured_q[i], q),
                 bcm_t[i], hm.to_mont(bcm_g[i], g))
                for i, q in enumerate(qs)]
        glob = (g, hm.mont_qinv_neg(g), params.gamma_div_2,
                hm.to_mont(neg_g, g))
        return DecTailConsts(
            per_mod=_rows(rows, device), glob=_rows([glob], device)[0],
            dec=poly.DecryptConsts.build(params, device),
            ms=modmath.ModulusSet.from_moduli(qs, device),
            t=t, neg_t=neg_t, nu_t=nu_t, inv_gt=inv_gt)


def _t_strategy(tmeta: tuple) -> tuple[int, int, int, int, int]:
    """The decrypt kernel's static mod-t strategy from DecTailConsts.tmeta
    = (t, neg_t, nu_t, inv_gt), as its (pow2, t, neg_t, nu_t, inv_gt)
    arguments.

    pow2 t: the reference's mask forms, bit for bit
    (poly_arithmetic.cuh:217-268; t | 2^64 makes masked wrapping sums
    exact mod t).  Odd t < 2^31 (batching primes): Barrett-by-t with
    nu_t = floor(2^64/t), every x_t value kept < t, and a final multiply
    by (gamma mod t)^-1 (the reference skips it because its gamma === 1
    mod 1024)."""
    t, neg_t, nu_t, inv_gt = tmeta
    if t & (t - 1) == 0:
        return (1, t, neg_t, 0, 0)
    return (0, t, neg_t, nu_t, inv_gt)


def decrypt_tail_plain(x, ct0, consts: DecTailConsts) -> torch.Tensor:
    """poly_add (strict `>`) -> * t*gamma -> * inv_punctured ->
    fast_convert_and_round: (..., r-1, n) x2 -> (..., n)."""
    dc, ms = consts.dec, consts.ms
    y = poly.poly_add(x, ct0, ms)
    y = poly.poly_mul_scalar_mont(y, dc.prod_t_gamma_mont, ms)
    y = poly.poly_mul_scalar_mont(y, dc.inv_punctured_mont, ms)
    return poly.fast_convert_and_round(y, dc)


def decrypt_tail(x, ct0, consts: DecTailConsts) -> torch.Tensor:
    """(r-1, n) x = INTT(NTT(c1) (.) sk), (r-1, n) c0 -> (n,) plaintext; a
    leading J batch dim on both decrypts J messages ((J, r-1, n) ->
    (J, n)).  The kernel on a CUDA device, the plain chain on the CPU."""
    if x.device.type == "cpu":
        return decrypt_tail_plain(x, ct0, consts)
    if x.device.type != "cuda":
        raise ValueError(f"decrypt_tail: no kernel for {x.device}")
    single = x.dim() == 2
    J = 1 if single else x.shape[0]
    rk, n = x.shape[-2:]
    for name, tns in (("x", x), ("ct0", ct0)):
        cuda.require(name, tns, I64, tuple(x.shape), consts.per_mod.device)
    out = torch.empty((J, n), dtype=I64, device=x.device)
    pow2, t, neg_t, nu_t, inv_gt = _t_strategy(consts.tmeta)
    cuda.launch("ntt_decrypt_tail", x.device, x.data_ptr(), ct0.data_ptr(),
                out.data_ptr(), consts.per_mod.data_ptr(),
                consts.glob.data_ptr(), J, rk, n, pow2, t, neg_t, nu_t,
                inv_gt)
    decrypt_tail.launches += 1
    return out[0] if single else out


decrypt_tail.launches = 0
