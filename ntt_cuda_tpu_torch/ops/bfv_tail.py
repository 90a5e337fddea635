"""Decryption tail and the tail constants of encryption.

Counterpart of `ntt_cuda_tpu/ops/bfv_tail.py` for the main path:

* `decrypt_tail`: (x +> c0) * t*gamma * inv_punctured mod q_i, the BEHZ
  fast conversion to {t, gamma} and dec_round.  On a CUDA device it
  launches csrc/decrypt_tail.cu; on the CPU it runs `decrypt_tail_plain`,
  the ops/poly.py chain (poly_add -> two scalar Montgomery multiplies ->
  fast_convert_and_round).
* `encrypt_fused`: the stage schedule's encryption after NTT(u):
  c_h = INTT(u_ntt (.) pk_h) +> e_h, the modulus drop and Delta*m + fix.
  On a CUDA device: the inverse kernel of csrc/ntt_stage.cu into a
  (2, r, n) scratch, then csrc/fused_ops.cu's encrypt tail; on the CPU
  `encrypt_fused_plain`, which the op schedule's plain encrypt shares.
* `encrypt_tail` (kernel 14): c + e per residue, the modulus drop and
  Delta*m + fix, from c (2, r, n) after the inverse and e (2, r, n); K5's
  tail launch (csrc/fused_ops.cu ntt_encrypt_tail_e) on the card,
  `encrypt_tail_plain` on the CPU.
* `decrypt_fused` (kernel 15): the decrypt back half, INTT(x (.) sk) and
  the decrypt tail, in one cooperative launch (csrc/ntt_stage.cu
  k_decrypt_fused); `decrypt_fused_plain` on the CPU.  BFVContext.decrypt
  keeps its two launches (as the JAX context does).
* `TailConsts`: the per-modulus constants of encryption's tail (modulus
  drop and Delta*m + fix); the encrypt tail kernel reads their
  `tail_rows` (Shoup pairs, `tail_rows`).
* `DecTailConsts` and `_t_strategy`: the decrypt kernel's constants and
  its static mod-t strategy (pow2 masks, Barrett-by-t for odd t < 2^31,
  or Montgomery products mod t for an odd t from 2^31 to T_MAX).
* The RNS-sharded program's tails (parallel/spmd.py), one rank's rows of
  the padded (2, r, n) layout: `encrypt_tail_padded` (kernel 16, K5's tail
  launch with e added and ra from its own all-reduced input),
  `drop_last_padded` (kernel 16's launch with no e and no message: the
  sharded key switch's modulus drop, parallel/spmd_mult.py) and
  `decrypt_tail_partial` (kernel 17, K2's kernel stopped at the BEHZ
  sums), each with its `_plain` version and padded constants, and the
  plain tensor steps around the all-reduce: `psum_behz_partials`,
  `combine_gamma_halves`, `dec_round_from_sums`.

Constants are int64 bit-pattern tensors on the context's device, rows of
u64 words in the order the kernels read them.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import cuda
from ..utils import hostmath as hm
from ..utils import tracing
from . import modmath, ntt, ntt_stage, poly, sampling
from .modmath import I64, ModulusSet
from .ntt import NTTTables


# The largest plaintext modulus the port takes, exclusive: every u64 it
# carries lives in an int64 below 2^62 (ops/modmath.py), and no modulus
# below 2^62 is === 1 mod a t >= 2^62, as encryption's Delta embedding
# assumes (the JAX package's ops/poly.py add_message).
T_MAX = 1 << 62
# From here an odd t takes the decrypt kernels' wide strategy: a product of
# two residues below t no longer fits 64 bits.
T_WIDE = 1 << 31


def _fix_threshold(t: int) -> int:
    """weird_m_stuff's fix = floor((m + (t+1)//2) / t) for m in [0, t) is
    exactly [m >= t - (t+1)//2]: one compare, valid for any t."""
    if not 1 < t < T_MAX:
        raise ValueError(f"plaintext modulus {t} must lie below 2^62")
    return t - ((t + 1) >> 1)


def _rows(rows, device) -> torch.Tensor:
    return torch.tensor([[modmath.as_i64(v) for v in row] for row in rows],
                        dtype=I64, device=device)


def tail_rows(per_mod: torch.Tensor) -> torch.Tensor:
    """The encrypt tail kernel's rows from a per_mod table (q, -q^-1, nu,
    half_mod, inv_q_last (Montgomery form), q_i // t), on its device: q,
    nu, half_mod, inv_q_last and q_i // t each as a Shoup pair (w,
    floor(w 2^64 / q)), 0 (csrc/fused_ops.cu EncryptTail)."""
    rows = []
    for q, _, nu, half_mod, invq, qdt in (
            [v & hm.MASK64 for v in row] for row in per_mod.tolist()):
        w = invq * pow(1 << 64, -1, q) % q
        rows.append((q, nu, half_mod, w, hm.shoup(w, q), qdt,
                     hm.shoup(qdt, q), 0))
    return _rows(rows, per_mod.device)


@dataclasses.dataclass(frozen=True)
class TailConsts:
    per_mod: torch.Tensor  # (r-1, 6): q, -q^-1, nu, half_mod,
    #                        inv_q_last (Montgomery form), q_i // t
    tail_rows: torch.Tensor  # (r-1, 8): the kernel's rows (tail_rows)
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
        per_mod = _rows(rows, device)
        return TailConsts(
            per_mod=per_mod, tail_rows=tail_rows(per_mod), q_last=params.q[-1],
            half=params.half_last_modulus, fix_th=_fix_threshold(params.t),
            dr=poly.DivideRoundConsts.build(params, device),
            msg=poly.MessageConsts.build(params, device),
            ms_drop=modmath.modulus_set(params, params.r - 1, device),
            ms_last=ModulusSet.from_moduli(params.q[-1:], device))


@dataclasses.dataclass(frozen=True)
class DecTailConsts:
    per_mod: torch.Tensor  # (r-1, 6): q, -q^-1, prod_t_gamma (Mont),
    #                        inv_punctured (Mont), bcm_t, bcm_g (Mont(gamma))
    k2_rows: torch.Tensor  # (r-1, 6): K2's q, prod_t_gamma * inv_punctured
    #                        (w, ws), bcm_t, bcm_g mod gamma (w, ws)
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
        nu_t, inv_gt = _t_fields(params)
        return DecTailConsts(
            per_mod=_dec_rows(params, 0, len(qs), device),
            k2_rows=_k2_rows(params, 0, len(qs), device),
            glob=_dec_glob(params, device),
            dec=poly.DecryptConsts.build(params, device),
            ms=modmath.ModulusSet.from_moduli(qs, device),
            t=params.t, neg_t=params.neg_inv_q_mod_t_gamma[0], nu_t=nu_t,
            inv_gt=inv_gt)


def _t_fields(params) -> tuple[int, int]:
    """(nu_t, inv_gt) of the decrypt kernels' mod-t strategy: 0, 0 for a
    power-of-two t; floor(2^64 / t) and (gamma mod t)^-1 for an odd
    t < T_MAX."""
    g, t = params.gamma, params.t
    if t & (t - 1) == 0:
        return 0, 0
    if t % 2 == 1 and t < T_MAX:
        return (1 << 64) // t, pow(g % t, -1, t)
    raise ValueError(f"decrypt tail needs a power-of-two t or an odd "
                     f"t < 2^62, got {t}")


def _t_mode(t: int) -> int:
    """The decrypt kernels' mod-t strategy, their `pow2` argument: 1 for a
    power-of-two t (masks), 0 for an odd t < 2^31 (Barrett by t), 2 for a
    wider odd t (Montgomery products mod t, csrc/behz_sums.cuh)."""
    if t & (t - 1) == 0:
        return 1
    return 2 if t >= T_WIDE else 0



def _dec_rows(params, lo: int, hi: int, device,
              pad_to: int | None = None) -> torch.Tensor:
    """DecTailConsts.per_mod rows of moduli [lo, hi): the dropped (global
    last) modulus's row keeps q and -q^-1 with its four BEHZ constants 0,
    so it adds nothing to the sums; rows up to pad_to - lo beyond hi - lo
    are pad rows, q = 1 and all else 0 (well defined, adding nothing)."""
    g = params.gamma
    bcm_t, bcm_g = params.base_change_matrix
    rows = []
    for i in range(lo, hi):
        q = params.q[i]
        kept = i < params.r - 1
        rows.append((q, hm.mont_qinv_neg(q))
                    + ((hm.to_mont(params.prod_t_gamma_mod_q[i], q),
                        hm.to_mont(params.inv_punctured_q[i], q),
                        bcm_t[i], hm.to_mont(bcm_g[i], g)) if kept
                       else (0, 0, 0, 0)))
    for _ in range(len(rows), (pad_to or 0) - lo):
        rows.append((1, hm.mont_qinv_neg(1), 0, 0, 0, 0))
    return _rows(rows, device)


def _k2_rows(params, lo: int, hi: int, device,
             pad_to: int | None = None) -> torch.Tensor:
    """K2's rows (DecTailConsts.k2_rows) of moduli [lo, hi): q, t*gamma *
    inv_punctured mod q and bcm_gamma mod gamma as Shoup pairs, bcm_t
    (times 2^64 mod t for the wide strategy's Montgomery products).  As
    in _dec_rows, the dropped modulus's row keeps q with every constant 0
    and rows up to pad_to - lo are pad rows, q = 1 and all else 0: a Shoup
    product by 0 is 0 whatever its operand and modulus, so neither adds
    to the sums."""
    g, t = params.gamma, params.t
    bcm_t, bcm_g = params.base_change_matrix
    if _t_mode(t) == 2:
        bcm_t = [hm.to_mont(v, t) for v in bcm_t]
    rows = []
    for i in range(lo, hi):
        q = params.q[i]
        if i < params.r - 1:
            w = params.prod_t_gamma_mod_q[i] * params.inv_punctured_q[i] % q
            rows.append((q, w, hm.shoup(w, q), bcm_t[i], bcm_g[i] % g,
                         hm.shoup(bcm_g[i] % g, g)))
        else:
            rows.append((q, 0, 0, 0, 0, 0))
    for _ in range(len(rows), (pad_to or 0) - lo):
        rows.append((1, 0, 0, 0, 0, 0))
    return _rows(rows, device)


def _dec_glob(params, device) -> torch.Tensor:
    g = params.gamma
    return _rows([(g, hm.mont_qinv_neg(g), params.gamma_div_2,
                   hm.to_mont(params.neg_inv_q_mod_t_gamma[1], g))],
                 device)[0]


def _t_strategy(tmeta: tuple) -> tuple[int, int, int, int, int]:
    """The decrypt kernel's static mod-t strategy from DecTailConsts.tmeta
    = (t, neg_t, nu_t, inv_gt), as its (pow2, t, neg_t, nu_t, inv_gt)
    arguments (pow2: _t_mode).

    pow2 t: the reference's mask forms, bit for bit
    (poly_arithmetic.cuh:217-268; t | 2^64 makes masked wrapping sums
    exact mod t).  Odd t < 2^31 (batching primes): Barrett-by-t with
    nu_t = floor(2^64/t), every x_t value kept < t, and a final multiply
    by (gamma mod t)^-1 (the reference skips it because its gamma === 1
    mod 1024).  Odd t >= 2^31: the same steps as Montgomery products mod
    t (the JAX package's xla tail, ops/poly.py fast_convert_and_round),
    neg_t and (gamma mod t)^-1 passed times 2^64 mod t."""
    t, neg_t, nu_t, inv_gt = tmeta
    mode = _t_mode(t)
    if mode == 1:
        return (1, t, neg_t, 0, 0)
    if mode == 2:
        return (2, t, hm.to_mont(neg_t, t), nu_t, hm.to_mont(inv_gt, t))
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
    with tracing.launch("bfv_tail.decrypt_tail"):
        single = x.dim() == 2
        J = 1 if single else x.shape[0]
        rk, n = x.shape[-2:]
        for name, tns in (("x", x), ("ct0", ct0)):
            cuda.require(name, tns, I64, tuple(x.shape), consts.per_mod.device)
        out = torch.empty((J, n), dtype=I64, device=x.device)
        pow2, t, neg_t, nu_t, inv_gt = _t_strategy(consts.tmeta)
        cuda.launch("ntt_decrypt_tail", x.device, x.data_ptr(), ct0.data_ptr(),
                    out.data_ptr(), consts.k2_rows.data_ptr(),
                    consts.glob.data_ptr(), J, rk, n, pow2, t, neg_t, nu_t,
                    inv_gt)
    return out[0] if single else out


def encrypt_fused_plain(u_ntt, pk, e_d, m_poly, tables: NTTTables,
                        consts: TailConsts) -> torch.Tensor:
    """c_h = INTT(u_ntt (.) pk_h) +> e_h, the modulus drop, then
    c0 += Delta*m + fix.  (..., r, n), (2, r, n), (..., 2, n), (..., n) ->
    (..., 2, r-1, n)."""
    ms = tables.ms
    c = ntt.ntt_inverse(ntt.dyadic_mul(u_ntt[..., None, :, :], pk, ms), tables)
    c = poly.poly_add(c, sampling.small_res(e_d, ms.q), ms)
    c = poly.divide_and_round_q_last(c, consts.dr, consts.ms_drop,
                                     consts.ms_last)
    c0 = poly.add_message(c[..., 0, :, :], m_poly, consts.msg)
    return torch.stack([c0, c[..., 1, :, :]], dim=-3)


def encrypt_fused(u_ntt, pk, e_d, m_poly, tables: NTTTables,
                  consts: TailConsts) -> torch.Tensor:
    """One message: u_ntt (r, n) = NTT(u), pk (2, r, n) NTT domain, e_d
    (2, n) compact int32 Gaussian, m_poly (n,) int64 in [0, t) -> the
    (2, r-1, n) ciphertext."""
    r, n = tables.r, tables.n
    for name, t, shape in (("u_ntt", u_ntt, (r, n)), ("pk", pk, (2, r, n)),
                           ("e_d", e_d, (2, n)), ("m_poly", m_poly, (n,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
    if pk.device.type == "cpu":
        return encrypt_fused_plain(u_ntt, pk, e_d, m_poly, tables, consts)
    with tracing.launch("bfv_tail.encrypt_fused"):
        dev = cuda.kernel_device("encrypt_fused", pk, tables,
                                 cuda.TRANSFORM_MAX_N)
        cuda.require("u_ntt", u_ntt, I64, (r, n), dev)
        cuda.require("pk", pk, I64, (2, r, n), dev)
        cuda.require("e_d", e_d, torch.int32, (2, n), dev)
        cuda.require("m_poly", m_poly, I64, (n,), dev)
        scratch = torch.empty((2, r, n), dtype=I64, device=dev)
        ct = torch.empty((2, r - 1, n), dtype=I64, device=dev)
        ntt_stage.inverse_launch(dev, pk, u_ntt, e_d, scratch, tables)
        cuda.launch("ntt_encrypt_tail", dev, scratch.data_ptr(),
                    m_poly.data_ptr(), ct.data_ptr(),
                    consts.tail_rows.data_ptr(), consts.q_last, consts.half,
                    consts.fix_th, 1, r, n)
    return ct


# --- kernel 14: the encrypt tail from c and e -------------------------------

def encrypt_tail_plain(c, e, m_poly, consts: TailConsts) -> torch.Tensor:
    """poly_add, divide_and_round_q_last, add_message (the JAX docstring's
    equivalent): (2, r, n) x2, (n,) -> (2, r-1, n)."""
    q = torch.cat([consts.ms_drop.q, consts.ms_last.q])
    s = modmath.add_mod_lazy_gt(c, e, q)                  # poly_add
    s = poly.divide_and_round_q_last(s, consts.dr, consts.ms_drop,
                                     consts.ms_last)
    return torch.stack([poly.add_message(s[0], m_poly, consts.msg), s[1]])


def encrypt_tail(c, e, m_poly, consts: TailConsts) -> torch.Tensor:
    """Kernel 14 (the JAX package's bfv_tail.encrypt_tail): c (2, r, n)
    after the inverse transform, e (2, r, n) canonical residues, m_poly
    (n,) in [0, t) -> the (2, r-1, n) ciphertext, ra taken from the last
    residue of c +> e.  One launch."""
    r = consts.per_mod.shape[0] + 1
    n = m_poly.shape[-1]
    for name, t, shape in (("c", c, (2, r, n)), ("e", e, (2, r, n)),
                           ("m_poly", m_poly, (n,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
    if c.device.type == "cpu":
        return encrypt_tail_plain(c, e, m_poly, consts)
    if c.device.type != "cuda":
        raise ValueError(f"encrypt_tail: no kernel for {c.device}")
    with tracing.launch("bfv_tail.encrypt_tail"):
        dev = consts.per_mod.device
        for name, t in (("c", c), ("e", e), ("m_poly", m_poly)):
            cuda.require(name, t, I64, tuple(t.shape), dev)
        ct = torch.empty((2, r - 1, n), dtype=I64, device=dev)
        cuda.launch("ntt_encrypt_tail_e", dev, c.data_ptr(), e.data_ptr(),
                    m_poly.data_ptr(), ct.data_ptr(),
                    consts.tail_rows.data_ptr(), consts.q_last, consts.half,
                    consts.fix_th, r, n)
    return ct


# --- kernel 15: INTT(x (.) sk) and the decrypt tail in one launch ------------

def decrypt_fused_plain(x_ntt, sk, ct0, tables: NTTTables,
                        consts: DecTailConsts) -> torch.Tensor:
    """ntt_inverse_mul's plain version, then decrypt_tail_plain."""
    return decrypt_tail_plain(ntt_stage.ntt_inverse_mul_plain(x_ntt, sk,
                                                              tables),
                              ct0, consts)


def decrypt_fused(x_ntt, sk, ct0, tables: NTTTables, consts: DecTailConsts,
                  *, cluster: int = 0) -> torch.Tensor:
    """Kernel 15 (the JAX package's bfv_tail.decrypt_fused): x_ntt (r-1, n)
    = NTT(c1), sk (r-1, n) NTT domain, ct0 (r-1, n) -> the (n,) plaintext,
    over the r-1 kept moduli's tables.  On the card: one cooperative launch,
    one thread-block cluster of `cluster` blocks per residue (0: the
    launchers' rule, ntt_stage.cluster_size; a B whose n/B buffer does not
    fit a block, or whose r-1 clusters the card cannot hold at once,
    raises), the tail after a grid barrier; the wrapper allocates its
    (r-1, n) scratch."""
    rk, n = tables.r, tables.n
    for name, t in (("x_ntt", x_ntt), ("sk", sk), ("ct0", ct0)):
        if tuple(t.shape) != (rk, n):
            raise ValueError(f"{name}: expected shape {(rk, n)}, got "
                             f"{tuple(t.shape)}")
    if consts.per_mod.shape[0] != rk:
        raise ValueError(f"consts for {consts.per_mod.shape[0]} moduli, "
                         f"tables for {rk}")
    if x_ntt.device.type == "cpu":
        return decrypt_fused_plain(x_ntt, sk, ct0, tables, consts)
    with tracing.launch("bfv_tail.decrypt_fused"):
        dev = cuda.kernel_device("decrypt_fused", x_ntt, tables,
                                 cuda.TRANSFORM_MAX_N)
        for name, t in (("x_ntt", x_ntt), ("sk", sk), ("ct0", ct0)):
            cuda.require(name, t, I64, (rk, n), dev)
        scratch = torch.empty((rk, n), dtype=I64, device=dev)
        out = torch.empty((n,), dtype=I64, device=dev)
        pow2, t, neg_t, nu_t, inv_gt = _t_strategy(consts.tmeta)
        cuda.launch("ntt_decrypt_fused", dev, x_ntt.data_ptr(), sk.data_ptr(),
                    ct0.data_ptr(), scratch.data_ptr(), out.data_ptr(),
                    *tables.kernel_args(), consts.k2_rows.data_ptr(),
                    consts.glob.data_ptr(), rk, tables.logn, pow2, t, neg_t,
                    nu_t, inv_gt, cluster)
    return out


# --- the RNS-sharded program's tails: one rank's rows [lo, hi) of the padded
# (2, r, n) layout, their cross-rank inputs and outputs explicit so that the
# collectives live in parallel/spmd.py ------------------------------------

def _cols(per_mod: torch.Tensor) -> list[torch.Tensor]:
    """The (rows, 1) columns of a per-modulus constant table."""
    return [per_mod[:, j:j + 1] for j in range(per_mod.shape[1])]


@dataclasses.dataclass(frozen=True)
class PaddedTailConsts:
    """encrypt_tail_padded's constants for one rank's rows: per_mod as
    TailConsts.per_mod (q, -q^-1, nu, half_mod, inv_q_last (Montgomery
    form), q_i // t), the dropped modulus's own row, where the rank holds
    it, with half_mod 0, inv_q_last 1 and q_i // t 0, and the kernel's
    rows from it (tail_rows).  There is no half: the caller folds it into
    ra."""

    per_mod: torch.Tensor    # (hi - lo, 6)
    tail_rows: torch.Tensor  # (hi - lo, 8)
    q_last: int
    fix_th: int


def build_tail_consts_padded(params, lo: int, hi: int,
                             device=None) -> PaddedTailConsts:
    """Rows [lo, hi) of the JAX package's build_tail_consts_padded."""
    rows = []
    for i in range(lo, hi):
        q = params.q[i]
        kept = i < params.r - 1
        rows.append((q, hm.mont_qinv_neg(q), (1 << 64) // q,
                     params.half_mod_q[i] if kept else 0,
                     hm.to_mont(params.inv_q_last_mod_q[i] if kept else 1, q),
                     params.qi_div_t[i] if kept else 0))
    per_mod = _rows(rows, device)
    return PaddedTailConsts(per_mod=per_mod, tail_rows=tail_rows(per_mod),
                            q_last=params.q[-1],
                            fix_th=_fix_threshold(params.t))


def drop_last_padded_plain(s, ra_ready,
                           consts: PaddedTailConsts) -> torch.Tensor:
    """The modulus drop by q_last of (2, rl, n) s from ra_ready (2, n),
    the JAX package's _keyswitch_shard tail (parallel/spmd_mult.py:331-341):
    (s - (ra - half mod q_i)) inv_q_last mod q_i."""
    q, qinv, nu, half_mod, invq, _ = _cols(consts.per_mod)
    ra = ra_ready - consts.q_last * (ra_ready >= consts.q_last).to(I64)
    tmp = modmath.mod_u64(ra[:, None, :], q, nu)
    tmp = tmp + q * (tmp < half_mod).to(I64) - half_mod
    return modmath.mont_mul(s + q * (s < tmp).to(I64) - tmp, invq, q, qinv)


def encrypt_tail_padded_plain(c, e, ra_ready, m_poly,
                              consts: PaddedTailConsts) -> torch.Tensor:
    """c +> e, the modulus drop by q_last from ra_ready, then c0 +=
    Delta*m + fix: (2, rl, n) x2, (2, n), (n,) -> (2, rl, n)."""
    q, _, nu, _, _, qi_div_t = _cols(consts.per_mod)
    out = drop_last_padded_plain(modmath.add_mod_lazy_gt(c, e, q), ra_ready,
                                 consts)
    m = m_poly[None, :]
    c0 = modmath.mod_u64(out[0] + m * qi_div_t + (m >= consts.fix_th).to(I64),
                         q, nu)
    return torch.stack([c0, out[1]])


def encrypt_tail_padded(c, e, ra_ready, m_poly,
                        consts: PaddedTailConsts) -> torch.Tensor:
    """Kernel 16, one rank's encrypt tail (the JAX package's
    encrypt_tail_padded): c = INTT(NTT(u) (.) pk) and e over the rank's
    rows (2, rl, n), ra_ready (2, n) = ((c_last +> e_last) + half) mod
    q_last as all-reduced from the dropped modulus's owner, m_poly (n,) in
    [0, t) -> (2, rl, n).  Every local row is processed; the dropped
    modulus's slot, where the rank holds it, is padding."""
    rl = consts.per_mod.shape[0]
    n = m_poly.shape[-1]
    for name, t, shape in (("c", c, (2, rl, n)), ("e", e, (2, rl, n)),
                           ("ra_ready", ra_ready, (2, n)),
                           ("m_poly", m_poly, (n,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
    if c.device.type == "cpu":
        return encrypt_tail_padded_plain(c, e, ra_ready, m_poly, consts)
    if c.device.type != "cuda":
        raise ValueError(f"encrypt_tail_padded: no kernel for {c.device}")
    with tracing.launch("bfv_tail.encrypt_tail_padded"):
        dev = consts.per_mod.device
        for name, t in (("c", c), ("e", e), ("ra_ready", ra_ready),
                        ("m_poly", m_poly)):
            cuda.require(name, t, I64, tuple(t.shape), dev)
        ct = torch.empty((2, rl, n), dtype=I64, device=dev)
        cuda.launch("ntt_encrypt_tail_padded", dev, c.data_ptr(), e.data_ptr(),
                    ra_ready.data_ptr(), m_poly.data_ptr(), ct.data_ptr(),
                    consts.tail_rows.data_ptr(), consts.q_last,
                    consts.fix_th, rl, n)
    return ct


def drop_last_padded(c, ra_ready, consts: PaddedTailConsts) -> torch.Tensor:
    """The sharded key switch's modulus drop: one rank's accumulators c
    (2, rl, n) and ra_ready (2, n) = (c_last + half) mod q_last, all-reduced
    from the dropped modulus's owner -> (2, rl, n).  On the card kernel
    16's tail launch with no e and no message (csrc/fused_ops.cu
    ntt_drop_last_padded)."""
    rl, n = consts.per_mod.shape[0], c.shape[-1]
    for name, t, shape in (("c", c, (2, rl, n)),
                           ("ra_ready", ra_ready, (2, n))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got "
                             f"{tuple(t.shape)}")
    if c.device.type == "cpu":
        return drop_last_padded_plain(c, ra_ready, consts)
    if c.device.type != "cuda":
        raise ValueError(f"drop_last_padded: no kernel for {c.device}")
    with tracing.launch("bfv_tail.drop_last_padded"):
        dev = consts.per_mod.device
        for name, t in (("c", c), ("ra_ready", ra_ready)):
            cuda.require(name, t, I64, tuple(t.shape), dev)
        ct = torch.empty((2, rl, n), dtype=I64, device=dev)
        cuda.launch("ntt_drop_last_padded", dev, c.data_ptr(),
                    ra_ready.data_ptr(), ct.data_ptr(),
                    consts.tail_rows.data_ptr(), consts.q_last, rl, n)
    return ct


@dataclasses.dataclass(frozen=True)
class DecPartialConsts:
    """decrypt_tail_partial's constants for one rank's rows: per_mod,
    k2_rows and glob as DecTailConsts's (the dropped modulus's BEHZ row
    zeroed, pad rows q = 1), and the mod-t strategy's t and nu_t (0 for
    pow2 t; _t_mode picks the strategy).  The plain version reads per_mod,
    the kernel k2_rows."""

    per_mod: torch.Tensor  # (rows, 6)
    k2_rows: torch.Tensor  # (rows, 6)
    glob: torch.Tensor     # (4,)
    t: int
    nu_t: int


def build_dec_tail_consts_padded(params, lo: int, hi: int,
                                 pad_to: int | None = None,
                                 device=None) -> DecPartialConsts:
    """The JAX package's build_dec_tail_consts_padded for moduli [lo, hi)
    of `params`, padded with q = 1 rows to pad_to - lo rows.  A rank at
    level l (params the level's chain, r - l moduli) takes
    (lo, min(hi, r - l), pad_to=hi)."""
    return DecPartialConsts(per_mod=_dec_rows(params, lo, hi, device, pad_to),
                            k2_rows=_k2_rows(params, lo, hi, device, pad_to),
                            glob=_dec_glob(params, device), t=params.t,
                            nu_t=_t_fields(params)[0])


def decrypt_tail_partial_plain(x, ct0, consts: DecPartialConsts):
    """(rl, n) x, c0 -> (x_t, x_g), the rank's BEHZ partial sums as (n,)
    int64: x_t the low 32 bits of sum_i (y_i bcm_t_i) & (t-1) for pow2 t
    (the JAX kernel's wrapping u32 sum), sum_i (y_i bcm_t_i) mod t for odd
    t (each product an exact Montgomery product mod t where t >= 2^31);
    x_g = sum_i y_i bcm_g_i mod gamma."""
    q, qinv, ptg, ipq, bcm_t, bcm_g = _cols(consts.per_mod)
    gamma, ginv = consts.glob[0], consts.glob[1]
    y = modmath.add_mod_lazy_gt(x, ct0, q)
    y = modmath.mont_mul(modmath.mont_mul(y, ptg, q, qinv), ipq, q, qinv)
    t = consts.t
    mode = _t_mode(t)
    if mode == 1:
        x_t = ((y * bcm_t) & (t - 1)).sum(dim=-2) & modmath.MASK32
    elif mode == 2:
        tt = poly._scalar(t, x)
        tqi = poly._scalar(modmath.as_i64(hm.mont_qinv_neg(t)), x)
        r2 = poly._scalar(hm.mont_r2(t), x)
        part = modmath.mont_mul(modmath.mont_mul(y, r2, tt, tqi), bcm_t, tt,
                                tqi)
        x_t = part[0]
        for i in range(1, part.shape[0]):
            x_t = modmath.add_mod(x_t, part[i], tt)
    else:
        tt, nu = poly._scalar(t, x), poly._scalar(consts.nu_t, x)
        part = modmath.mod_u64(modmath.mod_u64(y, tt, nu) * bcm_t, tt, nu)
        x_t = part.sum(dim=-2) % t
    part_g = modmath.mont_mul(y, bcm_g, gamma, ginv)
    x_g = part_g[0]
    for i in range(1, part_g.shape[0]):
        x_g = modmath.add_mod(x_g, part_g[i], gamma)
    return x_t, x_g


def decrypt_tail_partial(x, ct0, consts: DecPartialConsts):
    """Kernel 17, one rank's decrypt tail up to the BEHZ sums (the JAX
    package's decrypt_tail_partial): (rl, n) x = INTT(NTT(c1) (.) sk) and
    c0 over the rank's rows -> (x_t, x_g), each (n,) int64, to be
    all-reduced (psum_behz_partials) and rounded (dec_round_from_sums).
    On the card K2's kernel with its partial epilogue, over consts.k2_rows
    (csrc/decrypt_tail.cu)."""
    rl = consts.per_mod.shape[0]
    n = x.shape[-1]
    for name, t in (("x", x), ("ct0", ct0)):
        if tuple(t.shape) != (rl, n):
            raise ValueError(f"{name}: expected shape {(rl, n)}, got "
                             f"{tuple(t.shape)}")
    if x.device.type == "cpu":
        return decrypt_tail_partial_plain(x, ct0, consts)
    if x.device.type != "cuda":
        raise ValueError(f"decrypt_tail_partial: no kernel for {x.device}")
    with tracing.launch("bfv_tail.decrypt_tail_partial"):
        dev = consts.per_mod.device
        cuda.require("x", x, I64, (rl, n), dev)
        cuda.require("ct0", ct0, I64, (rl, n), dev)
        out = torch.empty((2, n), dtype=I64, device=dev)
        t = consts.t
        cuda.launch("ntt_decrypt_tail_partial", dev, x.data_ptr(),
                    ct0.data_ptr(), out.data_ptr(), consts.k2_rows.data_ptr(),
                    consts.glob.data_ptr(), rl, n, _t_mode(t), t, consts.nu_t)
    return out[0], out[1]


def _gamma_scalars(params, like: torch.Tensor):
    """gamma, floor(2^64 / gamma) and -gamma^-1 mod 2^64 as 0-d tensors on
    like's device."""
    g = params.gamma
    return (poly._scalar(g, like), poly._scalar((1 << 64) // g, like),
            poly._scalar(modmath.as_i64(hm.mont_qinv_neg(g)), like))


def _combine_halves(lo_sum, hi_sum, m: int) -> torch.Tensor:
    """The total mod m from the all-reduced 32-bit halves of the ranks'
    partials: hi 2^32 + lo, as mont_mul(hi mod m, Mont(2^32)) + (lo mod m)
    < 2 m (m odd, below 2^62).  Each half sum stays below R 2^32, so no
    rank count below 2^31 wraps int64."""
    mq = poly._scalar(m, lo_sum)
    nu = poly._scalar((1 << 64) // m, lo_sum)
    minv = poly._scalar(modmath.as_i64(hm.mont_qinv_neg(m)), lo_sum)
    hi = modmath.mont_mul(modmath.mod_u64(hi_sum, mq, nu),
                          poly._scalar(hm.to_mont(1 << 32, m), lo_sum), mq,
                          minv)
    return hi + modmath.mod_u64(lo_sum, mq, nu)


def combine_gamma_halves(lo_sum, hi_sum, params) -> torch.Tensor:
    """The gamma-row total mod gamma from the all-reduced 32-bit halves of
    the ranks' partials (_combine_halves), below 2 gamma."""
    return _combine_halves(lo_sum, hi_sum, params.gamma)


def psum_behz_partials(x_t, x_g, group, params):
    """All-reduce the ranks' BEHZ partials over `group` in one stacked
    (3, n) int64 sum, [x_t, x_g's low 32 bits, x_g's high bits] ((3, J,
    n) for J ciphertexts' (J, n) partials): x_t
    partials are below 2^32 and so are the halves, so for R < 2^31 no sum
    wraps.  For a t >= 2^31 x_t goes as two halves too ((4, n): x_t's
    low and high 32 bits first), its total taken mod t.  Returns (x_t
    sum, x_g total mod gamma, below 2 gamma)."""
    from ..parallel import mesh
    wide = _t_mode(params.t) == 2
    x_ts = ([x_t & modmath.MASK32, (x_t >> 32) & modmath.MASK32] if wide
            else [x_t])
    parts = torch.stack(x_ts + [x_g & modmath.MASK32,
                                (x_g >> 32) & modmath.MASK32])
    mesh.all_reduce(parts, group)
    x_t_sum = (_combine_halves(parts[0], parts[1], params.t) if wide
               else parts[0])
    return x_t_sum, combine_gamma_halves(parts[-2], parts[-1], params)


def dec_round_from_sums(x_t_sum, x_g_sum, params) -> torch.Tensor:
    """The plaintext (n,) from the all-reduced sums: x_g_sum any
    representative of the gamma total mod gamma; then neg_inv_q scaling
    and dec_round, as decrypt_tail's finish (pow2 t: the reference's
    masks; odd t: exact mod t, with the gamma undo)."""
    g, t = params.gamma, params.t
    neg_t, neg_g = params.neg_inv_q_mod_t_gamma
    gq, nu_g, ginv = _gamma_scalars(params, x_g_sum)
    x_g = modmath.mont_mul(modmath.mod_u64(x_g_sum, gq, nu_g),
                           poly._scalar(hm.to_mont(neg_g, g), x_g_sum), gq,
                           ginv)
    over = x_g > params.gamma_div_2
    if t & (t - 1) == 0:
        mask = t - 1
        x_t = ((x_t_sum & mask) * neg_t) & mask
        return torch.where(over, x_t + (gq - x_g), x_t - x_g) & mask
    tt, nu_t = poly._scalar(t, x_t_sum), poly._scalar((1 << 64) // t,
                                                       x_t_sum)
    x_t = modmath.mod_u64(x_t_sum, tt, nu_t)
    if _t_mode(t) == 2:
        # products of two residues below t pass 64 bits: exact
        # mulmod (Montgomery) products, as the kernels' wide strategy
        tqi = poly._scalar(modmath.as_i64(hm.mont_qinv_neg(t)), x_t_sum)
        mul = lambda a, c: modmath.mont_mul(
            a, poly._scalar(hm.to_mont(c, t), x_t_sum), tt, tqi)
    else:
        mul = lambda a, c: modmath.mod_u64(a * c, tt, nu_t)
    x_t = mul(x_t, neg_t)
    plus = modmath.add_mod(x_t, modmath.mod_u64(gq - x_g, tt, nu_t), tt)
    minus = modmath.sub_mod(x_t, modmath.mod_u64(x_g, tt, nu_t), tt)
    corr = torch.where(over, plus, minus)
    return mul(corr, pow(g % t, -1, t))
