"""RNS-sharded EvalMult, relinearization and Galois automorphisms over the
'rns' axis, on torch.distributed.

Counterpart of `ntt_cuda_tpu/parallel/spmd_mult.py`, on an SpmdBFVContext
(parallel/spmd.py): each rank owns the moduli rows [lo, hi) of q and of
the auxiliary base Bsk (k + 1 = r moduli, so both split alike), and runs
every transform and dyadic product on its own rows.  Each fast base
conversion needs every source row, so its input is one all-gather; the
rank then computes its own band of target rows (kernels 21a-c in band
form).  The traffic per op:

  * mul: four all-gathers, a and b (2, r, n) before 21a, the q-side tensor
    product (3, r, n) before 21b, the floored Bsk product (3, r, n) before
    21c;
  * square: three, mul's with one operand;
  * relinearize and apply_galois: one all-gather of the (r, n) component
    being switched (its digits), then the key-switch front on the rank's
    rows (kernel 20) and one all-reduce of the (2, n) adjusted last
    residue, sent by the dropped modulus's owner, for the modulus drop;
  * decrypt3: one all-reduce of the (3, n) BEHZ partial sums, as decrypt;
  * relin_keygen and galois_keygen: none (each rank draws its own rows).

Ciphertexts keep the padded (L, r, n) layout of parallel/spmd.py: mul
returns (3, r, n) with the dropped modulus's row 0, and relinearize keeps
that row (the key switch's drop writes 0 there).  Switching keys are
(2, r-1, r, n) DTensors [Shard(2)].  Every collective goes through
`parallel.mesh`, which logs it.  Live rows equal the single-card
BFVContext's, bit for bit.

The kernels: 21a-c in band form (ops/behz_kernels.py), kernel 20
(fused_ops.keyswitch_front), kernels 7 and 8 (the transforms and the
tensor product, as BFVContext.mul), 11 (the keys), kernel 16's tail as the
modulus drop (bfv_tail.drop_last_padded), 17 (decrypt3), and K1 for the
draws; on the CPU their plain versions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.bfv import BFVContext
from ..ops import (behz, behz_kernels, bfv_tail, fused_ops, modmath, ntt,
                   ntt_stage, poly, sampling)
from ..ops.behz_kernels import SpmdMultConsts
from ..ops.modmath import I64
from . import mesh
from .spmd import SpmdBFVContext

_SK_HINT = "keygen returns the NTT-domain (r, n) sk"


def drop_consts(mc: SpmdMultConsts, q_last: int, lo: int,
                hi: int) -> bfv_tail.PaddedTailConsts:
    """Kernel 16's constants for the key switch's modulus drop on rows
    [lo, hi): per_mod rows (q, -q^-1, nu, half_mod, inv_q_last, q_i // t)
    from the padded banks, so the dropped row's inverse is 0 and the drop
    writes 0 there, as the JAX package's _keyswitch_shard does; there is
    no message (q_i // t 0); and the kernel's rows from them."""
    per_mod = torch.cat([mc.q_all, mc.qinv_all, mc.nu_all, mc.half_mod,
                         mc.inv_qlast_mont, torch.zeros_like(mc.q_all)],
                        dim=1)[lo:hi].contiguous()
    return bfv_tail.PaddedTailConsts(per_mod=per_mod,
                                     tail_rows=bfv_tail.tail_rows(per_mod),
                                     q_last=q_last, fix_th=0)


def scale_band(pq, pb, mc: SpmdMultConsts, lo: int, rl: int,
               group) -> torch.Tensor:
    """A band's (3, rl, n') rows of t/q round(pq) in base q, from the
    tensor products over q and Bsk (3, rl, n') of rows [lo, lo + rl): the
    q side gathered over `group` for 21b, its Bsk result gathered for
    21c."""
    pq_all = mesh.all_gather(pq, group)[:, :mc.k].contiguous()
    fl = behz_kernels.fast_floor_rows(pq_all, pb, mc, lo, rl)
    return behz_kernels.bsk_to_q_rows(mesh.all_gather(fl, group), mc, lo, rl)


def drop_last(cc, params, hi: int, group,
              consts: bfv_tail.PaddedTailConsts) -> torch.Tensor:
    """The key switch's modulus drop of a band's accumulators cc (2, rl,
    n'), rows up to `hi`: the owner of row r-1 sends (cc_last + half) mod
    q_last in one all-reduce over `group`, kernel 16's tail drops
    q_last."""
    ra = torch.zeros((2, cc.shape[-1]), dtype=I64, device=cc.device)
    if hi == params.r:                           # the dropped modulus's owner
        ql = params.q[-1]
        ra = cc[:, -1] + params.half_last_modulus
        ra = ra - ql * (ra >= ql).to(I64)
    mesh.all_reduce(ra, group)
    return bfv_tail.drop_last_padded(cc, ra, consts)


def galois_map(cache: dict, n: int, g: int, device):
    """tau_g's (perm, neg) over n points as tensors on `device`, cached in
    `cache` by g."""
    m = cache.get(g)
    if m is None:
        perm, neg = poly.galois_maps(n, g)
        m = cache[g] = (torch.from_numpy(perm.astype(np.int64)).to(device),
                        torch.from_numpy(neg).to(device))
    return m


def add_target_rows(x, term, lo: int, hi: int, q) -> torch.Tensor:
    """x (..., k, rl, n') switching keys' first halves over rows [lo, hi),
    term (..., rl, n') the P * target term: key j's term added on global
    row j where the rank holds it (in place; x returned).  q (rl, 1)."""
    k = x.shape[-3]
    rows = torch.arange(lo, min(hi, k), device=x.device)
    if len(rows):
        loc = rows - lo
        x[..., rows, loc, :] = modmath.add_mod(x[..., rows, loc, :],
                                               term[..., loc, :], q[loc])
    return x


@dataclasses.dataclass(frozen=True)
class SpmdMultContext:
    """One rank's EvalMult state over an SpmdBFVContext's mesh.  Every rank
    builds it and calls each op together."""

    base: SpmdBFVContext
    mc: SpmdMultConsts                    # replicated banks, kernels' too
    tables_bsk: ntt.NTTTables             # Bsk moduli [lo, hi)
    drop_consts: bfv_tail.PaddedTailConsts  # the key switch's drop, [lo, hi)
    _cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @staticmethod
    def build(base: SpmdBFVContext) -> "SpmdMultContext":
        p, lo, hi = base.params, base.lo, base.hi
        aux = behz.AuxBase.build(p)
        mc = SpmdMultConsts.build(p, aux, base.device)
        return SpmdMultContext(
            base=base, mc=mc,
            tables_bsk=ntt.NTTTables.build(aux.bsk[lo:hi],
                                           aux.bsk_psi[lo:hi], p.n,
                                           base.device),
            drop_consts=drop_consts(mc, p.q[-1], lo, hi))

    # -- the public API -----------------------------------------------------

    def mul(self, ct_a, ct_b, rlk=None):
        """Padded (2, r, n) ciphertexts -> the padded (3, r, n) product
        [Shard(1)], its dropped-modulus row 0, or the relinearized (2, r, n)
        with `rlk` (relin_keygen).  Live rows equal BFVContext.mul's.

        Both operands gathered and extended to the rank's Bsk rows (21a),
        forward over q and Bsk (kernel 7), the tensor product (kernel 8);
        the q side gathered for 21b, its Bsk result gathered for 21c."""
        b = self.base
        k, rl, lo, g = b.params.r - 1, b.rl, b.lo, b.group
        a_loc, b_loc = b._ct_pair("mul", ct_a, ct_b)          # (2, rl, n)
        x = torch.stack([mesh.all_gather(a_loc, g),
                         mesh.all_gather(b_loc, g)])[..., :k, :]
        xb = behz_kernels.rns_to_bsk_rows(x.contiguous(), self.mc, lo, rl)
        pq = BFVContext._tensor(BFVContext._fwd_rows(
            torch.stack([a_loc, b_loc]), b.tables), b.tables)  # (3, rl, n)
        pb = BFVContext._tensor(BFVContext._fwd_rows(xb, self.tables_bsk),
                                self.tables_bsk)
        ct3 = b._dtensor(scale_band(pq, pb, self.mc, lo, rl, g), 1)
        return ct3 if rlk is None else self.relinearize(ct3, rlk)

    def square(self, ct, rlk=None):
        """mul(ct, ct) with one operand's transforms and conversion: one
        all-gather of ct before 21a, then mul's two (3 of the four); the
        tensor product's square form (BFVContext._tensor(..., square=True)).
        Live rows equal BFVContext.square's."""
        b = self.base
        k, rl, lo, g = b.params.r - 1, b.rl, b.lo, b.group
        a_loc, _ = b._ct_pair("square", ct, ct)               # (2, rl, n)
        x = mesh.all_gather(a_loc, g)[None, :, :k].contiguous()
        xb = behz_kernels.rns_to_bsk_rows(x, self.mc, lo, rl)  # (1, 2, rl, n)
        pq = BFVContext._tensor(BFVContext._fwd_rows(a_loc[None], b.tables),
                                b.tables, square=True)
        pb = BFVContext._tensor(BFVContext._fwd_rows(xb, self.tables_bsk),
                                self.tables_bsk, square=True)
        ct3 = b._dtensor(scale_band(pq, pb, self.mc, lo, rl, g), 1)
        return ct3 if rlk is None else self.relinearize(ct3, rlk)

    def relin_keygen(self, sk, nonce=0):
        """sk (r, n) NTT domain -> rlk (2, r-1, r, n) [Shard(2)], equal to
        the single-card relin_keygen: the rank's rows of the draws
        (sampling.relin_draws_rank), kernels 8 and 11 on its rows, and the
        P s^2 term on row j of key j where the rank holds it.  No
        collective."""
        sampling.check_user_nonce(nonce)
        b = self.base
        p, ms = b.params, b.tables.ms
        sk = b._local("sk", sk, (p.r, p.n), 0, _SK_HINT)
        a, e = sampling.relin_draws_rank(p.n, p.r, p.r - 1, b.lo, b.hi, ms,
                                         nonce=int(nonce))
        return b._dtensor(self._kskeygen(a, e, sk, ntt.dyadic_mul(sk, sk, ms)),
                          2)

    def relinearize(self, ct3, rlk):
        """Padded (3, r, n) mul() output + rlk -> padded (2, r, n): the key
        switch of c2 added to (c0, c1) exactly mod q."""
        b = self.base
        p = b.params
        ct3 = b._local("ct3", ct3, (3, p.r, p.n), 1,
                       "SPMD mul returns the padded (3, r, n) form")
        rlk = b._local("rlk", rlk, (2, p.r - 1, p.r, p.n), 2,
                       "relin_keygen returns (2, r-1, r, n) [Shard(2)]")
        cc = self._keyswitch(ct3[2], rlk)
        return b._dtensor(modmath.add_mod(ct3[:2], cc, b.tables.ms.q), 1)

    def galois_keygen(self, sk, elts, nonce=0):
        """Switching keys for the automorphisms x -> x^g: {g: (2, r-1, r,
        n) [Shard(2)]}, equal to the single-card galois_keygen (each
        element's stream region indexed by its value, the rank's rows of
        it).  tau_g(s) from kernel 7's inverse of the rank's sk rows, the
        permutation, kernel 7's forward.  No collective."""
        sampling.check_user_nonce(nonce)
        b = self.base
        p, tb = b.params, b.tables
        sk = b._local("sk", sk, (p.r, p.n), 0, _SK_HINT)
        elts = sorted({int(g) for g in elts})
        maps = [galois_map(self._cache, p.n, g, b.device)
                for g in elts]                     # validates each g
        a, e = sampling.galois_draws_rank(p.n, p.r, p.r - 1, elts, b.lo, b.hi,
                                          tb.ms, nonce=int(nonce))
        s_coef = ntt_stage.ntt_inverse(sk, tb)
        ts = torch.stack([poly.galois_apply(s_coef, perm, neg, tb.ms)
                          for perm, neg in maps])         # (E, rl, n)
        keys = self._kskeygen(a, e, sk, ntt_stage.ntt_forward(ts, tb))
        return {g: b._dtensor(keys[i].contiguous(), 2)
                for i, g in enumerate(elts)}

    def apply_galois(self, ct, g, gk):
        """tau_g of a padded (2, r, n) ciphertext and the key switch of its
        permuted c1 back to sk (gk = galois_keygen(...)[g]); live rows equal
        BFVContext.apply_galois's."""
        b = self.base
        p, ms = b.params, b.tables.ms
        ct = b._local("ct", ct, (2, p.r, p.n), 1,
                      "SPMD ciphertexts use the padded (2, r, n) layout")
        gk = b._local("gk", gk, (2, p.r - 1, p.r, p.n), 2,
                      "pass one key from galois_keygen()")
        perm, neg = galois_map(self._cache, p.n, int(g), b.device)
        tc = poly.galois_apply(ct, perm, neg, ms)
        cc = self._keyswitch(tc[1], gk)
        return b._dtensor(torch.stack([modmath.add_mod(tc[0], cc[0], ms.q),
                                       cc[1]]), 1)

    def decrypt3(self, sk, ct3):
        """Padded 3-component decrypt, c0 + c1 s + c2 s^2 -> plaintext (n,)
        [Replicate()]: kernel 7 on c1, c2, kernel 8 against s and s^2,
        kernel 17, one all-reduce of the (3, n) BEHZ partials."""
        b = self.base
        p, tb = b.params, b.tables
        sk = b._local("sk", sk, (p.r, p.n), 0, _SK_HINT)
        ct3 = b._local("ct3", ct3, (3, p.r, p.n), 1,
                       "SPMD mul returns the padded (3, r, n) form")
        s2 = ntt.dyadic_mul(sk, sk, tb.ms)
        x = ntt_stage.ntt_inverse_mul(ntt_stage.ntt_forward(ct3[1:], tb),
                                      torch.stack([sk, s2]), tb)
        x = modmath.add_mod(x[0], x[1], tb.ms.q)
        x_t, x_g = bfv_tail.decrypt_tail_partial(x, ct3[0], b.dec_consts)
        x_t, x_g = bfv_tail.psum_behz_partials(x_t, x_g, b.group, p)
        return b._dtensor(bfv_tail.dec_round_from_sums(x_t, x_g, p), None)

    # -- the rank's pieces --------------------------------------------------

    def _keyswitch(self, c2, ksk) -> torch.Tensor:
        """Key switch of one (rl, n) component through the rank's key rows
        ksk (2, k, rl, n) -> (2, rl, n) (the JAX package's
        _keyswitch_shard): gather the digit rows, kernel 20 on the rank's
        moduli, the owner of row r-1 sends (cc_last + half) mod q_last in
        one all-reduce, kernel 16's tail drops q_last."""
        b = self.base
        p = b.params
        c2_all = mesh.all_gather(c2, b.group)                  # (r, n)
        cc = fused_ops.keyswitch_front(c2_all[:p.r - 1].contiguous(), ksk,
                                       b.tables)
        return drop_last(cc, p, b.hi, b.group, self.drop_consts)

    def _kskeygen(self, a, e, sk, target_hat) -> torch.Tensor:
        """The rank's rows of BFVContext._kskeygen: a, e (..., k, rl, n),
        target_hat (..., rl, n) -> (..., 2, k, rl, n); key j's P * target
        term lands on global row j, where the rank holds it."""
        b = self.base
        tb = b.tables
        ms, (k, rl, n) = tb.ms, a.shape[-3:]
        x = ntt_stage.ntt_inverse_mul(a.reshape(-1, rl, n), sk, tb)
        x = ntt_stage.ntt_forward_addneg(x, e.reshape(-1, rl, n),
                                         tb).reshape(a.shape)
        term = modmath.mont_mul(target_hat, self.mc.p_mont_q[b.lo:b.hi], ms.q,
                                ms.qinv_neg)
        return torch.stack([add_target_rows(x, term, b.lo, b.hi, ms.q), a],
                           dim=-4)
