"""2-D (rns x coef) EvalMult, relinearization and Galois automorphisms
over an ('rns', 'coef') mesh, on torch.distributed.

Counterpart of `ntt_cuda_tpu/parallel/spmd2d_mult.py`: parallel/
spmd_mult.py's communication pattern on parallel/spmd2d.py's mesh.  Rank
(i, c) holds rows [lo, hi) of every polynomial (of q and of the auxiliary
base Bsk, k + 1 = r moduli, split alike) and coefficients [c S, (c + 1)
S), S = n / C.  The BEHZ conversions are elementwise in the coefficients,
so the 'coef' axis adds no conversion traffic: each still gathers its
source rows over 'rns', as (..., r, S) slices.  Every transform is the
coefficient-sharded one of parallel/coef_kernels.py (the cross stages,
one ppermute each over 'coef', and the local launch with the shard
offset), over q and over Bsk (its own CoefShardedNTT).  The traffic:

  * mul: four all-gathers over 'rns', a and b (2, r, S) before 21a, the
    q-side tensor product (3, r, S) before 21b, the floored Bsk product
    (3, r, S) before 21c; with rlk the key switch's one more all-gather
    and one all-reduce;
  * relinearize: one all-gather of the (r, S) component switched (its
    digits), one all-reduce over 'rns' of the (2, S) adjusted last
    residue, sent by the dropped modulus's owner, for the modulus drop;
  * apply_galois: one all-gather over 'coef' of the (2, rl, n) ciphertext
    (the global permutation), then the key switch as relinearize's;
  * galois_keygen: one all-gather over 'coef' of the (rl, n) secret (the
    permutation of s, shared by every element);
  * decrypt3: one all-reduce over 'rns' of the (3, S) BEHZ partials;
  * relin_keygen: none beside the transforms;
  * every transform: log2 C ppermutes over 'coef' (a batch of
    polynomials is one transform).

Ciphertexts keep the padded layout: (2, r, n) in, (3, r, n) from mul, the
dropped modulus's row 0 there (and after the key switch's drop), DTensors
[Shard(1), Shard(2)]; switching keys (2, r-1, r, n) [Shard(2), Shard(3)];
sk (r, n) [Shard(0), Shard(1)].  A plain full tensor or array passed in is
sliced to the rank's block where it lies (Spmd2DBFVContext._local).  Each
rank draws exactly its rows x coefficient slice of the keys' Salsa20
streams (sampling.relin_draws_rank / galois_draws_rank with block, S).
Live rows equal the single-card BFVContext's, bit for bit.

The kernels: K1 (the draws), kernels 7 and 8 with the shard offset (the
transforms and the tensor product, coef_kernels), kernel 20's
accumulate-and-inverse with the shard offset (coef_kernels.
local_keyswitch_acc), 21a-c in band form (ops/behz_kernels.py), kernel
16's drop (bfv_tail.drop_last_padded) and 17 (decrypt_tail_partial); on
the CPU their plain versions.  Kernel 20's digit launch (PRO_DIGIT) cannot
serve: the digits are reduced before the cross stages, which run before
the local forward, so the reduction stays glue (modmath.mod_u64), as in
the JAX package; and kernel 11's fused add-negate cannot serve the keys,
whose cross stages lie between the inverse and the forward.  The JAX
package's `conv_impl` (its TPU, interpret and XLA conversions) has no
counterpart: the conversions here are the band kernels.
"""

from __future__ import annotations

import dataclasses

import torch

from ..models.bfv import BFVContext
from ..ops import behz, behz_kernels, bfv_tail, modmath, ntt, poly, sampling
from ..ops.behz_kernels import SpmdMultConsts
from . import coef_kernels
from . import mesh as mesh_mod
from .coef_kernels import CoefShardedNTT
from .spmd2d import Spmd2DBFVContext
from .spmd_mult import (add_target_rows, drop_consts, drop_last, galois_map,
                         scale_band)

_SK_HINT = "keygen returns the NTT-domain (r, n) sk"
_CT_HINT = "2-D ciphertexts use the padded (2, r, n) layout"
_CT3_HINT = "the 2-D mul returns the padded (3, r, n) form"


@dataclasses.dataclass(frozen=True)
class Spmd2DMultContext:
    """One rank's EvalMult state over a Spmd2DBFVContext's mesh.  Every rank
    builds it and calls each op together."""

    base: Spmd2DBFVContext
    mc: SpmdMultConsts                    # replicated banks, kernels' too
    cnt_bsk: CoefShardedNTT               # Bsk rows [lo, hi), shard c
    drop_consts: bfv_tail.PaddedTailConsts  # the key switch's drop, [lo, hi)
    _cache: dict = dataclasses.field(default_factory=dict, compare=False,
                                     repr=False)

    @staticmethod
    def build(base: Spmd2DBFVContext) -> "Spmd2DMultContext":
        p, lo, hi = base.params, base.lo, base.hi
        aux = behz.AuxBase.build(p)
        mc = SpmdMultConsts.build(p, aux, base.device)
        return Spmd2DMultContext(
            base=base, mc=mc,
            cnt_bsk=CoefShardedNTT.build(aux.bsk[lo:hi], aux.bsk_psi[lo:hi],
                                         p.n, base.C, base.coef_index,
                                         base.device),
            drop_consts=drop_consts(mc, p.q[-1], lo, hi))

    # -- the public API -----------------------------------------------------

    def mul(self, ct_a, ct_b, rlk=None):
        """Padded (2, r, n) ciphertexts -> the padded (3, r, n) product
        [Shard(1), Shard(2)], its dropped-modulus row 0, or the
        relinearized (2, r, n) with `rlk` (relin_keygen).  Live rows equal
        BFVContext.mul's.

        Both operands gathered over 'rns' and extended to the rank's Bsk
        rows (21a), forward over q and Bsk (one sharded transform each, a
        and b together), the tensor product (one kernel 8 launch a base
        over the four products, as BFVContext._tensor, then one inverse's
        cross stages: by linearity equal to the JAX package's inverse of
        the middle sum), the q side gathered for 21b, its Bsk result
        gathered for 21c."""
        b = self.base
        p = b.params
        k, rl, lo, g = p.r - 1, b.rl, b.lo, self._rns
        a_loc = b._local("ct_a", ct_a, (2, p.r, p.n), 1, 2, _CT_HINT)
        b_loc = b._local("ct_b", ct_b, (2, p.r, p.n), 1, 2, _CT_HINT)
        x = torch.stack([mesh_mod.all_gather(a_loc, g),
                         mesh_mod.all_gather(b_loc, g)])[..., :k, :]
        xb = behz_kernels.rns_to_bsk_rows(x.contiguous(), self.mc, lo, rl)
        ct3 = b._dtensor(scale_band(
            self._tensor(torch.stack([a_loc, b_loc]), b.cnt),
            self._tensor(xb, self.cnt_bsk), self.mc, lo, rl, g), 1, 2)
        return ct3 if rlk is None else self.relinearize(ct3, rlk)

    def relin_keygen(self, sk, nonce=0):
        """sk (r, n) NTT domain -> rlk (2, r-1, r, n) [Shard(2), Shard(3)],
        equal to the single-card relin_keygen: the rank's block of the
        draws, P s^2 on row j of key j where the rank holds it."""
        sampling.check_user_nonce(nonce)
        b = self.base
        p, ms = b.params, b.ms
        sk = b._local("sk", sk, (p.r, p.n), 0, 1, _SK_HINT)
        a, e = sampling.relin_draws_rank(p.n, p.r, p.r - 1, b.lo, b.hi, ms,
                                         nonce=int(nonce),
                                         block=b.coef_index, S=b.S)
        return b._dtensor(self._kskeygen(a, e, sk, ntt.dyadic_mul(sk, sk, ms)),
                          2, 3)

    def relinearize(self, ct3, rlk):
        """Padded (3, r, n) mul() output + rlk -> padded (2, r, n): the key
        switch of c2 added to (c0, c1) exactly mod q."""
        b = self.base
        p = b.params
        ct3 = b._local("ct3", ct3, (3, p.r, p.n), 1, 2, _CT3_HINT)
        rlk = b._local("rlk", rlk, (2, p.r - 1, p.r, p.n), 2, 3,
                       "relin_keygen returns (2, r-1, r, n)")
        cc = self._keyswitch(ct3[2].contiguous(), rlk)
        return b._dtensor(modmath.add_mod(ct3[:2], cc, b.ms.q), 1, 2)

    def galois_keygen(self, sk, elts, nonce=0):
        """Switching keys for the automorphisms x -> x^g: {g: (2, r-1, r,
        n) [Shard(2), Shard(3)]}, equal to the single-card galois_keygen
        (each element's stream region indexed by its value, the rank's
        block of it).  tau_g(s): the sharded inverse of sk, the global
        permutation, the sharded forward."""
        sampling.check_user_nonce(nonce)
        b = self.base
        p, ms, ex = b.params, b.ms, b._exchange()
        sk = b._local("sk", sk, (p.r, p.n), 0, 1, _SK_HINT)
        elts = sorted({int(g) for g in elts})
        maps = [galois_map(self._cache, p.n, g, b.device)
                for g in elts]                     # validates each g
        a, e = sampling.galois_draws_rank(p.n, p.r, p.r - 1, elts, b.lo, b.hi,
                                          ms, nonce=int(nonce),
                                          block=b.coef_index, S=b.S)
        s_all = self._coef_gather(b.cnt.inverse(sk, ex))       # (rl, n)
        ts = torch.stack([self._slice(poly.galois_apply(s_all, perm, neg, ms))
                          for perm, neg in maps])          # (E, rl, S)
        keys = self._kskeygen(a, e, sk, b.cnt.forward(ts, ex))
        return {g: b._dtensor(keys[i].contiguous(), 2, 3)
                for i, g in enumerate(elts)}

    def apply_galois(self, ct, g, gk):
        """tau_g of a padded (2, r, n) ciphertext (the permutation over
        the coefficients gathered over 'coef', the rank's slice kept) and
        the key switch of its permuted c1 back to sk (gk =
        galois_keygen(...)[g]); live rows equal BFVContext.apply_galois's."""
        b = self.base
        p, ms = b.params, b.ms
        ct = b._local("ct", ct, (2, p.r, p.n), 1, 2, _CT_HINT)
        gk = b._local("gk", gk, (2, p.r - 1, p.r, p.n), 2, 3,
                      "pass one key from galois_keygen()")
        perm, neg = galois_map(self._cache, p.n, int(g), b.device)
        tc = self._slice(poly.galois_apply(self._coef_gather(ct), perm, neg,
                                           ms))
        cc = self._keyswitch(tc[1].contiguous(), gk)
        return b._dtensor(torch.stack([modmath.add_mod(tc[0], cc[0], ms.q),
                                       cc[1]]), 1, 2)

    def decrypt3(self, sk, ct3):
        """Padded 3-component decrypt, c0 + c1 s + c2 s^2 -> plaintext (n,)
        [Replicate(), Shard(0)]: the sharded forward of c1 and c2, one
        kernel 8 launch against s and s^2, their sum's cross stages (one
        inverse), kernel 17, one all-reduce of the (3, S) BEHZ partials
        over 'rns'."""
        b = self.base
        p, ms, ex, tb = b.params, b.ms, b._exchange(), b.cnt.tables
        sk = b._local("sk", sk, (p.r, p.n), 0, 1, _SK_HINT)
        ct3 = b._local("ct3", ct3, (3, p.r, p.n), 1, 2, _CT3_HINT)
        s2 = ntt.dyadic_mul(sk, sk, ms)
        x = coef_kernels.local_inverse_mul(
            b.cnt.forward(ct3[1:].contiguous(), ex), torch.stack([sk, s2]), tb,
            b.cnt.logc, b.coef_index)
        x = coef_kernels.cross_inv(modmath.add_mod(x[0], x[1], ms.q), tb, b.C,
                                   b.coef_index, ex)
        x_t, x_g = bfv_tail.decrypt_tail_partial(x, ct3[0].contiguous(),
                                                 b.dec_consts)
        x_t, x_g = bfv_tail.psum_behz_partials(x_t, x_g, self._rns, p)
        return b._dtensor(bfv_tail.dec_round_from_sums(x_t, x_g, p), None, 0)

    # -- the rank's pieces --------------------------------------------------

    @property
    def _rns(self):
        return self.base.mesh.get_group(mesh_mod.RNS_AXIS)

    def _tensor(self, x, cnt: CoefShardedNTT):
        """The tensor product of (2, 2, rl, S) operands (operand,
        component) in the coefficient domain over cnt's moduli, (3, rl,
        S): one sharded forward of the four polynomials, one kernel 8
        launch over BFVContext._MUL_PAIRS with the shard offset, c1 the
        sum of the cross terms, then one inverse's cross stages."""
        b = self.base
        rl, S = x.shape[-2:]
        ex = b._exchange()
        f = cnt.forward(x.reshape(4, rl, S).contiguous(), ex).reshape(x.shape)
        pairs = BFVContext._MUL_PAIRS
        xs = torch.stack([f[o, c] for o, c, _, _ in pairs])
        ys = torch.stack([f[o, c] for _, _, o, c in pairs])
        out = coef_kernels.local_inverse_mul(xs, ys, cnt.tables, cnt.logc,
                                             cnt.block)
        c1 = modmath.add_mod(out[2], out[3], cnt.tables.ms.q)
        return coef_kernels.cross_inv(torch.stack([out[0], c1, out[1]]),
                                      cnt.tables, cnt.C, cnt.block, ex)

    def _keyswitch(self, c2, ksk) -> torch.Tensor:
        """Key switch of one (rl, S) component through the rank's key block
        ksk (2, k, rl, S) -> (2, rl, S) (the JAX package's _keyswitch2d):
        gather the digit rows over 'rns', reduce each into the rank's
        moduli (glue), the sharded forward, kernel 20's accumulate and
        inverse with the shard offset, the cross inverse stages, the owner
        of row r-1 sends (cc_last + half) mod q_last in one all-reduce over
        'rns', kernel 16's tail drops q_last."""
        b = self.base
        p, ms, ex, tb = b.params, b.ms, b._exchange(), b.cnt.tables
        c2_all = mesh_mod.all_gather(c2, self._rns)            # (r, S)
        d = modmath.mod_u64(c2_all[:p.r - 1, None, :], ms.q, ms.nu)
        acc = coef_kernels.local_keyswitch_acc(b.cnt.forward(d, ex), ksk, tb,
                                               b.cnt.logc, b.coef_index)
        cc = coef_kernels.cross_inv(acc, tb, b.C, b.coef_index, ex)
        return drop_last(cc, p, b.hi, self._rns, self.drop_consts)

    def _kskeygen(self, a, e, sk, target_hat) -> torch.Tensor:
        """The rank's block of BFVContext._kskeygen: a, e (..., k, rl, S),
        target_hat (..., rl, S) -> (..., 2, k, rl, S).  INTT(a (.) sk)
        sharded (kernel 8 with the shard offset and the cross stages),
        -(x + e) as glue, the sharded forward; key j's P * target term on
        global row j, where the rank holds it."""
        b = self.base
        ms, ex, (rl, S) = b.ms, b._exchange(), a.shape[-2:]
        x = b.cnt.inverse_mul(a.reshape(-1, rl, S), sk, ex)
        x = poly.poly_add_negate(x, e.reshape(-1, rl, S), ms)
        x = b.cnt.forward(x, ex).reshape(a.shape)
        term = modmath.mont_mul(target_hat, self.mc.p_mont_q[b.lo:b.hi], ms.q,
                                ms.qinv_neg)
        return torch.stack([add_target_rows(x, term, b.lo, b.hi, ms.q), a],
                           dim=-4)

    def _coef_gather(self, x) -> torch.Tensor:
        """x (..., S) gathered over 'coef' into the rank's rows over the
        whole n: one all-gather along the last axis."""
        return mesh_mod.all_gather(x, self.base.mesh.get_group(
            mesh_mod.COEF_AXIS), dim=-1)

    def _slice(self, x) -> torch.Tensor:
        """The rank's coefficients [c S, (c + 1) S) of x (..., n)."""
        b = self.base
        return x[..., b.coef_index * b.S:(b.coef_index + 1) * b.S]
