// The decrypt tail's BEHZ residue loop and its rounding, shared by K2 and
// kernel 17 (decrypt_tail.cu) and kernel 15 (ntt_stage.cu's
// k_decrypt_cluster).
//
// kr: DecTailConsts.k2_rows (or DecPartialConsts.k2_rows, one rank's band)
// rows (q; t*gamma * inv_punctured mod q as w, ws; bcm_t (bcm_t * 2^64 mod
// t for the wide strategy); bcm_gamma mod gamma as w, ws); gl: gamma,
// -gamma^-1 mod 2^64, gamma / 2, neg_inv_q mod gamma * 2^64.
//
// Three mod-t strategies (bfv_tail._t_strategy).  Two share the code paths
// below with a runtime `pow2`: a power-of-two t (the reference's masks,
// wrapping u64 sums) and an odd t < 2^31 (Barrett by nu_t = floor(2^64 /
// t): a product of two residues below t fits 64 bits).  The third, WIDE
// (a template constant, so that the first two compile as they did), is
// for an odd t >= 2^31, where such a product does not fit: every product
// is a Montgomery product mod t on the 128-bit product (__umul64hi), as
// the JAX package's xla tail reduces (ops/poly.py fast_convert_and_round),
// with bcm_t, neg_inv_q mod t and (gamma mod t)^-1 in Montgomery form
// (their slots in kr and in the launch's neg_t / inv_gt), -t^-1 mod 2^64
// computed by each thread (t_qinv_neg), and every sum an add mod t, so x_t
// stays below t and cannot wrap.  Exact for every odd t < 2^63 (a
// Montgomery sum stays below 2t); the Python side takes t < 2^62.

#pragma once

#include "modarith.cuh"

// The BEHZ sums of coefficient k of message j over its residue rows i:
// x_t (pow2 t: the sum of (y * bcm_t) & (t-1), wrapping mod 2^64; odd t:
// mod t) and x_g (mod gamma, before the neg_inv_q multiply), where y_i =
// ((x_i +> c0_i) * t*gamma * inv_punctured) mod q_i.  Every sum is exact
// modular arithmetic, so rows summed apart and added with behz_sums_add
// give the same integers.
struct BehzSums {
  u64 xt, xg;
};

// -t^-1 mod 2^64 for odd t: Newton's iteration x <- x (2 - t x) doubles
// the bits right from x = t (t t = 1 mod 8).
NTT_HD u64 t_qinv_neg(u64 t) {
  u64 x = t;
#pragma unroll
  for (int i = 0; i < 5; ++i) x *= 2 - t * x;
  return 0 - x;
}

// Row i's terms, from its residues xv of x and cv of c0 and its row r of
// kr: y = (xv +> cv) * t*gamma * inv_punctured mod q, each constant
// product one Shoup multiply (the reference's two Montgomery products by
// constants folded into one).  A row of zero constants adds nothing,
// whatever its q and residues: mul_shoup(x, 0, 0, q) = x*0 - mulhi(x, 0)*q
// = 0 for every u64 x (the dropped modulus's row and the q = 1 pad rows of
// a rank's band).
// WIDE: tqi = t_qinv_neg(t), r[3] = bcm_t * 2^64 mod t.
template <bool WIDE>
NTT_HD void behz_row_shoup(BehzSums& acc, u64 xv, u64 cv, const u64* r,
                           u64 gamma, int pow2, u64 t, u64 nu_t, u64 tqi) {
  const u64 q = r[0];
  const u64 y = mul_shoup(add_mod_gt(xv, cv, q), r[1], r[2], q);
  if (WIDE) {
    acc.xt = add_mod(acc.xt, mont_mul(y, r[3], t, tqi), t);
  } else if (pow2) {
    acc.xt += (y * r[3]) & (t - 1);
  } else {
    acc.xt += mod_nu(mod_nu(y, t, nu_t) * r[3], t, nu_t);
    if (acc.xt >= t) acc.xt -= t;
  }
  acc.xg = add_mod(acc.xg, mul_shoup(y, r[4], r[5], gamma), gamma);
}

// K2's sums over rows i0, i0 + step, ... < rk, at most ROWS of them, every
// load issued before the first product (a member's rows in flight
// together); kr: K2's rows (behz_row_shoup).
template <int ROWS, bool WIDE>
NTT_HD BehzSums behz_sums_loaded(long long j, int k, const u64* x,
                                 const u64* c0, const u64* kr, const u64* gl,
                                 int rk, int n, int pow2, u64 t, u64 nu_t,
                                 int i0, int step) {
  u64 xv[ROWS], cv[ROWS];
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int i = i0 + u * step;
    const size_t off = ((size_t)j * rk + i) * n + k;
    xv[u] = i < rk ? x[off] : 0;
    cv[u] = i < rk ? c0[off] : 0;
  }
  const u64 tqi = WIDE ? t_qinv_neg(t) : 0;
  BehzSums acc = {0, 0};
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int i = i0 + u * step;
    if (i < rk)
      behz_row_shoup<WIDE>(acc, xv[u], cv[u], kr + 6 * i, gl[0], pow2, t,
                           nu_t, tqi);
  }
  return acc;
}

// Every row, in order (kernel 15's tail).
template <bool WIDE>
NTT_HD BehzSums behz_sums(long long j, int k, const u64* x, const u64* c0,
                          const u64* kr, u64 gamma, int rk, int n, int pow2,
                          u64 t, u64 nu_t) {
  const u64 tqi = WIDE ? t_qinv_neg(t) : 0;
  BehzSums acc = {0, 0};
  for (int i = 0; i < rk; ++i) {
    const size_t off = ((size_t)j * rk + i) * n + k;
    behz_row_shoup<WIDE>(acc, x[off], c0[off], kr + 6 * i, gamma, pow2, t,
                         nu_t, tqi);
  }
  return acc;
}

// The sums of two disjoint sets of rows: x_t a wrapping u64 add (pow2 t)
// or an add mod t, x_g an add mod gamma.
template <bool WIDE>
NTT_HD BehzSums behz_sums_add(BehzSums a, BehzSums b, const u64* gl, int pow2,
                              u64 t) {
  if (WIDE) return {add_mod(a.xt, b.xt, t), add_mod(a.xg, b.xg, gl[0])};
  BehzSums s = {a.xt + b.xt, add_mod(a.xg, b.xg, gl[0])};
  if (!pow2 && s.xt >= t) s.xt -= t;
  return s;
}

// The plaintext coefficient from the sums: the neg_inv_q scaling and
// dec_round (pow2 t: the reference's masks; odd t: exact mod t with the
// gamma^-1 undo; WIDE: the same in Montgomery form, neg_t and inv_gt
// times 2^64 mod t, as the JAX package's xla tail).
template <bool WIDE>
NTT_HD u64 dec_round(BehzSums acc, const u64* gl, int pow2, u64 t, u64 neg_t,
                     u64 nu_t, u64 inv_gt) {
  const u64 gamma = gl[0], ginv = gl[1], gdiv2 = gl[2], negg = gl[3];
  const u64 mask = t - 1;
  u64 xt = acc.xt;
  const u64 xg = mont_mul(acc.xg, negg, gamma, ginv);
  if (WIDE) {
    const u64 tqi = t_qinv_neg(t);
    xt = mont_mul(xt, neg_t, t, tqi);
    const u64 corr = xg > gdiv2 ? add_mod(xt, mod_nu(gamma - xg, t, nu_t), t)
                                : sub_mod(xt, mod_nu(xg, t, nu_t), t);
    return mont_mul(corr, inv_gt, t, tqi);
  }
  if (pow2) {
    xt = ((xt & mask) * neg_t) & mask;
    return (xg > gdiv2 ? xt + (gamma - xg) : xt - xg) & mask;
  }
  xt = mod_nu(xt * neg_t, t, nu_t);
  u64 plus = xt + mod_nu(gamma - xg, t, nu_t);
  if (plus >= t) plus -= t;
  u64 minus = xt + t - mod_nu(xg, t, nu_t);
  if (minus >= t) minus -= t;
  return mod_nu((xg > gdiv2 ? plus : minus) * inv_gt, t, nu_t);
}
