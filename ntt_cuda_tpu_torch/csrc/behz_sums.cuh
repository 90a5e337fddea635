// The decrypt tail's BEHZ residue loop and its rounding, shared by K2 and
// kernel 17 (decrypt_tail.cu) and kernel 15 (ntt_stage.cu's
// k_decrypt_fused).
//
// pm: DecTailConsts.per_mod rows (q, -q^-1, t*gamma * 2^64, inv_punctured
// * 2^64, bcm_t, bcm_gamma * 2^64 mod gamma); gl: gamma, -gamma^-1 mod
// 2^64, gamma / 2, neg_inv_q mod gamma * 2^64.

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

// Row i's terms of the sums, from its residues xv of x and cv of c0.
NTT_HD void behz_row(BehzSums& acc, u64 xv, u64 cv, const u64* p,
                     const u64* gl, int pow2, u64 t, u64 nu_t) {
  const u64 gamma = gl[0], ginv = gl[1];
  const u64 q = p[0], qinv = p[1];
  const u64 s = add_mod_gt(xv, cv, q);  // poly_add_xq_d quirk
  const u64 y = mont_mul(mont_mul(s, p[2], q, qinv), p[3], q, qinv);
  if (pow2) {
    acc.xt += (y * p[4]) & (t - 1);
  } else {
    acc.xt += mod_nu(mod_nu(y, t, nu_t) * p[4], t, nu_t);
    if (acc.xt >= t) acc.xt -= t;
  }
  acc.xg = add_mod(acc.xg, mont_mul(y, p[5], gamma, ginv), gamma);
}

// Row i's terms from K2's own constants (DecTailConsts.k2_rows, r: q;
// t*gamma * inv_punctured mod q as w, ws; bcm_t; bcm_gamma mod gamma as w,
// ws): the same y and terms as behz_row, each constant product one Shoup
// multiply instead of a Montgomery product (the two of y folded into one).
NTT_HD void behz_row_shoup(BehzSums& acc, u64 xv, u64 cv, const u64* r,
                           u64 gamma, int pow2, u64 t, u64 nu_t) {
  const u64 q = r[0];
  const u64 y = mul_shoup(add_mod_gt(xv, cv, q), r[1], r[2], q);
  if (pow2) {
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
template <int ROWS>
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
  BehzSums acc = {0, 0};
#pragma unroll
  for (int u = 0; u < ROWS; ++u) {
    const int i = i0 + u * step;
    if (i < rk)
      behz_row_shoup(acc, xv[u], cv[u], kr + 6 * i, gl[0], pow2, t, nu_t);
  }
  return acc;
}

// Every row, in order (kernels 15 and 17).
NTT_HD BehzSums behz_sums(long long j, int k, const u64* x, const u64* c0,
                          const u64* pm, const u64* gl, int rk, int n, int pow2,
                          u64 t, u64 nu_t) {
  BehzSums acc = {0, 0};
  for (int i = 0; i < rk; ++i) {
    const size_t off = ((size_t)j * rk + i) * n + k;
    behz_row(acc, x[off], c0[off], pm + 6 * i, gl, pow2, t, nu_t);
  }
  return acc;
}

// The sums of two disjoint sets of rows: x_t a wrapping u64 add (pow2 t)
// or an add mod t, x_g an add mod gamma.
NTT_HD BehzSums behz_sums_add(BehzSums a, BehzSums b, const u64* gl, int pow2,
                              u64 t) {
  BehzSums s = {a.xt + b.xt, add_mod(a.xg, b.xg, gl[0])};
  if (!pow2 && s.xt >= t) s.xt -= t;
  return s;
}

// The plaintext coefficient from the sums: the neg_inv_q scaling and
// dec_round (pow2 t: the reference's masks; odd t: exact mod t with the
// gamma^-1 undo).
NTT_HD u64 dec_round(BehzSums acc, const u64* gl, int pow2, u64 t, u64 neg_t,
                     u64 nu_t, u64 inv_gt) {
  const u64 gamma = gl[0], ginv = gl[1], gdiv2 = gl[2], negg = gl[3];
  const u64 mask = t - 1;
  u64 xt = acc.xt;
  const u64 xg = mont_mul(acc.xg, negg, gamma, ginv);
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
