// The decrypt tail's BEHZ residue loop and its rounding, shared by K2 and
// kernel 17 (decrypt_tail.cu) and kernel 15 (ntt_stage.cu's
// k_decrypt_fused).
//
// pm: DecTailConsts.per_mod rows (q, -q^-1, t*gamma * 2^64, inv_punctured
// * 2^64, bcm_t, bcm_gamma * 2^64 mod gamma); gl: gamma, -gamma^-1 mod
// 2^64, gamma / 2, neg_inv_q mod gamma * 2^64.

#pragma once

#include "modarith.cuh"

// The BEHZ sums of coefficient k of message j over the rk residue rows: x_t
// (pow2 t: the sum of (y * bcm_t) & (t-1), wrapping mod 2^64; odd t: mod t)
// and x_g (mod gamma, before the neg_inv_q multiply), where y_i =
// ((x_i +> c0_i) * t*gamma * inv_punctured) mod q_i.
struct BehzSums {
  u64 xt, xg;
};

NTT_HD BehzSums behz_sums(long long j, int k, const u64* x, const u64* c0,
                          const u64* pm, const u64* gl, int rk, int n, int pow2,
                          u64 t, u64 nu_t) {
  const u64 gamma = gl[0], ginv = gl[1];
  const u64 mask = t - 1;
  BehzSums acc = {0, 0};
  for (int i = 0; i < rk; ++i) {
    const u64* p = pm + 6 * i;
    const u64 q = p[0], qinv = p[1];
    const size_t off = ((size_t)j * rk + i) * n + k;
    const u64 s = add_mod_gt(x[off], c0[off], q);  // poly_add_xq_d quirk
    const u64 y = mont_mul(mont_mul(s, p[2], q, qinv), p[3], q, qinv);
    if (pow2) {
      acc.xt += (y * p[4]) & mask;
    } else {
      acc.xt += mod_nu(mod_nu(y, t, nu_t) * p[4], t, nu_t);
      if (acc.xt >= t) acc.xt -= t;
    }
    acc.xg = add_mod(acc.xg, mont_mul(y, p[5], gamma, ginv), gamma);
  }
  return acc;
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
