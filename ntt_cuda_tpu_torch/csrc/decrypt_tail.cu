// Decryption tail: (x +> c0) * t*gamma * inv_punctured mod q_i, the BEHZ
// fast conversion to {t, gamma}, and dec_round.
//
// Replaces the TPU kernel ntt_cuda_tpu/ops/bfv_tail.py decrypt_tail
// (bfv_tail.py:388, pallas_call :416).  The TPU grid walks the r-1
// residues in order and carries the two sums in VMEM scratch
// (bfv_tail.py:365-383); blocks on the card run in no order, so here one
// thread owns one coefficient of one message and loops over the residues
// itself.  Every sum is exact modular arithmetic, so the result does not
// depend on the order.
//
// Bound on the card: device memory, 16 (r-1) bytes read and 8 written per
// coefficient, about 6 Montgomery products per residue.  Coalesced:
// neighbouring threads read neighbouring coefficients of one residue row.
//
// Mod-t strategy (bfv_tail._t_strategy): pow2 t uses the reference's mask
// forms (poly_arithmetic.cuh:217-268); odd t < 2^31 reduces by Barrett with
// nu_t = floor(2^64 / t) and ends with the gamma^-1 mod t undo.
//
// pm: DecTailConsts.per_mod rows (q, -q^-1, t*gamma * 2^64, inv_punctured
// * 2^64, bcm_t, bcm_gamma * 2^64 mod gamma); gl: gamma, -gamma^-1 mod
// 2^64, gamma / 2, neg_inv_q mod gamma * 2^64.

#include "modarith.cuh"

NTT_HD void decrypt_tail_body(long long idx, const u64* x, const u64* c0,
                              u64* out, const u64* pm, const u64* gl, int rk,
                              int n, int pow2, u64 t, u64 neg_t, u64 nu_t,
                              u64 inv_gt) {
  const long long j = idx / n;
  const int k = (int)(idx % n);
  const u64 gamma = gl[0], ginv = gl[1], gdiv2 = gl[2], negg = gl[3];
  const u64 mask = t - 1;
  u64 xt = 0, xg = 0;
  for (int i = 0; i < rk; ++i) {
    const u64* p = pm + 6 * i;
    const u64 q = p[0], qinv = p[1];
    const size_t off = ((size_t)j * rk + i) * n + k;
    const u64 s = add_mod_gt(x[off], c0[off], q);  // poly_add_xq_d quirk
    const u64 y = mont_mul(mont_mul(s, p[2], q, qinv), p[3], q, qinv);
    if (pow2) {
      xt += (y * p[4]) & mask;
    } else {
      xt += mod_nu(mod_nu(y, t, nu_t) * p[4], t, nu_t);
      if (xt >= t) xt -= t;
    }
    xg = add_mod(xg, mont_mul(y, p[5], gamma, ginv), gamma);
  }
  xg = mont_mul(xg, negg, gamma, ginv);
  u64 res;
  if (pow2) {
    xt = ((xt & mask) * neg_t) & mask;
    res = (xg > gdiv2 ? xt + (gamma - xg) : xt - xg) & mask;
  } else {
    xt = mod_nu(xt * neg_t, t, nu_t);
    u64 plus = xt + mod_nu(gamma - xg, t, nu_t);
    if (plus >= t) plus -= t;
    u64 minus = xt + t - mod_nu(xg, t, nu_t);
    if (minus >= t) minus -= t;
    res = mod_nu((xg > gdiv2 ? plus : minus) * inv_gt, t, nu_t);
  }
  out[idx] = res;
}

#ifdef __CUDACC__

__global__ void k_decrypt_tail(const u64* x, const u64* c0, u64* out,
                               const u64* pm, const u64* gl, int rk, int n,
                               int pow2, u64 t, u64 neg_t, u64 nu_t, u64 inv_gt,
                               long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < total)
    decrypt_tail_body(idx, x, c0, out, pm, gl, rk, n, pow2, t, neg_t, nu_t,
                      inv_gt);
}

extern "C" int ntt_decrypt_tail(const void* x, const void* c0, void* out,
                                const void* pm, const void* gl, int J, int rk,
                                int n, int pow2, u64 t, u64 neg_t, u64 nu_t,
                                u64 inv_gt, void* stream) {
  const long long total = (long long)J * n;
  if (total < 1 || rk < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  k_decrypt_tail<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const u64*)x, (const u64*)c0, (u64*)out, (const u64*)pm,
      (const u64*)gl, rk, n, pow2, t, neg_t, nu_t, inv_gt, total);
  return (int)cudaGetLastError();
}

#else  // host build for the CPU tests

extern "C" int ntt_decrypt_tail(const void* x, const void* c0, void* out,
                                const void* pm, const void* gl, int J, int rk,
                                int n, int pow2, u64 t, u64 neg_t, u64 nu_t,
                                u64 inv_gt, void*) {
  for (long long idx = 0; idx < (long long)J * n; ++idx)
    decrypt_tail_body(idx, (const u64*)x, (const u64*)c0, (u64*)out,
                      (const u64*)pm, (const u64*)gl, rk, n, pow2, t, neg_t,
                      nu_t, inv_gt);
  return 0;
}

#endif
