// u64 modular arithmetic shared by every kernel of the port.
//
// Counterpart of ntt_cuda_tpu/ops/modmath.py and ops/limb32.py.  The TPU
// emulates 64-bit products from u32 limbs; Hopper has native u64 lanes and
// __umul64hi, so each primitive here is a handful of instructions:
//   * add/sub with one conditional correction (values < q < 2^62);
//   * Shoup multiply by a constant w with companion floor(w 2^64 / q);
//   * Montgomery REDC (R = 2^64) for products of two runtime operands;
//   * Barrett reduction of any u64 by nu = floor(2^64 / q);
//   * and for the 30-bit family's u32 residues, add/sub and a 32-bit Shoup
//     multiply on __umulhi.
// All functions are __host__ __device__: the same header builds with g++
// (no CUDA compiler) so that the CPU tests can run the kernel bodies.

#pragma once

#include <stddef.h>
#include <stdint.h>

typedef unsigned long long u64;
typedef unsigned int u32;

#ifdef __CUDACC__
#define NTT_HD static __host__ __device__ __forceinline__
#else
#define NTT_HD static inline
#endif

#ifdef __CUDA_ARCH__
#define BLOCK_SYNC() __syncthreads()
#else
// Host code (the tests' build): one thread per block, so a barrier is a
// no-op.
#define BLOCK_SYNC() ((void)0)
#endif

NTT_HD u64 mulhi64(u64 a, u64 b) {
#ifdef __CUDA_ARCH__
  return __umul64hi(a, b);
#else
  return (u64)(((unsigned __int128)a * b) >> 64);
#endif
}

// (a + b) mod q, a and b in [0, q).
NTT_HD u64 add_mod(u64 a, u64 b, u64 q) {
  u64 s = a + b;
  return s >= q ? s - q : s;
}

// poly_add's strict-`>` quirk (poly_arithmetic.cuh:143-153): a sum equal
// to exactly q stays unreduced.  Reproduced, not fixed.
NTT_HD u64 add_mod_gt(u64 a, u64 b, u64 q) {
  u64 s = a + b;
  return s > q ? s - q : s;
}

// (a - b) mod q, a and b in [0, q].
NTT_HD u64 sub_mod(u64 a, u64 b, u64 q) {
  return a >= b ? a - b : a + q - b;
}

// -(a + b) mod q with the 0 fixup (poly_add_negate_xq, bfv_keygen.cuh:81-93).
NTT_HD u64 add_neg_mod(u64 a, u64 b, u64 q) {
  const u64 neg = q - add_mod(a, b, q);
  return neg == q ? 0 : neg;
}

// x * w mod q for any u64 x and a constant w < q with ws = floor(w 2^64 / q).
// x*w - floor(x*ws / 2^64)*q lies in [0, 2q).
NTT_HD u64 mul_shoup(u64 x, u64 w, u64 ws, u64 q) {
  u64 r = x * w - mulhi64(x, ws) * q;
  return r >= q ? r - q : r;
}

// Montgomery product a * b * 2^-64 mod q for any u64 a and b < q, q odd
// and below 2^62 (qinv_neg = -q^-1 mod 2^64).  The sum before the final
// subtract is below 2q.  The low half of m*q is -lo mod 2^64, so the carry
// out of the low halves is (lo != 0).
NTT_HD u64 mont_mul(u64 a, u64 b, u64 q, u64 qinv_neg) {
  u64 lo = a * b;
  u64 hi = mulhi64(a, b);
  u64 m = lo * qinv_neg;
  u64 t = hi + mulhi64(m, q) + (lo != 0 ? 1ull : 0ull);
  return t >= q ? t - q : t;
}

// x mod q for any u64 x, nu = floor(2^64 / q): the estimate is short by at
// most one q.
NTT_HD u64 mod_nu(u64 x, u64 q, u64 nu) {
  u64 r = x - mulhi64(x, nu) * q;
  return r >= q ? r - q : r;
}

// --- u32 arithmetic of the 30-bit family (q < 2^30), kernel 22 ----------

NTT_HD u32 mulhi32(u32 a, u32 b) {
#ifdef __CUDA_ARCH__
  return __umulhi(a, b);
#else
  return (u32)(((u64)a * b) >> 32);
#endif
}

NTT_HD u32 add_mod32(u32 a, u32 b, u32 q) {
  const u32 s = a + b;
  return s >= q ? s - q : s;
}

NTT_HD u32 sub_mod32(u32 a, u32 b, u32 q) { return a >= b ? a - b : a + q - b; }

// x * w mod q for any u32 x and a constant w < q < 2^30 with
// ws = floor(w 2^32 / q): x*w - mulhi(x, ws)*q (mod 2^32) lies in [0, 2q)
// (Shoup at half width, ntt_cuda_tpu/ops/ntt_pallas30.py _shoup32).
NTT_HD u32 mul_shoup32(u32 x, u32 w, u32 ws, u32 q) {
  const u32 r = x * w - mulhi32(x, ws) * q;
  return r >= q ? r - q : r;
}

// Compact draws -> residue mod q (sampling.ternary / sampling.gaussian):
// a negative value d maps to q + d.
NTT_HD u64 small_res(int d, u64 q) {
  return d < 0 ? q - (u64)(-(long long)d) : (u64)d;
}
