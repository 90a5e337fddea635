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
// Kernel 17, decrypt_tail_partial, replaces ntt_cuda_tpu/ops/bfv_tail.py
// decrypt_tail_partial (bfv_tail.py:886, pallas_call :908): one rank of the
// RNS-sharded decrypt runs the same residue loop over its own rows (the
// dropped modulus's and any pad rows give 0: their padded constants are 0)
// and stops before the scaling and rounding.  It writes the rank's two
// partial sums, which the caller all-reduces and rounds
// (bfv_tail.dec_round_from_sums): x_t as the low 32 bits of the sum for pow2
// t (the TPU kernel's wrapping u32 sum, bfv_tail.py:275-279), below t for
// odd t; x_g below gamma, before the neg_inv_q multiply.  Bound as above:
// 16 rl bytes read and 16 written per coefficient.

#include "behz_sums.cuh"

NTT_HD void decrypt_tail_body(long long idx, const u64* x, const u64* c0,
                              u64* out, const u64* pm, const u64* gl, int rk,
                              int n, int pow2, u64 t, u64 neg_t, u64 nu_t,
                              u64 inv_gt) {
  out[idx] = dec_round(
      behz_sums(idx / n, (int)(idx % n), x, c0, pm, gl, rk, n, pow2, t, nu_t),
      gl, pow2, t, neg_t, nu_t, inv_gt);
}

// Kernel 17: coefficient k's partial sums over the rank's rl rows, x_t to
// out[k] (its low 32 bits) and x_g to out[n + k].
NTT_HD void decrypt_partial_body(long long k, const u64* x, const u64* c0,
                                 u64* out, const u64* pm, const u64* gl, int rl,
                                 int n, int pow2, u64 t, u64 nu_t) {
  const BehzSums acc = behz_sums(0, (int)k, x, c0, pm, gl, rl, n, pow2, t, nu_t);
  out[k] = acc.xt & 0xFFFFFFFFull;
  out[n + k] = acc.xg;
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

__global__ void k_decrypt_partial(const u64* x, const u64* c0, u64* out,
                                  const u64* pm, const u64* gl, int rl, int n,
                                  int pow2, u64 t, u64 nu_t) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < n) decrypt_partial_body(k, x, c0, out, pm, gl, rl, n, pow2, t, nu_t);
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

extern "C" int ntt_decrypt_tail_partial(const void* x, const void* c0,
                                        void* out, const void* pm,
                                        const void* gl, int rl, int n, int pow2,
                                        u64 t, u64 nu_t, void* stream) {
  if (n < 1 || rl < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  k_decrypt_partial<<<(n + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(
      (const u64*)x, (const u64*)c0, (u64*)out, (const u64*)pm,
      (const u64*)gl, rl, n, pow2, t, nu_t);
  return (int)cudaGetLastError();
}

#else  // host build for the CPU tests

extern "C" int ntt_decrypt_tail(const void* x, const void* c0, void* out,
                                const void* pm, const void* gl, int J, int rk,
                                int n, int pow2, u64 t, u64 neg_t, u64 nu_t,
                                u64 inv_gt, void*) {
  if ((long long)J * n < 1 || rk < 1) return 1;
  for (long long idx = 0; idx < (long long)J * n; ++idx)
    decrypt_tail_body(idx, (const u64*)x, (const u64*)c0, (u64*)out,
                      (const u64*)pm, (const u64*)gl, rk, n, pow2, t, neg_t,
                      nu_t, inv_gt);
  return 0;
}

extern "C" int ntt_decrypt_tail_partial(const void* x, const void* c0,
                                        void* out, const void* pm,
                                        const void* gl, int rl, int n, int pow2,
                                        u64 t, u64 nu_t, void*) {
  if (n < 1 || rl < 1) return 1;
  for (long long k = 0; k < n; ++k)
    decrypt_partial_body(k, (const u64*)x, (const u64*)c0, (u64*)out,
                         (const u64*)pm, (const u64*)gl, rl, n, pow2, t, nu_t);
  return 0;
}

#endif
