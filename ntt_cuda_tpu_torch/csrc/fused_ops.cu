// Whole-op transform kernels: half_polymul, keygen_fused, encrypt_fused.
//
// Replace the TPU kernels of ntt_cuda_tpu/ops/fused_ops.py:
//   half_polymul  (fused_ops.py:213, pallas_call :260)
//   keygen_fused  (fused_ops.py:137, pallas_call :174)
//   encrypt_fused (fused_ops.py:466, pallas_call :541)
// Each block owns one polynomial (message x modulus).  It stays in dynamic
// shared memory while the forward -> dyadic -> inverse chain runs in place
// (ntt_block.cuh).  The dyadic product is one Montgomery REDC; its 2^-64
// and the inverse's n^-1 cancel in one Shoup multiply by n^-1 * 2^64 at
// the end.
//
// Bound on the card: shared memory, 8n bytes per block (128 KB at
// n = 16384: one block per SM, so a call fills r x J of the 132 SMs), and
// log n barriers per transform.  The design keeps every intermediate of an
// op out of device memory except where noted, and reads compact i32 draws
// (the ternary u and s, the Gaussian e) instead of (r, n) u64 residues.
//
// encrypt_fused cannot carry the last residue across grid steps as the TPU
// grid does (fused_ops.py:397-407): blocks run in no order.  It is two
// launches: a transform launch writing c_h +> e_h for all r moduli to a
// (J, 2, r, n) scratch, and an elementwise tail launch (modulus drop,
// Delta*m + fix).  NTT(u) is computed once per (message, modulus) and
// parked in the half-1 scratch slot while half 0 uses shared memory.

#include "ntt_block.cuh"

#ifndef __CUDACC__
#include <vector>
#endif

// --- half_polymul: out[b] = INTT(NTT(x[b]) (.) y[b % r]) -------------------

NTT_HD void half_polymul_body(int b, int tid, int nt, u64* s, const u64* x,
                              const u64* y, u64* out, Twiddles tw, int r,
                              int logn) {
  const int n = 1 << logn;
  const int mi = b % r;
  const ModConsts c = load_consts(tw.consts, mi);
  const Twiddles t = twiddles_at(tw, mi, n);
  const u64* xb = x + (size_t)b * n;
  const u64* yb = y + (size_t)mi * n;
  u64* ob = out + (size_t)b * n;
  for (int i = tid; i < n; i += nt) s[i] = xb[i];
  ntt_fwd_block(s, logn, t, c.q, tid, nt);
  for (int i = tid; i < n; i += nt) s[i] = mont_mul(s[i], yb[i], c.q, c.qinv);
  ntt_inv_block(s, logn, t, c.q, tid, nt);
  for (int i = tid; i < n; i += nt)
    ob[i] = mul_shoup(s[i], c.ninv, c.ninv_sh, c.q);
}

// --- keygen_fused: per modulus, sk = NTT(s); pk0 = NTT(-(INTT(a . sk) + e)) --

NTT_HD void keygen_body(int mi, int tid, int nt, u64* s, const int* sb,
                        const u64* a, const int* ed, u64* sk, u64* pk0,
                        Twiddles tw, int logn) {
  const int n = 1 << logn;
  const ModConsts c = load_consts(tw.consts, mi);
  const Twiddles t = twiddles_at(tw, mi, n);
  const size_t off = (size_t)mi * n;
  for (int i = tid; i < n; i += nt) s[i] = small_res(sb[i], c.q);
  ntt_fwd_block(s, logn, t, c.q, tid, nt);
  for (int i = tid; i < n; i += nt) {
    sk[off + i] = s[i];
    s[i] = mont_mul(a[off + i], s[i], c.q, c.qinv);
  }
  ntt_inv_block(s, logn, t, c.q, tid, nt);
  for (int i = tid; i < n; i += nt) {
    // -(x + e) mod q with the 0 fixup (poly_add_negate_xq)
    const u64 x = mul_shoup(s[i], c.ninv, c.ninv_sh, c.q);
    const u64 neg = c.q - add_mod(x, small_res(ed[i], c.q), c.q);
    s[i] = neg == c.q ? 0 : neg;
  }
  ntt_fwd_block(s, logn, t, c.q, tid, nt);
  for (int i = tid; i < n; i += nt) pk0[off + i] = s[i];
}

// --- encrypt_fused, launch 1: scratch[j, h, mi] = INTT(NTT(u_j) . pk_h) +> e_jh

NTT_HD void encrypt_transform_body(int b, int tid, int nt, u64* s,
                                   const int* ub, const u64* pk, const int* ed,
                                   u64* scratch, Twiddles tw, int r, int logn) {
  const int n = 1 << logn;
  const int j = b / r;
  const int mi = b % r;
  const ModConsts c = load_consts(tw.consts, mi);
  const Twiddles t = twiddles_at(tw, mi, n);
  u64* c0 = scratch + ((size_t)(2 * j) * r + mi) * n;
  u64* c1 = scratch + ((size_t)(2 * j + 1) * r + mi) * n;
  const u64* pk0 = pk + (size_t)mi * n;
  const u64* pk1 = pk + ((size_t)r + mi) * n;
  const int* e0 = ed + (size_t)(2 * j) * n;
  const int* e1 = ed + (size_t)(2 * j + 1) * n;
  const int* u = ub + (size_t)j * n;
  for (int i = tid; i < n; i += nt) s[i] = small_res(u[i], c.q);
  ntt_fwd_block(s, logn, t, c.q, tid, nt);
  for (int i = tid; i < n; i += nt) {
    c1[i] = s[i];  // NTT(u), read back by this same thread below
    s[i] = mont_mul(s[i], pk0[i], c.q, c.qinv);
  }
  ntt_inv_block(s, logn, t, c.q, tid, nt);
  for (int i = tid; i < n; i += nt) {
    c0[i] = add_mod_gt(mul_shoup(s[i], c.ninv, c.ninv_sh, c.q),
                       small_res(e0[i], c.q), c.q);
    s[i] = mont_mul(c1[i], pk1[i], c.q, c.qinv);
  }
  ntt_inv_block(s, logn, t, c.q, tid, nt);
  for (int i = tid; i < n; i += nt)
    c1[i] = add_mod_gt(mul_shoup(s[i], c.ninv, c.ninv_sh, c.q),
                       small_res(e1[i], c.q), c.q);
}

// --- encrypt_fused, launch 2: the modulus drop and Delta*m + fix ----------
// tc: TailConsts.per_mod rows (q, -q^-1, nu, half_mod, inv_q_last * 2^64,
// q_i / t); one thread per output coefficient of ct (J, 2, r-1, n).  With
// m null it is the modulus drop alone: the key switch's last launch
// (divide_and_round_q_last of the accumulated (J, 2, r, n) pair).

NTT_HD void encrypt_tail_body(long long idx, const u64* scratch,
                              const long long* m, u64* ct, const u64* tc,
                              u64 q_last, u64 half, u64 fix_th, int r, int n) {
  const int rk = r - 1;
  const int k = (int)(idx % n);
  long long rest = idx / n;
  const int ki = (int)(rest % rk);
  rest /= rk;
  const int h = (int)(rest % 2);
  const long long j = rest / 2;
  const u64* p = tc + 6 * ki;
  const u64 q = p[0], qinv = p[1], nu = p[2], half_mod = p[3], invq = p[4],
            qi_div_t = p[5];
  const size_t base = (size_t)(2 * j + h) * r;
  const u64 sv = scratch[(base + ki) * n + k];
  u64 ra = scratch[(base + rk) * n + k] + half;
  if (ra >= q_last) ra -= q_last;
  u64 tmp = mod_nu(ra, q, nu);
  tmp = tmp < half_mod ? tmp + q - half_mod : tmp - half_mod;
  const u64 v = sv < tmp ? sv + q - tmp : sv - tmp;
  u64 out = mont_mul(v, invq, q, qinv);
  if (h == 0 && m) {
    const u64 mm = (u64)m[j * n + k];
    out = mod_nu(out + mm * qi_div_t + (mm >= fix_th ? 1ull : 0ull), q, nu);
  }
  ct[idx] = out;
}

#ifdef __CUDACC__

__global__ void k_half_polymul(const u64* x, const u64* y, u64* out,
                               Twiddles tw, int r, int logn) {
  extern __shared__ u64 smem[];
  half_polymul_body(blockIdx.x, threadIdx.x, blockDim.x, smem, x, y, out, tw,
                    r, logn);
}

__global__ void k_keygen(const int* sb, const u64* a, const int* ed, u64* sk,
                         u64* pk0, Twiddles tw, int logn) {
  extern __shared__ u64 smem[];
  keygen_body(blockIdx.x, threadIdx.x, blockDim.x, smem, sb, a, ed, sk, pk0,
              tw, logn);
}

__global__ void k_encrypt_transform(const int* ub, const u64* pk, const int* ed,
                                    u64* scratch, Twiddles tw, int r,
                                    int logn) {
  extern __shared__ u64 smem[];
  encrypt_transform_body(blockIdx.x, threadIdx.x, blockDim.x, smem, ub, pk, ed,
                         scratch, tw, r, logn);
}

__global__ void k_encrypt_tail(const u64* scratch, const long long* m, u64* ct,
                               const u64* tc, u64 q_last, u64 half, u64 fix_th,
                               int r, int n, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < total)
    encrypt_tail_body(idx, scratch, m, ct, tc, q_last, half, fix_th, r, n);
}

extern "C" int ntt_half_polymul(const void* x, const void* y, void* out,
                                const void* psi, const void* psi_sh,
                                const void* ipsi, const void* ipsi_sh,
                                const void* consts, int blocks, int r, int logn,
                                void* stream) {
  return launch_poly(k_half_polymul, blocks, logn, stream, (const u64*)x,
                     (const u64*)y, (u64*)out,
                     make_tw(psi, psi_sh, ipsi, ipsi_sh, consts), r, logn);
}

extern "C" int ntt_keygen_fused(const void* sb, const void* a, const void* ed,
                                void* sk, void* pk0, const void* psi,
                                const void* psi_sh, const void* ipsi,
                                const void* ipsi_sh, const void* consts, int r,
                                int logn, void* stream) {
  return launch_poly(k_keygen, r, logn, stream, (const int*)sb, (const u64*)a,
                     (const int*)ed, (u64*)sk, (u64*)pk0,
                     make_tw(psi, psi_sh, ipsi, ipsi_sh, consts), logn);
}

extern "C" int ntt_encrypt_transform(const void* ub, const void* pk,
                                     const void* ed, void* scratch,
                                     const void* psi, const void* psi_sh,
                                     const void* ipsi, const void* ipsi_sh,
                                     const void* consts, int J, int r, int logn,
                                     void* stream) {
  return launch_poly(k_encrypt_transform, J * r, logn, stream, (const int*)ub,
                     (const u64*)pk, (const int*)ed, (u64*)scratch,
                     make_tw(psi, psi_sh, ipsi, ipsi_sh, consts), r, logn);
}

extern "C" int ntt_encrypt_tail(const void* scratch, const void* m, void* ct,
                                const void* tc, u64 q_last, u64 half,
                                u64 fix_th, int J, int r, int n, void* stream) {
  const long long total = (long long)J * 2 * (r - 1) * n;
  if (total < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  k_encrypt_tail<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const u64*)scratch, (const long long*)m, (u64*)ct, (const u64*)tc,
      q_last, half, fix_th, r, n, total);
  return (int)cudaGetLastError();
}

#else  // host build for the CPU tests: one thread per block, blocks in order

extern "C" int ntt_half_polymul(const void* x, const void* y, void* out,
                                const void* psi, const void* psi_sh,
                                const void* ipsi, const void* ipsi_sh,
                                const void* consts, int blocks, int r, int logn,
                                void*) {
  std::vector<u64> s((size_t)1 << logn);
  const Twiddles tw = make_tw(psi, psi_sh, ipsi, ipsi_sh, consts);
  for (int b = 0; b < blocks; ++b)
    half_polymul_body(b, 0, 1, s.data(), (const u64*)x, (const u64*)y,
                      (u64*)out, tw, r, logn);
  return 0;
}

extern "C" int ntt_keygen_fused(const void* sb, const void* a, const void* ed,
                                void* sk, void* pk0, const void* psi,
                                const void* psi_sh, const void* ipsi,
                                const void* ipsi_sh, const void* consts, int r,
                                int logn, void*) {
  std::vector<u64> s((size_t)1 << logn);
  const Twiddles tw = make_tw(psi, psi_sh, ipsi, ipsi_sh, consts);
  for (int mi = 0; mi < r; ++mi)
    keygen_body(mi, 0, 1, s.data(), (const int*)sb, (const u64*)a,
                (const int*)ed, (u64*)sk, (u64*)pk0, tw, logn);
  return 0;
}

extern "C" int ntt_encrypt_transform(const void* ub, const void* pk,
                                     const void* ed, void* scratch,
                                     const void* psi, const void* psi_sh,
                                     const void* ipsi, const void* ipsi_sh,
                                     const void* consts, int J, int r, int logn,
                                     void*) {
  std::vector<u64> s((size_t)1 << logn);
  const Twiddles tw = make_tw(psi, psi_sh, ipsi, ipsi_sh, consts);
  for (int b = 0; b < J * r; ++b)
    encrypt_transform_body(b, 0, 1, s.data(), (const int*)ub, (const u64*)pk,
                           (const int*)ed, (u64*)scratch, tw, r, logn);
  return 0;
}

extern "C" int ntt_encrypt_tail(const void* scratch, const void* m, void* ct,
                                const void* tc, u64 q_last, u64 half,
                                u64 fix_th, int J, int r, int n, void*) {
  const long long total = (long long)J * 2 * (r - 1) * n;
  for (long long idx = 0; idx < total; ++idx)
    encrypt_tail_body(idx, (const u64*)scratch, (const long long*)m, (u64*)ct,
                      (const u64*)tc, q_last, half, fix_th, r, n);
  return 0;
}

#endif
