// Block-resident negacyclic NTT / inverse NTT on one polynomial held in
// shared memory.
//
// Replaces the transform inside the TPU's whole-op kernels
// (ntt_cuda_tpu/ops/fused_ops.py _fwd_chain / _inv_mul_chain, built from
// ops/ntt_pallas.py's four-step stage A / stage B with roll+select and
// u32-limb pairs).  Here the index algebra is the reference's own
// (ntt_60bit.cuh:63-265, ntt_cuda_tpu/ops/ntt.py): forward CT, natural
// order in, bit-reversed out, twiddle psi[len + psi_step]; inverse GS,
// bit-reversed in, natural out.
//
// Bound on the card: the polynomial is n u64 in shared memory (128 KB at
// n = 16384, so one block per SM) and each of the log n stages ends in a
// block barrier.  Each thread takes butterflies g = tid, tid + nt, ...;
// twiddles and their Shoup companions are read from global memory, where
// one modulus's tables (4 x 8n bytes) stay in L2.  Simple first: no
// register tiling of stages, no bank-conflict swizzle.
//
// `tid`/`nt` are the thread's index and the block's thread count; the host
// build of the tests passes 0/1, where BLOCK_SYNC is a no-op and one thread
// runs every butterfly in order.
//
// Sub-range form (`tw_mul`, default 1 = the whole polynomial): half h of a
// 2^(logn+1)-point transform runs that transform's stages 1..logn as a
// 2^logn-point one whose twiddle for local (len', ps') is
// psi[(2 + h) len' + ps'] -- the full stage has len = 2 len' and
// ps = h len' + ps'.  The caller passes tw_mul = 2 + h and the full
// polynomial's tables (a coefficient shard c of C passes C + c, or
// 2 (C + c) + h for its halves: ntt_stage.cu); stage 0 (the pairs i, i + n/2, twiddle psi[1] or
// psi^-1[1]) runs in a separate elementwise pass (ntt_stage.cu,
// fused_ops.cu) through the same two butterflies.
//
// The stage loops are templated over the word: u64 for the RNS moduli,
// u32 for the 30-bit family (ntt30.cu, kernel 22), each with its own
// butterflies and tables.

#pragma once

#include "modarith.cuh"

// One modulus's row of NTTTables.consts: q, -q^-1 mod 2^64,
// n^-1 * 2^64 mod q and its Shoup companion.
struct ModConsts {
  u64 q, qinv, ninv, ninv_sh;
};

NTT_HD ModConsts load_consts(const u64* consts, int mi) {
  ModConsts c;
  c.q = consts[4 * mi + 0];
  c.qinv = consts[4 * mi + 1];
  c.ninv = consts[4 * mi + 2];
  c.ninv_sh = consts[4 * mi + 3];
  return c;
}

// The four (r, n) twiddle tables; `at(mi, n)` selects one modulus's rows.
struct Twiddles {
  const u64* psi;
  const u64* psi_sh;
  const u64* ipsi;
  const u64* ipsi_sh;
  const u64* consts;
};

// The launchers' table arguments (tensor data pointers) as Twiddles.
static inline Twiddles make_tw(const void* psi, const void* psi_sh,
                               const void* ipsi, const void* ipsi_sh,
                               const void* consts) {
  Twiddles tw = {(const u64*)psi, (const u64*)psi_sh, (const u64*)ipsi,
                 (const u64*)ipsi_sh, (const u64*)consts};
  return tw;
}

NTT_HD Twiddles twiddles_at(Twiddles tw, int mi, int n) {
  const size_t off = (size_t)mi * n;
  Twiddles t = {tw.psi + off, tw.psi_sh + off, tw.ipsi + off, tw.ipsi_sh + off,
                tw.consts};
  return t;
}

// The two butterflies, with twiddle w and its Shoup companion ws:
// CT (a, b) -> (a + w b, a - w b); GS (a, b) -> (a + b, (a - b) w).
NTT_HD void ct_butterfly(u64& a, u64& b, u64 w, u64 ws, u64 q) {
  const u64 u = a;
  const u64 v = mul_shoup(b, w, ws, q);
  a = add_mod(u, v, q);
  b = sub_mod(u, v, q);
}

NTT_HD void gs_butterfly(u64& a, u64& b, u64 w, u64 ws, u64 q) {
  const u64 u = a, v = b;
  a = add_mod(u, v, q);
  b = mul_shoup(sub_mod(u, v, q), w, ws, q);
}

// The 30-bit family's tables (ops/ntt30.py NTTTables30): u32 psi / psi^-1
// powers with 32-bit Shoup companions floor(w 2^32 / q), and per modulus
// (q, n^-1, its companion, 0).
struct Twiddles32 {
  const u32* psi;
  const u32* psi_sh;
  const u32* ipsi;
  const u32* ipsi_sh;
  const u32* consts;
};

NTT_HD Twiddles32 twiddles_at(Twiddles32 tw, int mi, int n) {
  const size_t off = (size_t)mi * n;
  Twiddles32 t = {tw.psi + off, tw.psi_sh + off, tw.ipsi + off,
                  tw.ipsi_sh + off, tw.consts};
  return t;
}

// The same butterflies on u32 residues, every value in [0, q).
NTT_HD void ct_butterfly(u32& a, u32& b, u32 w, u32 ws, u32 q) {
  const u32 u = a;
  const u32 v = mul_shoup32(b, w, ws, q);
  a = add_mod32(u, v, q);
  b = sub_mod32(u, v, q);
}

NTT_HD void gs_butterfly(u32& a, u32& b, u32 w, u32 ws, u32 q) {
  const u32 u = a, v = b;
  a = add_mod32(u, v, q);
  b = mul_shoup32(sub_mod32(u, v, q), w, ws, q);
}

// Forward transform of s[0, 2^logn), values in [0, q) in and out; W is the
// word (u64, or u32 for the 30-bit family) and TW its tables.
template <typename W, typename TW>
NTT_HD void ntt_fwd_block(W* s, int logn, const TW& tw, W q, int tid, int nt,
                          int tw_mul = 1) {
  const int half = 1 << (logn - 1);
  BLOCK_SYNC();
  for (int lg = 0; lg < logn; ++lg) {
    const int sl = logn - 1 - lg;  // log2 of the butterfly span
    const int step = 1 << sl;
    const int len = 1 << lg;
    for (int g = tid; g < half; g += nt) {
      const int ps = g >> sl;
      const int tgt = (ps << (sl + 1)) | (g & (step - 1));
      const int w = tw_mul * len + ps;
      ct_butterfly(s[tgt], s[tgt + step], tw.psi[w], tw.psi_sh[w], q);
    }
    BLOCK_SYNC();
  }
}

// Inverse transform WITHOUT the n^-1 factor: the caller multiplies by
// n^-1 (times 2^64 when a Montgomery product came before) at the end.
template <typename W, typename TW>
NTT_HD void ntt_inv_block(W* s, int logn, const TW& tw, W q, int tid, int nt,
                          int tw_mul = 1) {
  const int half = 1 << (logn - 1);
  BLOCK_SYNC();
  for (int lg = logn - 1; lg >= 0; --lg) {
    const int sl = logn - 1 - lg;
    const int step = 1 << sl;
    const int len = 1 << lg;
    for (int g = tid; g < half; g += nt) {
      const int ps = g >> sl;
      const int tgt = (ps << (sl + 1)) | (g & (step - 1));
      const int w = tw_mul * len + ps;
      gs_butterfly(s[tgt], s[tgt + step], tw.ipsi[w], tw.ipsi_sh[w], q);
    }
    BLOCK_SYNC();
  }
}

// Threads per block for a transform of size n: every thread has at least
// one butterfly, at most 1024 threads.
static inline int ntt_threads(int n) { return n / 2 < 1024 ? n / 2 : 1024; }

// The longest polynomial one block holds in shared memory: 2^14 u64, 128 KB
// of the 227 KB a block can use (two 2^14 halves make the 2^15 transform).
#define LOG_BLOCK_MAX 14

// A launcher's return code for arguments its kernels do not take.
#ifdef __CUDACC__
#define NTT_EINVAL ((int)cudaErrorInvalidValue)
#else
#define NTT_EINVAL 1
#endif

#ifdef __CUDACC__
// Launch a block-per-polynomial kernel with sizeof(W) * 2^logb bytes of
// dynamic shared memory, at most 128 KB (2^14 u64 or 2^15 u32; above 48 KB
// only after raising the kernel's limit).
template <typename W = u64, typename K, typename... A>
static int launch_poly(K kernel, int blocks, int logb, void* stream, A... args) {
  const int nb = 1 << logb;
  const size_t smem = (size_t)nb * sizeof(W);
  if (logb < 1 || smem > (sizeof(u64) << LOG_BLOCK_MAX) || blocks < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, ntt_threads(nb), smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}
#endif
