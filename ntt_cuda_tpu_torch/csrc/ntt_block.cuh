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

NTT_HD Twiddles twiddles_at(Twiddles tw, int mi, int n) {
  const size_t off = (size_t)mi * n;
  Twiddles t = {tw.psi + off, tw.psi_sh + off, tw.ipsi + off, tw.ipsi_sh + off,
                tw.consts};
  return t;
}

// Forward transform of s[0, 2^logn), values in [0, q) in and out.
NTT_HD void ntt_fwd_block(u64* s, int logn, const Twiddles& tw, u64 q, int tid,
                          int nt) {
  const int half = 1 << (logn - 1);
  BLOCK_SYNC();
  for (int lg = 0; lg < logn; ++lg) {
    const int sl = logn - 1 - lg;  // log2 of the butterfly span
    const int step = 1 << sl;
    const int len = 1 << lg;
    for (int g = tid; g < half; g += nt) {
      const int ps = g >> sl;
      const int tgt = (ps << (sl + 1)) | (g & (step - 1));
      const u64 u = s[tgt];
      const u64 v = mul_shoup(s[tgt + step], tw.psi[len + ps],
                              tw.psi_sh[len + ps], q);
      s[tgt] = add_mod(u, v, q);
      s[tgt + step] = sub_mod(u, v, q);
    }
    BLOCK_SYNC();
  }
}

// Inverse transform WITHOUT the n^-1 factor: the caller multiplies by
// n^-1 (times 2^64 when a Montgomery product came before) at the end.
NTT_HD void ntt_inv_block(u64* s, int logn, const Twiddles& tw, u64 q, int tid,
                          int nt) {
  const int half = 1 << (logn - 1);
  BLOCK_SYNC();
  for (int lg = logn - 1; lg >= 0; --lg) {
    const int sl = logn - 1 - lg;
    const int step = 1 << sl;
    const int len = 1 << lg;
    for (int g = tid; g < half; g += nt) {
      const int ps = g >> sl;
      const int tgt = (ps << (sl + 1)) | (g & (step - 1));
      const u64 u = s[tgt];
      const u64 v = s[tgt + step];
      s[tgt] = add_mod(u, v, q);
      s[tgt + step] = mul_shoup(sub_mod(u, v, q), tw.ipsi[len + ps],
                                tw.ipsi_sh[len + ps], q);
    }
    BLOCK_SYNC();
  }
}

// Threads per block for a transform of size n: every thread has at least
// one butterfly, at most 1024 threads.
static inline int ntt_threads(int n) { return n / 2 < 1024 ? n / 2 : 1024; }
