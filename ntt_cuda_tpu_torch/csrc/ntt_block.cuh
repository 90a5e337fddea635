// The negacyclic NTT's butterflies and a block's local stages on its
// range of one polynomial in shared memory.
//
// Replaces the transform inside the TPU's kernels (ntt_cuda_tpu/ops/
// fused_ops.py _fwd_chain / _inv_mul_chain, ops/ntt_pallas.py's four-step
// stage A / stage B with roll+select and u32-limb pairs,
// ops/ntt_pallas30.py's u32 form).  Here the index algebra is the
// reference's own (ntt_60bit.cuh:63-265, ntt_cuda_tpu/ops/ntt.py): forward
// CT, natural order in, bit-reversed out, twiddle psi[len + psi_step];
// inverse GS, bit-reversed in, natural out.
//
// Every transform of the library is a thread-block cluster launch
// (ntt_cluster.cuh): block j of B holds coefficients [j n/B, (j + 1) n/B)
// and runs the stages after the cross ones (a forward's) or before them
// (an inverse's) as an n/B-point transform whose twiddle for local
// (len', ps') is psi[tw_mul len' + ps'] with tw_mul = B base + j (base 1,
// or C + c for coefficient shard c of C): the full stage has len = B len'
// and ps = j len' + ps'.  The local stages run register-tiled (fwd_pass /
// inv_pass below): each thread carries 2^K coefficients through K stages
// between block barriers.  Twiddles and their Shoup companions are read
// from global memory, where one modulus's tables stay in L2; the stage
// engine's passes (fwd_pass_sh, inv_pass_sh) read a block's from shared
// memory.
//
// `tid`/`nt` are the thread's index and the block's thread count; the host
// build of the tests passes 0/1, where BLOCK_SYNC is a no-op and one thread
// runs every butterfly in order.
//
// The passes are templated over the word: u64 for the RNS moduli, u32 for
// the 30-bit family (ntt30.cu, kernel 22), each with its own butterflies
// and tables.

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

// The local stages, register-tiled: one pass runs k consecutive stages,
// and each thread carries 2^k coefficients (a set, spaced 2^lo apart)
// through them in registers, so a transform of 2^logn points reads and
// writes shared memory and meets a block barrier once per pass (about
// logn / K passes), not once per stage.  In a set with base index b,
// element e is s[b + (e << lo)]; the stage of span 2^(lo + hs) pairs e and
// e + 2^hs, and its twiddle is tw_mul len + ps, with ps = index >>
// (lo + hs + 1).
//
// Forward pass: stages lg0 .. lg0 + k - 1 (spans 2^(lo + k - 1) down to
// 2^lo, lo = logn - lg0 - k).
template <int k, typename W, typename TW>
NTT_HD void fwd_pass(W* s, int logn, int lg0, const TW& tw, W q, int tid,
                     int nt, int tw_mul) {
  const int lo = logn - lg0 - k;
  for (int g = tid; g < (1 << (logn - k)); g += nt) {
    const int b = ((g >> lo) << (lo + k)) | (g & ((1 << lo) - 1));
    W v[1 << k];
#pragma unroll
    for (int e = 0; e < (1 << k); ++e) v[e] = s[b + (e << lo)];
#pragma unroll
    for (int st = 0; st < k; ++st) {
      const int hs = k - 1 - st;
      const int len = 1 << (lg0 + st);
#pragma unroll
      for (int h = 0; h < (1 << (k - 1)); ++h) {
        const int e0 = ((h >> hs) << (hs + 1)) | (h & ((1 << hs) - 1));
        const int w = tw_mul * len + ((b + (e0 << lo)) >> (lo + hs + 1));
        ct_butterfly(v[e0], v[e0 + (1 << hs)], tw.psi[w], tw.psi_sh[w], q);
      }
    }
#pragma unroll
    for (int e = 0; e < (1 << k); ++e) s[b + (e << lo)] = v[e];
  }
}

// Inverse pass: stages lg0 down to lg0 - k + 1 (spans 2^lo up to
// 2^(lo + k - 1), lo = logn - 1 - lg0), on NA arrays s[0..NA) over the
// same modulus at once: each twiddle and its Shoup companion, loaded once,
// serve the butterfly of every array (the encrypt transform's two
// products, fused_ops.cu).
template <int k, int NA, typename W, typename TW>
NTT_HD void inv_pass(W* const* s, int logn, int lg0, const TW& tw, W q,
                     int tid, int nt, int tw_mul) {
  const int lo = logn - 1 - lg0;
  for (int g = tid; g < (1 << (logn - k)); g += nt) {
    const int b = ((g >> lo) << (lo + k)) | (g & ((1 << lo) - 1));
    W v[NA][1 << k];
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int e = 0; e < (1 << k); ++e) v[a][e] = s[a][b + (e << lo)];
#pragma unroll
    for (int hs = 0; hs < k; ++hs) {
      const int len = 1 << (lg0 - hs);
#pragma unroll
      for (int h = 0; h < (1 << (k - 1)); ++h) {
        const int e0 = ((h >> hs) << (hs + 1)) | (h & ((1 << hs) - 1));
        const int w = tw_mul * len + ((b + (e0 << lo)) >> (lo + hs + 1));
        const W wt = tw.ipsi[w], ws = tw.ipsi_sh[w];
#pragma unroll
        for (int a = 0; a < NA; ++a)
          gs_butterfly(v[a][e0], v[a][e0 + (1 << hs)], wt, ws, q);
      }
    }
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int e = 0; e < (1 << k); ++e) s[a][b + (e << lo)] = v[a][e];
  }
}

// The forward transform of s[0, 2^logn) (values in [0, q) in and out) in
// passes of K stages (K = 2 or 3); the first pass takes the logn % K
// stages left over.
template <int K, typename W, typename TW>
NTT_HD void ntt_fwd_tiled(W* s, int logn, const TW& tw, W q, int tid, int nt,
                          int tw_mul = 1) {
  static_assert(K == 2 || K == 3, "passes of 2 or 3 stages");
  int lg = logn % K;
  BLOCK_SYNC();
  if (lg == 1) fwd_pass<1>(s, logn, 0, tw, q, tid, nt, tw_mul);
  if (lg == 2) fwd_pass<2>(s, logn, 0, tw, q, tid, nt, tw_mul);
  if (lg) BLOCK_SYNC();
  for (; lg < logn; lg += K) {
    fwd_pass<K>(s, logn, lg, tw, q, tid, nt, tw_mul);
    BLOCK_SYNC();
  }
}

// The inverse transform WITHOUT the n^-1 factor (the caller multiplies by
// n^-1, times 2^64 when a Montgomery product came before, at the end) in
// passes of K stages, on NA arrays s[0..NA) at once (one modulus); the
// last pass takes the stages left over (stages logn % K - 1 .. 0).
template <int K, int NA, typename W, typename TW>
NTT_HD void ntt_inv_tiled(W* const* s, int logn, const TW& tw, W q, int tid,
                          int nt, int tw_mul = 1) {
  static_assert(K == 2 || K == 3, "passes of 2 or 3 stages");
  int lg = logn - 1;
  BLOCK_SYNC();
  for (; lg + 1 >= K; lg -= K) {
    inv_pass<K, NA>(s, logn, lg, tw, q, tid, nt, tw_mul);
    BLOCK_SYNC();
  }
  if (lg == 0) inv_pass<1, NA>(s, logn, 0, tw, q, tid, nt, tw_mul);
  if (lg == 1) inv_pass<2, NA>(s, logn, 1, tw, q, tid, nt, tw_mul);
  if (lg >= 0) BLOCK_SYNC();
}

// The same on one array.
template <int K, typename W, typename TW>
NTT_HD void ntt_inv_tiled(W* s, int logn, const TW& tw, W q, int tid, int nt,
                          int tw_mul = 1) {
  W* const one[1] = {s};
  ntt_inv_tiled<K, 1>(one, logn, tw, q, tid, nt, tw_mul);
}

// --- the local passes of the stage engine (ntt_stage.cu) --------------------
//
// The engine's block keeps its local twiddles in shared memory, copied once
// a modulus (load_local_twiddles): for its 2^logb-point range, entry t =
// len + ps (len a local stage's length, ps < len) holds the twiddle of
// index tw_mul len + ps and its Shoup companion side by side, one 16-byte
// load; entries 1 .. 2^logb - 1 (64 KB at 2^logb = 4096).  A pass's set
// with base b = (G << (lo + k)) | (g mod 2^lo), G = g >> lo, needs at its
// stage st (forward) the 2^st twiddles of ps = G 2^st + m, and at the
// inverse's stage hs the 2^(k-1-hs) of ps = G 2^(k-1-hs) + m: the passes
// below load each once.  The block's coefficients sit swizzled, word i at
// swz(i): the passes whose sets are 1 or 8 words apart (lo = 0, 3) then
// touch each bank pair at most twice a warp, as unit-stride ones do; the
// table's entry t sits at tswz(t), so that the pass of lo = 0, whose
// threads each read 2^st neighbouring entries, spreads them over the banks.
struct alignas(16) TwPair {
  u64 w, ws;
};

NTT_HD int swz(int i) { return i ^ ((i >> 4) & 15); }

NTT_HD int tswz(int t) { return t ^ ((t >> 3) & 7); }

NTT_HD int log2_floor(unsigned t) {
#ifdef __CUDA_ARCH__
  return 31 - __clz(t);
#else
  return 31 - __builtin_clz(t);
#endif
}

// Entries 1 .. 2^logb - 1 of stw from one modulus's rows w, ws (psi and
// psi_sh, or ipsi and ipsi_sh) for tw_mul.
NTT_HD void load_local_twiddles(TwPair* stw, const u64* w, const u64* ws,
                                int logb, int tw_mul, int tid, int nt) {
  for (int t = 1 + tid; t < (1 << logb); t += nt) {
    const int len = 1 << log2_floor((unsigned)t);
    const size_t at = (size_t)tw_mul * len + (t - len);
    TwPair p;
    p.w = w[at];
    p.ws = ws[at];
    stw[tswz(t)] = p;
  }
}

// fwd_pass / inv_pass (one array) on the swizzled buffer with the shared
// twiddles: the same butterflies in the same order.
template <int k>
NTT_HD void fwd_pass_sh(u64* s, int logn, int lg0, const TwPair* tw, u64 q,
                        int tid, int nt) {
  const int lo = logn - lg0 - k;
  for (int g = tid; g < (1 << (logn - k)); g += nt) {
    const int G = g >> lo;
    const int b = (G << (lo + k)) | (g & ((1 << lo) - 1));
    u64 v[1 << k];
#pragma unroll
    for (int e = 0; e < (1 << k); ++e) v[e] = s[swz(b + (e << lo))];
#pragma unroll
    for (int st = 0; st < k; ++st) {
      const int hs = k - 1 - st;
      const int t = (1 << (lg0 + st)) + (G << st);
      TwPair w[1 << (k - 1)];
#pragma unroll
      for (int m = 0; m < (1 << st); ++m) w[m] = tw[tswz(t + m)];
#pragma unroll
      for (int h = 0; h < (1 << (k - 1)); ++h) {
        const int e0 = ((h >> hs) << (hs + 1)) | (h & ((1 << hs) - 1));
        ct_butterfly(v[e0], v[e0 + (1 << hs)], w[h >> hs].w, w[h >> hs].ws,
                     q);
      }
    }
#pragma unroll
    for (int e = 0; e < (1 << k); ++e) s[swz(b + (e << lo))] = v[e];
  }
}

template <int k>
NTT_HD void inv_pass_sh(u64* s, int logn, int lg0, const TwPair* tw, u64 q,
                        int tid, int nt) {
  const int lo = logn - 1 - lg0;
  for (int g = tid; g < (1 << (logn - k)); g += nt) {
    const int G = g >> lo;
    const int b = (G << (lo + k)) | (g & ((1 << lo) - 1));
    u64 v[1 << k];
#pragma unroll
    for (int e = 0; e < (1 << k); ++e) v[e] = s[swz(b + (e << lo))];
#pragma unroll
    for (int hs = 0; hs < k; ++hs) {
      const int t = (1 << (lg0 - hs)) + (G << (k - 1 - hs));
      TwPair w[1 << (k - 1)];
#pragma unroll
      for (int m = 0; m < (1 << (k - 1 - hs)); ++m) w[m] = tw[tswz(t + m)];
#pragma unroll
      for (int h = 0; h < (1 << (k - 1)); ++h) {
        const int e0 = ((h >> hs) << (hs + 1)) | (h & ((1 << hs) - 1));
        gs_butterfly(v[e0], v[e0 + (1 << hs)], w[h >> hs].w, w[h >> hs].ws,
                     q);
      }
    }
#pragma unroll
    for (int e = 0; e < (1 << k); ++e) s[swz(b + (e << lo))] = v[e];
  }
}

// ntt_fwd_tiled / ntt_inv_tiled (one array, tw_mul folded into the shared
// table) with these passes.
template <int K>
NTT_HD void ntt_fwd_tiled_sh(u64* s, int logn, const TwPair* tw, u64 q,
                             int tid, int nt) {
  static_assert(K == 2 || K == 3, "passes of 2 or 3 stages");
  int lg = logn % K;
  BLOCK_SYNC();
  if (lg == 1) fwd_pass_sh<1>(s, logn, 0, tw, q, tid, nt);
  if (lg == 2) fwd_pass_sh<2>(s, logn, 0, tw, q, tid, nt);
  if (lg) BLOCK_SYNC();
  for (; lg < logn; lg += K) {
    fwd_pass_sh<K>(s, logn, lg, tw, q, tid, nt);
    BLOCK_SYNC();
  }
}

template <int K>
NTT_HD void ntt_inv_tiled_sh(u64* s, int logn, const TwPair* tw, u64 q,
                             int tid, int nt) {
  static_assert(K == 2 || K == 3, "passes of 2 or 3 stages");
  int lg = logn - 1;
  BLOCK_SYNC();
  for (; lg + 1 >= K; lg -= K) {
    inv_pass_sh<K>(s, logn, lg, tw, q, tid, nt);
    BLOCK_SYNC();
  }
  if (lg == 0) inv_pass_sh<1>(s, logn, 0, tw, q, tid, nt);
  if (lg == 1) inv_pass_sh<2>(s, logn, 1, tw, q, tid, nt);
  if (lg >= 0) BLOCK_SYNC();
}

// Threads per block for the tiled form of a 2^logn-point transform: one
// set of 2^K coefficients each (at least a warp, at most 1024).
template <int K>
static constexpr int tiled_threads(int n) {
  const int t = n >> K;
  return t < 32 ? 32 : t > 1024 ? 1024 : t;
}

// The most of one polynomial a block holds in shared memory: 2^14 u64
// (2^15 u32), 128 KB of the 227 KB a block can use; a cluster of B blocks
// holds n/B a block.
#define LOG_BLOCK_MAX 14

// A launcher's return code for arguments its kernels do not take.
#ifdef __CUDACC__
#define NTT_EINVAL ((int)cudaErrorInvalidValue)
#else
#define NTT_EINVAL 1
#endif

#ifdef __CUDACC__
#include <mutex>
#include <vector>

// Set-up that a launch needs once per kernel, device and shape (raising
// the kernel's dynamic shared memory limit, an occupancy check): each is
// a host call, and the ops are bound by host dispatch.  run() calls
// `setup(&value)` the first time (kernel, current device, shape) comes
// and remembers it and the value it gave (the cluster kernels': how many
// clusters of the shape the card holds at once) if it succeeded; later
// calls return cudaSuccess and that value at once.
class LaunchSetup {
 public:
  template <typename F>
  cudaError_t run(const void* kernel, long long shape, F setup,
                  int* value = nullptr) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    std::lock_guard<std::mutex> lock(mu_);
    for (const Key& k : done_)
      if (k.kernel == kernel && k.dev == dev && k.shape == shape) {
        if (value) *value = k.value;
        return cudaSuccess;
      }
    int v = 0;
    e = setup(&v);
    if (e != cudaSuccess) return e;
    done_.push_back({kernel, dev, shape, v});
    if (value) *value = v;
    return e;
  }

 private:
  struct Key {
    const void* kernel;
    int dev;
    long long shape;
    int value;
  };
  std::mutex mu_;
  std::vector<Key> done_;
};

static inline LaunchSetup& launch_setup() {
  static LaunchSetup s;
  return s;
}

#endif
