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
// register tiling of stages, no bank-conflict swizzle.  The cluster
// kernels (ntt_stage.cu, fused_ops.cu's encrypt transform) run their local
// stages through the register-tiled form below instead (ntt_fwd_tiled /
// ntt_inv_tiled, the inverse also on two arrays at once).
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
// 2 (C + c) + h for its halves); stage 0 (the pairs i, i + n/2, twiddle
// psi[1] or psi^-1[1]) runs in a separate elementwise pass (fused_ops.cu,
// ntt30.cu, kernel 15) through the same two butterflies.  The stage
// kernels' clusters (ntt_stage.cu) pass B base + j for block j of B.
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

// Register-tiled form of the two loops above, the same integers: one pass
// runs k consecutive stages, and each thread carries 2^k coefficients (a
// set, spaced 2^lo apart) through them in registers, so a transform of
// 2^logn points reads and writes shared memory and meets a block barrier
// once per pass (about logn / K passes) instead of once per stage.  In a
// set with base index b, element e is s[b + (e << lo)]; the stage of span
// 2^(lo + hs) pairs e and e + 2^hs, and its twiddle is the loop form's
// tw_mul len + ps, with ps = index >> (lo + hs + 1).
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

// ntt_fwd_block in passes of K stages (K = 2 or 3); the first pass takes
// the logn % K stages left over.
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

// ntt_inv_block in passes of K stages, on NA arrays s[0..NA) at once (one
// modulus); the last pass takes the stages left over (stages
// logn % K - 1 .. 0).
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

// Threads per block for the tiled form of a 2^logn-point transform: one
// set of 2^K coefficients each (at least a warp, at most 1024).
template <int K>
static inline int tiled_threads(int n) {
  const int t = n >> K;
  return t < 32 ? 32 : t > 1024 ? 1024 : t;
}

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
#include <mutex>
#include <vector>

// Set-up that a launch needs once per kernel, device and shape (raising
// the kernel's dynamic shared memory limit, an occupancy check): each is
// a host call, and the ops are bound by host dispatch.  run() calls
// `setup` the first time (kernel, current device, shape) comes and
// remembers it if it succeeded; later calls return cudaSuccess at once.
class LaunchSetup {
 public:
  template <typename F>
  cudaError_t run(const void* kernel, long long shape, F setup) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    std::lock_guard<std::mutex> lock(mu_);
    for (const Key& k : done_)
      if (k.kernel == kernel && k.dev == dev && k.shape == shape)
        return cudaSuccess;
    e = setup();
    if (e == cudaSuccess) done_.push_back({kernel, dev, shape});
    return e;
  }

 private:
  struct Key {
    const void* kernel;
    int dev;
    long long shape;
  };
  std::mutex mu_;
  std::vector<Key> done_;
};

static inline LaunchSetup& launch_setup() {
  static LaunchSetup s;
  return s;
}

// Raise `kernel`'s dynamic shared memory limit to the most a launch here
// asks (128 KB: 2^14 u64 or 2^15 u32), once per kernel and device.
static inline cudaError_t smem_limit_once(const void* kernel) {
  return launch_setup().run(kernel, -1, [kernel] {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)(sizeof(u64) << LOG_BLOCK_MAX));
  });
}

// Launch a block-per-polynomial kernel with sizeof(W) * 2^logb bytes of
// dynamic shared memory, at most 128 KB (above 48 KB only after raising
// the kernel's limit, done once: smem_limit_once).
template <typename W = u64, typename K, typename... A>
static int launch_poly(K kernel, int blocks, int logb, void* stream, A... args) {
  const int nb = 1 << logb;
  const size_t smem = (size_t)nb * sizeof(W);
  if (logb < 1 || smem > (sizeof(u64) << LOG_BLOCK_MAX) || blocks < 1)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = smem_limit_once((const void*)kernel);
  if (e != cudaSuccess) return (int)e;
  kernel<<<blocks, ntt_threads(nb), smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}
#endif
