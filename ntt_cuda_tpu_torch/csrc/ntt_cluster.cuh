// The thread-block cluster schedule shared by every transform of the library:
// the stage transforms (ntt_stage.cu, kernels 7-13, 19, 20, and kernel 15's
// inverse), the whole-op transforms (fused_ops.cu: K3, K4, K5 and kernel 18)
// and the 30-bit transform (ntt30.cu, kernel 22): one polynomial per cluster
// of B = 2^cl blocks (cl <= 3: B <= 8, the portable cluster size; cl = 4, B =
// 16, only where a launch's two buffers do not fit eight blocks: the whole-op
// transforms at 2^17), block j holding coefficients [j n/B, (j + 1) n/B) of it
// in its own shared memory.  The cross stages (the first log2 B of a forward,
// the last of an inverse) run in registers on one column's B values, moved
// between the blocks through distributed shared memory; the local stages run
// in each block (ntt_block.cuh's tiled passes, STAGE_TILE stages a pass).
//
// Here, for either word (u64 with Twiddles, u32 with Twiddles32): the
// cross stages, the rule that picks B, the threads a block may run, the
// launcher (the kernel's shared memory limit and the cluster's fit checked
// once per kernel, device and shape; a cooperative launch where a kernel
// needs a grid barrier) and the host build's walk of the clusters.

#pragma once

#include "ntt_block.cuh"

#ifdef __CUDACC__
#include <cooperative_groups.h>
#else
#include <vector>
#endif

// Local stages of the cluster kernels: passes of STAGE_TILE stages.
#define STAGE_TILE 3

// The cross stages on one column's B = 2^CL values in registers: global
// stage lg < CL pairs rows k and k + B / 2^(lg+1), twiddle index
// base 2^lg + (k >> (CL - lg)) -- the whole-polynomial form's index on B
// points.
template <int CL, typename W, typename TW>
NTT_HD void cross_fwd(W* v, const TW& t, W q, int base) {
#pragma unroll
  for (int lg = 0; lg < CL; ++lg) {
    const int sl = CL - 1 - lg;
#pragma unroll
    for (int g = 0; g < (1 << CL) / 2; ++g) {
      const int ps = g >> sl;
      const int a = (ps << (sl + 1)) | (g & ((1 << sl) - 1));
      const int w = base * (1 << lg) + ps;
      ct_butterfly(v[a], v[a + (1 << sl)], t.psi[w], t.psi_sh[w], q);
    }
  }
}

template <int CL, typename W, typename TW>
NTT_HD void cross_inv(W* v, const TW& t, W q, int base) {
#pragma unroll
  for (int lg = CL - 1; lg >= 0; --lg) {
    const int sl = CL - 1 - lg;
#pragma unroll
    for (int g = 0; g < (1 << CL) / 2; ++g) {
      const int ps = g >> sl;
      const int a = (ps << (sl + 1)) | (g & ((1 << sl) - 1));
      const int w = base * (1 << lg) + ps;
      gs_butterfly(v[a], v[a + (1 << sl)], t.ipsi[w], t.ipsi_sh[w], q);
    }
  }
}

// The longest transform a cluster launch takes: 2^17 u64 points
// (cuda.TRANSFORM_MAX_N), 2^16 u32 (cuda.TRANSFORM30_MAX_N).
#define LOG_TRANSFORM_MAX 17
#define LOG_TRANSFORM30_MAX 16

// The n the kernels' __launch_bounds__ are sized for (ClusterBound): 2^15
// u64, the longest transform before the cap rose to 2^17.  Longer ones run
// more than one set of points a thread, in turn.
#define LOG_BOUND_N 15

// Whether a launch of 2^logn points of W takes clusters of 2^cl blocks,
// each block holding `bufs` buffers of its n/B points: n <= 2^17 u64 or
// 2^16 u32, at least 2 points a block, B <= 8, and at most 128 KB of
// shared memory a block, 2^14 u64 or 2^15 u32 (two buffers of 2^14 u64, or
// one of 2^16 u32, 256 KB, pass the 227 KB a block can have).  B = 16, a
// non-portable cluster size, only where B = 8 does not fit: u64 buffers of
// two a block at 2^17.
template <typename W = u64>
static inline bool cluster_ok(int logn, int cl, int bufs = 1) {
  constexpr int lu32 = sizeof(W) == 4;  // u32: one more doubling of each
  constexpr int lb = LOG_BLOCK_MAX + lu32;
  if (cl == 4)
    return !lu32 && bufs > 1 && !cluster_ok<W>(logn, 3, bufs) &&
           cluster_ok<W>(logn, 3, 1) && ((long long)bufs << (logn - 4)) <=
                                            (1ll << lb);
  return cl >= 0 && cl <= 3 &&
         logn <= (lu32 ? LOG_TRANSFORM30_MAX : LOG_TRANSFORM_MAX) &&
         logn - cl >= 1 && logn - cl <= lb &&
         ((long long)bufs << (logn - cl)) <= (1ll << lb);
}

// Every cluster kernel's __launch_bounds__ at cluster size 2^CL: at most
// `threads` threads a block, one set of 2^STAGE_TILE points each
// (tiled_threads) of the largest n/B of u64 at n = 2^LOG_BOUND_N (512 at
// CL = 3 and 4, 1024 below; run_cluster launches no more, and a block of
// more sets, u32 at 2^16 and u64 at 2^16 and 2^17, runs them in turn), and
// at least OCC blocks an SM.  Sized at 2^15, not at the 2^17 cap: at 2^17
// it would be 1024 threads at CL = 3, and OCC = 1 would then hold a thread
// to 64 registers, where the kernels of every n <= 2^15 would spill.  At
// CL = 3, OCC = 1 leaves a thread up to 128 registers, where the u64
// kernels spill nothing, and OCC = 2 holds it to 64, where they spill but
// two blocks share an SM.  On the H100 the first was the faster where
// every cluster of the grid fits on the card at once, the second where
// they do not (PERF.md, tools/bounds_ab.py): run_cluster takes the kernel
// of OCC = wide_occ for a grid of more clusters than the card holds of
// OCC = 1.
template <int CL, int OCC>
struct ClusterBound {
  static constexpr int LB = LOG_BOUND_N - (CL < 3 ? CL : 3);
  static constexpr int threads = tiled_threads<STAGE_TILE>(
      1 << (LB < LOG_BLOCK_MAX ? LB : LOG_BLOCK_MAX));
  static constexpr int blocks = OCC;
};

// The OCC of a cluster kernel at cluster size 2^cl for a grid wider than
// the card: 2 at CL = 3 (1 below, where two blocks of 1024 threads would
// hold a thread to 32 registers, and at CL = 4, whose blocks of 128 KB
// cannot share an SM).
constexpr int wide_occ(int cl) { return cl == 3 ? 2 : 1; }

// The launchers' rule: the largest B a launch of 2^logn points takes, 8
// from n = 16 on, 16 where only 16 fits (-1 where none does).  On the H100
// B = 8 was the fastest at n = 2^14 and 2^15 for P = 9, 18 and 36
// polynomials (PERF.md): a launch is bound by the latency of its blocks'
// local stages, which falls with n/B, and P B blocks past 132 SMs still
// beat fewer, longer blocks.
template <typename W = u64>
static inline int stage_cluster_log(int logn, int bufs = 1) {
  if (cluster_ok<W>(logn, 4, bufs)) return 4;
  int cl = 3;
  while (cl >= 0 && !cluster_ok<W>(logn, cl, bufs)) --cl;
  return cl;
}

// log2 of the cluster size for B (0: the rule), or -1 where a launch of
// 2^logn points cannot take B.
template <typename W = u64>
static inline int cluster_log(int B, int logn, int bufs = 1) {
  if (B == 0) return stage_cluster_log<W>(logn, bufs);
  int cl = 0;
  while (cl < 5 && (1 << cl) != B) ++cl;
  return cluster_ok<W>(logn, cl, bufs) ? cl : -1;
}

#ifdef __CUDACC__

// Set-up of a cluster kernel for cfg's shape, once per kernel, device and
// shape: its shared memory limit raised to what the shape needs (never
// lowered: another shape may need more), and in *clusters how many of its
// clusters the card holds at once (cudaOccupancyMaxActiveClusters; a
// cluster that cannot run at all returns a CUDA error).
static inline cudaError_t cluster_setup(const void* kernel, long long shape,
                                        const cudaLaunchConfig_t& cfg,
                                        int* clusters) {
  return launch_setup().run(kernel, shape, [&](int* fit) {
    cudaFuncAttributes fa;
    cudaError_t r = cudaFuncGetAttributes(&fa, kernel);
    // a cluster of more than 8 blocks is non-portable: allowed per kernel
    if (r == cudaSuccess && cfg.attrs[0].val.clusterDim.x > 8)
      r = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (r == cudaSuccess &&
        (size_t)fa.maxDynamicSharedSizeBytes < cfg.dynamicSmemBytes)
      r = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)cfg.dynamicSmemBytes);
    if (r == cudaSuccess) r = cudaOccupancyMaxActiveClusters(fit, kernel, &cfg);
    if (r == cudaSuccess && *fit < 1) r = cudaErrorLaunchOutOfResources;
    return r;
  }, clusters);
}

// One launch of P clusters of 2^CL blocks, each block with `bufs` buffers
// of 2^(logn - CL) W of dynamic shared memory and one thread per
// STAGE_TILE-stage set of a buffer, at most ClusterBound's, of
// `one` (the kernel of OCC = 1) or, where the card cannot hold all P of
// its clusters at once, of `wide` (OCC = wide_occ(CL); the same kernel
// where that is 1).  COOP: a cooperative launch (the kernel takes a grid
// barrier, cooperative_groups::this_grid().sync()), refused with
// cudaErrorCooperativeLaunchTooLarge unless the card holds all P clusters
// at once.  A cluster that cannot run returns its CUDA error.
template <int CL, typename W = u64, bool COOP = false, typename... K,
          typename... A>
static int run_cluster(void (*one)(K...), void (*wide)(K...), int P,
                       int logn, int bufs, void* stream, const A&... args) {
  const int nb = 1 << (logn - CL);
  const int sets = tiled_threads<STAGE_TILE>(nb);
  const int threads = sets < ClusterBound<CL, 1>::threads
                          ? sets : ClusterBound<CL, 1>::threads;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)P << CL);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)bufs * nb * sizeof(W);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void (*kernel)(K...) = one;
  int fit = 0;
  cudaError_t e = cluster_setup((const void*)one, logn, cfg, &fit);
  // the wide kernel only where two of the shape's blocks fit an SM's
  // shared memory (every n <= 2^15 shape; not 128 KB blocks)
  if (e == cudaSuccess && wide != one && P > fit &&
      2 * cfg.dynamicSmemBytes <= (size_t)(227 << 10)) {
    kernel = wide;
    e = cluster_setup((const void*)wide, logn, cfg, &fit);
  }
  if (e != cudaSuccess) return (int)e;
  if (COOP) {
    if (P > fit) return (int)cudaErrorCooperativeLaunchTooLarge;
    cfg.numAttrs = 2;
  }
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

#else  // host build for the CPU tests

// The clusters in turn, one thread a block: for each of the P clusters,
// phase 0 of its 2^CL blocks in order, then phase 1 of each, and so on
// (`phases` phases).  Block k's shared memory is host buffer peer[k] of
// `words` W; phase(ph, p, j, peer) runs phase ph on block j of cluster p.
// The same index algebra as the card's at every B.
template <int CL, typename W = u64, typename F>
static void walk_clusters(int P, int phases, size_t words, const F& phase) {
  std::vector<W> buf(words << CL);
  W* peer[1 << CL];
  for (int k = 0; k < (1 << CL); ++k) peer[k] = buf.data() + k * words;
  for (int p = 0; p < P; ++p)
    for (int ph = 0; ph < phases; ++ph)
      for (int j = 0; j < (1 << CL); ++j) phase(ph, p, j, peer);
}

#endif
