// The thread-block cluster schedule shared by the stage transforms
// (ntt_stage.cu, kernels 7-13, 19, 20) and the encrypt transform
// (fused_ops.cu, K5 and kernel 18): one polynomial per cluster of
// B = 2^cl blocks (cl <= 3: B <= 8, the portable cluster size), block j
// holding coefficients [j n/B, (j + 1) n/B) of it in its own shared
// memory.  The cross stages (the first log2 B of a forward, the last of an
// inverse) run in registers on one column's B values, moved between the
// blocks through distributed shared memory; the local stages run in each
// block (ntt_block.cuh's tiled passes, STAGE_TILE stages a pass).
//
// Here: the cross stages, the rule that picks B, the launcher (the
// kernel's shared memory limit and the cluster's fit checked once per
// kernel, device and shape) and the host build's walk of the clusters.

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
template <int CL>
NTT_HD void cross_fwd(u64* v, const Twiddles& t, u64 q, int base) {
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

template <int CL>
NTT_HD void cross_inv(u64* v, const Twiddles& t, u64 q, int base) {
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

// Whether a launch of 2^logn points takes clusters of 2^cl blocks, each
// block holding `bufs` buffers of its n/B points: at least 2 points a
// block, B <= 8, and at most 2^LOG_BLOCK_MAX u64 (128 KB) of shared memory
// a block (two buffers of 2^14 points, 256 KB, pass the 227 KB a block
// can have).
static inline bool cluster_ok(int logn, int cl, int bufs = 1) {
  return cl >= 0 && cl <= 3 && logn - cl >= 1 &&
         logn - cl <= LOG_BLOCK_MAX &&
         ((long long)bufs << (logn - cl)) <= (1ll << LOG_BLOCK_MAX);
}

// The launchers' rule: the largest B a launch of 2^logn points takes, 8
// from n = 16 on (-1 where none does).  On the H100 B = 8 was the fastest
// at n = 2^14 and 2^15 for P = 9, 18 and 36 polynomials (PERF.md): a
// launch is bound by the latency of its blocks' local stages, which falls
// with n/B, and P B blocks past 132 SMs still beat fewer, longer blocks.
static inline int stage_cluster_log(int logn, int bufs = 1) {
  int cl = 3;
  while (cl >= 0 && !cluster_ok(logn, cl, bufs)) --cl;
  return cl;
}

// log2 of the cluster size for B (0: the rule), or -1 where a launch of
// 2^logn points cannot take B.
static inline int cluster_log(int B, int logn, int bufs = 1) {
  if (B == 0) return stage_cluster_log(logn, bufs);
  int cl = 0;
  while (cl < 4 && (1 << cl) != B) ++cl;
  return cluster_ok(logn, cl, bufs) ? cl : -1;
}

#ifdef __CUDACC__

// One launch of P clusters of 2^CL blocks of `kernel`, each block with
// `bufs` buffers of 2^(logn - CL) u64 of dynamic shared memory and one
// thread per STAGE_TILE-stage set of a buffer.  Once per kernel, device
// and logn the kernel's shared memory limit is raised to what the shape
// needs (never lowered: another shape may need more) and the cluster's fit
// checked with cudaOccupancyMaxActiveClusters; a cluster that cannot run
// returns its CUDA error.
template <int CL, typename... K, typename... A>
static int run_cluster(void (*kernel)(K...), int P, int logn, int bufs,
                       void* stream, const A&... args) {
  const int nb = 1 << (logn - CL);
  const size_t smem = (size_t)bufs * nb * sizeof(u64);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1u << CL;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)P << CL);
  cfg.blockDim = dim3(tiled_threads<STAGE_TILE>(nb));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = launch_setup().run((const void*)kernel, logn, [&] {
    cudaFuncAttributes fa;
    cudaError_t r = cudaFuncGetAttributes(&fa, (const void*)kernel);
    if (r == cudaSuccess && (size_t)fa.maxDynamicSharedSizeBytes < smem)
      r = cudaFuncSetAttribute((const void*)kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    int clusters = 0;
    if (r == cudaSuccess)
      r = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel,
                                         &cfg);
    if (r == cudaSuccess && clusters < 1) r = cudaErrorLaunchOutOfResources;
    return r;
  });
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

#else  // host build for the CPU tests

// The clusters in turn, one thread a block: for each of the P clusters,
// phase 0 of its 2^CL blocks in order, then phase 1 of each, and so on
// (`phases` phases).  Block k's shared memory is host buffer peer[k] of
// `words` u64; phase(ph, p, j, peer) runs phase ph on block j of cluster p.
// The same index algebra as the card's at every B.
template <int CL, typename F>
static void walk_clusters(int P, int phases, size_t words, const F& phase) {
  std::vector<u64> buf(words << CL);
  u64* peer[1 << CL];
  for (int k = 0; k < (1 << CL); ++k) peer[k] = buf.data() + k * words;
  for (int p = 0; p < P; ++p)
    for (int ph = 0; ph < phases; ++ph)
      for (int j = 0; j < (1 << CL); ++j) phase(ph, p, j, peer);
}

#endif
