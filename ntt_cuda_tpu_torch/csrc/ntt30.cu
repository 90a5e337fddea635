// Kernel 22: the 30-bit family's negacyclic NTT / inverse NTT on u32
// residues (q < 2^30), n up to 65536.
//
// Replaces ntt_cuda_tpu/ops/ntt_pallas30.py _transform30 (:257, pallas_call
// :288, kernel _make_kernel30 :235): a four-step roll+select transform over
// (n1, 128) u32 tiles with pre-expanded stage-A tables.  Here the index
// algebra is the reference's own (ntt_block.cuh, ops/ntt.py): forward CT,
// natural order in, bit-reversed out, twiddle psi[len + ps]; inverse GS
// without halving, bit-reversed in, natural out, ending with one Shoup
// multiply by n^-1.  Every butterfly is the 32-bit Shoup form
// t = v w - umulhi(v, wp) q (mod 2^32) in [0, 2q), then one conditional
// subtract: values stay canonical in [0, q) throughout.
//
// Bound on the card: a launch reads and writes each polynomial once (4n
// bytes each way) and does 3 integer multiplies a butterfly, about 2.7 us
// of device memory at bench.py's 16 polynomials of 2^16; but each stage
// waits for the one before, so the time is the latency of a block's
// stages, and 16 polynomials are few blocks for 132 SMs.
//
// Design: the u64 transforms' cluster schedule (ntt_cluster.cuh, the head
// of ntt_stage.cu) on u32: polynomial p of the (P, n) input, modulus
// p % r, runs on a thread-block cluster of B = 2^cl blocks (8 by the
// launchers' rule, stage_cluster_log<u32>), block j holding coefficients
// [j n/B, (j + 1) n/B) in n/B u32 of shared memory (32 KB at 2^16, B = 8),
// so every 2^11 <= n <= 2^16 is one launch of P B blocks.
//   Forward: A. the cluster's threads share out the n/B columns; a thread
//   reads column i's B coefficients i + k n/B, runs CT stages 0..cl-1 on
//   them in registers and writes value k into block k through distributed
//   shared memory; B. block j runs the local stages (ntt_fwd_tiled, tw_mul
//   = B + j) and stores its range.
//   Inverse: A. block j loads its range and runs the local GS stages;
//   B. a thread gathers column i's B values, runs GS stages cl-1..0 in
//   registers and the n^-1 Shoup, and writes them.
// Every read of polynomial p comes before the cluster barrier between A and
// B and every write after it, so out may be x.  A B whose n/B buffer passes
// 128 KB of a block (B = 1 at 2^16) or that is no power of two up to 8 is
// refused, as is n > 2^16: there is no other schedule behind it.  Host
// build (g++, the CPU tests): walk_clusters, the same index algebra at
// every B.

#include "ntt_cluster.cuh"

struct T30IO {
  const u32* x;  // (P, n) input
  u32* out;      // (P, n) output (may be x)
  int r, logn;
};

NTT_HD u32 q_of(const Twiddles32& tw, int mi) { return tw.consts[4 * mi]; }

// The phases of polynomial p's cluster of 2^CL blocks, run on block j as
// thread tid of nt; peer[k] is block k's shared memory, s the block's own.
template <int CL>
NTT_HD void fwd30_phase_a(const T30IO& io, const Twiddles32& tw, int p, int j,
                          int tid, int nt, u32* const* peer) {
  const int nb = 1 << (io.logn - CL), mi = p % io.r;
  const u32 q = q_of(tw, mi);
  const Twiddles32 t = twiddles_at(tw, mi, 1 << io.logn);
  const u32* xp = io.x + ((size_t)p << io.logn);
  for (int i = j * nt + tid; i < nb; i += nt << CL) {
    u32 v[1 << CL];
#pragma unroll
    for (int k = 0; k < (1 << CL); ++k) v[k] = xp[k * nb + i];
    cross_fwd<CL>(v, t, q, 1);
#pragma unroll
    for (int k = 0; k < (1 << CL); ++k) peer[k][i] = v[k];
  }
}

template <int CL>
NTT_HD void fwd30_phase_b(const T30IO& io, const Twiddles32& tw, int p, int j,
                          int tid, int nt, u32* s) {
  const int logb = io.logn - CL, nb = 1 << logb, mi = p % io.r;
  ntt_fwd_tiled<STAGE_TILE>(s, logb, twiddles_at(tw, mi, 1 << io.logn),
                            q_of(tw, mi), tid, nt, (1 << CL) + j);
  u32* ob = io.out + ((size_t)p << io.logn) + (size_t)j * nb;
  for (int i = tid; i < nb; i += nt) ob[i] = s[i];
}

template <int CL>
NTT_HD void inv30_phase_a(const T30IO& io, const Twiddles32& tw, int p, int j,
                          int tid, int nt, u32* s) {
  const int logb = io.logn - CL, nb = 1 << logb, mi = p % io.r;
  const u32* xb = io.x + ((size_t)p << io.logn) + (size_t)j * nb;
  for (int i = tid; i < nb; i += nt) s[i] = xb[i];
  ntt_inv_tiled<STAGE_TILE>(s, logb, twiddles_at(tw, mi, 1 << io.logn),
                            q_of(tw, mi), tid, nt, (1 << CL) + j);
}

template <int CL>
NTT_HD void inv30_phase_b(const T30IO& io, const Twiddles32& tw, int p, int j,
                          int tid, int nt, u32* const* peer) {
  const int nb = 1 << (io.logn - CL), mi = p % io.r;
  const u32 q = q_of(tw, mi);
  const u32 ninv = tw.consts[4 * mi + 1], ninv_sh = tw.consts[4 * mi + 2];
  const Twiddles32 t = twiddles_at(tw, mi, 1 << io.logn);
  u32* op = io.out + ((size_t)p << io.logn);
  for (int i = j * nt + tid; i < nb; i += nt << CL) {
    u32 v[1 << CL];
#pragma unroll
    for (int k = 0; k < (1 << CL); ++k) v[k] = peer[k][i];
    cross_inv<CL>(v, t, q, 1);
#pragma unroll
    for (int k = 0; k < (1 << CL); ++k)
      op[k * nb + i] = mul_shoup32(v[k], ninv, ninv_sh, q);
  }
}

#ifdef __CUDACC__

// One polynomial per cluster of 2^CL blocks (the head of the file), at
// least OCC blocks an SM (ClusterBound, as the u64 cluster kernels: 512
// threads at CL = 3, which at 2^16 run two sets of 8 points a pass).
template <int CL, int OCC, bool INV>
__global__ void __launch_bounds__(ClusterBound<CL, OCC>::threads,
                                  ClusterBound<CL, OCC>::blocks)
    k_ntt30_cluster(T30IO io, Twiddles32 tw) {
  extern __shared__ u32 smem32[];
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int j = (int)cluster.block_rank(), p = (int)(blockIdx.x >> CL);
  u32* peer[1 << CL];
#pragma unroll
  for (int k = 0; k < (1 << CL); ++k)
    peer[k] = cluster.map_shared_rank(smem32, k);
  if constexpr (INV) {
    inv30_phase_a<CL>(io, tw, p, j, threadIdx.x, blockDim.x, smem32);
    cluster.sync();  // every block's local stages are done
    inv30_phase_b<CL>(io, tw, p, j, threadIdx.x, blockDim.x, peer);
  } else {
    cluster.sync();  // every block of the cluster has started
    fwd30_phase_a<CL>(io, tw, p, j, threadIdx.x, blockDim.x, peer);
    cluster.sync();  // the cross stages' remote writes are visible
    fwd30_phase_b<CL>(io, tw, p, j, threadIdx.x, blockDim.x, smem32);
  }
  cluster.sync();  // no block exits while another reads its shared memory
}

template <int CL, bool INV>
static int run30(const T30IO& io, const Twiddles32& tw, int P, void* stream) {
  return run_cluster<CL, u32>(k_ntt30_cluster<CL, 1, INV>,
                              k_ntt30_cluster<CL, wide_occ(CL), INV>, P,
                              io.logn, 1, stream, io, tw);
}

#else  // host build for the CPU tests: each cluster in turn (walk_clusters)

template <int CL, bool INV>
static int run30(const T30IO& io, const Twiddles32& tw, int P, void*) {
  walk_clusters<CL, u32>(P, 2, (size_t)1 << (io.logn - CL),
                         [&](int ph, int p, int j, u32* const* peer) {
                           if (INV && ph == 0)
                             inv30_phase_a<CL>(io, tw, p, j, 0, 1, peer[j]);
                           if (INV && ph == 1)
                             inv30_phase_b<CL>(io, tw, p, j, 0, 1, peer);
                           if (!INV && ph == 0)
                             fwd30_phase_a<CL>(io, tw, p, j, 0, 1, peer);
                           if (!INV && ph == 1)
                             fwd30_phase_b<CL>(io, tw, p, j, 0, 1, peer[j]);
                         });
  return 0;
}

#endif

// x, out (P, n) u32 (out may be x); tables from NTTTables30; inverse 0/1;
// cluster: B, or 0 for the launchers' rule (8 from n = 16 on).
extern "C" int ntt30_transform(const void* x, void* out, const void* psi,
                               const void* psi_sh, const void* ipsi,
                               const void* ipsi_sh, const void* consts,
                               int inverse, int P, int r, int logn,
                               int cluster, void* stream) {
  const int cl = cluster_log<u32>(cluster, logn);
  if (P < 1 || r < 1 || P % r != 0 || cl < 0) return NTT_EINVAL;
  const T30IO io = {(const u32*)x, (u32*)out, r, logn};
  const Twiddles32 tw = {(const u32*)psi, (const u32*)psi_sh,
                         (const u32*)ipsi, (const u32*)ipsi_sh,
                         (const u32*)consts};
  typedef int (*Run)(const T30IO&, const Twiddles32&, int, void*);
  static const Run runs[2][4] = {
      {run30<0, false>, run30<1, false>, run30<2, false>, run30<3, false>},
      {run30<0, true>, run30<1, true>, run30<2, true>, run30<3, true>}};
  return runs[inverse != 0][cl](io, tw, P, stream);
}
