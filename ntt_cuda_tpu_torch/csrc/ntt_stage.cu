// Stage-schedule transforms: one forward or inverse negacyclic NTT per
// launch, with an elementwise prologue (and, for the inverse, an epilogue)
// fused in.
//
// Replace the TPU kernels of ntt_cuda_tpu/ops/ntt_pallas.py:
//   7  _transform_tiled            (ntt_pallas.py:558, pallas_call :600)
//   8  _transform_inv_mul          (ntt_pallas.py:685, pallas_call :719)
//   9  _transform_fwd_ternary      (ntt_pallas.py:782, pallas_call :810)
//   10 _transform_fwd_addneg_gauss (ntt_pallas.py:959, pallas_call :993)
//   11 _transform_fwd_addneg       (ntt_pallas.py:868, pallas_call :902)
// the transform half of ntt_cuda_tpu/ops/bfv_tail.py encrypt_fused
// (13: bfv_tail.py:661, pallas_call :717), whose modulus drop and
// Delta*m + fix run in fused_ops.cu's ntt_encrypt_tail, the two
// transforms of the key switch (19: fused_ops.py:651, pallas_call :697),
// whose modulus drop is the same tail launch, and the sharded key switch's
// front (20: keyswitch_front_fused, fused_ops.py:766, pallas_call :808):
// the same two launches over one rank's band of rl moduli, r := rl, the
// digits read whole and the key rows (2, k, rl, n) the rank's own; the
// forward and inverse with a per-polynomial modulus index (12, below) and
// the decrypt back half in one cooperative launch (15, k_decrypt_cluster).  The
// TPU kernels share one four-step transform (_stage_a / _stage_b) and
// differ in the prologue;
// here they share the cluster transform below and differ in `pro`:
//   PRO_COPY          x                          (7)
//   PRO_TERNARY       small_res(d)               (9, d a compact ternary)
//   PRO_ADDNEG_GAUSS  -(x + small_res(d)), 0 fix (10, d a compact Gaussian)
//   PRO_MONT          x * y * 2^-64 (Montgomery) (8, 13)
//   PRO_ADDNEG        -(x + y), 0 fix            (11, y u64 at x's index)
//   PRO_DIGIT         x[p / r] mod q (mod_nu)    (19 forward: the digits)
//   PRO_KSACC         sum_j d^_j * ksk_j * 2^-64 (19 inverse: both key rows)
// The inverse ends with n^-1: a Shoup multiply by n^-1 * 2^64 after a
// Montgomery product (its 2^-64 cancels), else mont_mul by the same
// constant, which is x * n^-1.  Kernel 13 then adds e (strict `>`).
//
// Key switch (19).  The TPU kernel keeps one modulus per grid step in VMEM
// with k forward chains and two accumulators; one polynomial fills a
// cluster's shared memory here, so the same function is two launches of
// this transform (and the tail):  PRO_DIGIT forward over P = J k r
// polynomials, p = (J k + j) r + mi reading c2[J, j] (the digit lifted to
// every modulus, q_last included) into d^ (J, k, r, n); then PRO_KSACC
// inverse over P = J 2 r, p = (J 2 + h) r + mi accumulating the k
// Montgomery products d^[J, j, mi] ksk[h, j, mi] canonically into
// (J, 2, r, n).  Every intermediate is a canonical residue, so the result
// equals the XLA chain of the JAX package exactly.
//
// Polynomial p has modulus p % r (the standard RNS layout); a compact draw
// row is shared by the r polynomials of one message (row p / r).
//
// Kernel 12 (ntt_pallas.py:_transform, :496, pallas_call :539): the same
// forward or inverse with PRO_COPY where polynomial p has modulus
// mod_idx[p] (the TPU kernel's prefetched index map) and P is any count.
// The launchers check nothing of the indices: the wrapper checks them on
// the host before the launch.
//
// Coefficient shard (parallel/coef_kernels.py, the counterpart of
// parallel/coef_pallas.py): shard c of C = 2^logc holds coefficients
// [c n, (c + 1) n) of a C n-point transform whose first log2 C stages
// (the cross-shard ones) have run.  What is left is an n-point transform
// whose local twiddle row [m, 2m) is the full table's row
// [m (C + c), m (C + c) + m): with base = C + c, the whole-polynomial form
// reads psi[base len + ps].  The tables are the full C n-point ones (row
// stride C n), so the inverse ends with the global n^-1 and the cross GS
// stages after it do not halve.  base = 1 (logc = 0) is the unsharded
// transform.
//
// Bound on the card.  A launch reads and writes each polynomial once (at
// 32k_9q, J = 1, 2.5-3.1 us of device memory at 3.35 TB/s) and the
// multiplier has less still to do; but a launch holds few polynomials
// (P = r to 4 r at J = 1 against 132 SMs), and each of the log n stages
// of a transform waits for the one before.  So the time is the latency of
// the stages of one block: one polynomial (or 2^14 half) per block would
// run 2^14-point blocks on P of the SMs.  Here it is the latency of an
// n/B-point block, with P B blocks on the 132 SMs.
//
// Design: one polynomial per thread-block cluster of B = 2^cl blocks
// (cl <= 3: B <= 8, the portable cluster size), P B blocks a launch.
// Block j (cluster.block_rank()) holds coefficients [j n/B, (j + 1) n/B)
// in its own shared memory, n/B u64: 32 KB at n = 2^15, B = 8, and at
// most 128 KB (2^14), so n = 2^15 is one launch at B >= 2, 2^16 at B >= 4
// and 2^17 at B = 8.
//   Forward (CT, natural order in), two phases with a cluster barrier
//   between them (and one before, so that every block of the cluster has
//   started before a remote write):
//     A. the cluster's threads share out the n/B columns i; a thread reads the
//        B coefficients i + j n/B through the prologue, runs CT stages
//        0..cl-1 on them in registers (a B-point transform with the
//        twiddle base), and writes output j into block j's shared memory
//        through distributed shared memory;
//     B. block j runs stages cl..log n - 1 as an n/B-point transform in its
//        own shared memory, the sub-range form with tw_mul = B base + j
//        (the full stage lg >= cl has len = B len' and ps = j len' + ps'),
//        and stores its range of out.
//   Inverse (GS, bit-reversed in):
//     A. block j loads its range through the prologue and runs GS stages
//        log n - 1..cl locally with the same tw_mul;
//     B. each thread gathers column i's B values from the cluster's blocks
//        through distributed shared memory, runs GS stages cl-1..0 in
//        registers, then the epilogue (n^-1, +e), and writes out; a last
//        cluster barrier keeps every block's shared memory until the
//        others have read it.
// The local stages are register-tiled (ntt_block.cuh ntt_fwd_tiled /
// ntt_inv_tiled, passes of STAGE_TILE stages): a thread carries 2^3
// coefficients through three stages between block barriers.  On the card
// that beat the one-barrier-a-stage loop at every local size measured
// (chip_smoke.py's local-stage A/B; PERF.md).  Threads per block: one set
// of 2^STAGE_TILE coefficients each, n / (B 8), at most 1024 (512 at
// n = 2^15, B = 8; the kernels' __launch_bounds__, ClusterBound, with one
// or two blocks an SM by the grid's width; 512 too at 2^16 and 2^17, B =
// 8, where each thread runs two or four sets in turn): every thread of a
// pass has work, and the cross phases give each thread n / (B^2 T)
// columns.
// B: stage_cluster_log (ntt_cluster.cuh, shared with fused_ops.cu's
// whole-op transforms), the rule fixed from per-B timings on the card
// (PERF.md): 8 wherever it fits.  The launcher (run_cluster) raises the
// kernel's shared memory limit and checks with
// cudaOccupancyMaxActiveClusters that a cluster of the shape fits, once
// per kernel, device and shape; where it does not, it returns the CUDA
// error: there is no one-block, two-launch or plain schedule behind it.
// Every intermediate stays in [0, q), so each prologue, epilogue, mod_idx
// and shard base gives the plain version's integers.
//
// Host build (g++, the CPU tests): walk_clusters runs, for each cluster,
// phase A of its B blocks (one thread each) into B host buffers, then
// phase B of each block: the same index algebra at every B
// (ntt_stage_forward_cluster / ntt_stage_inverse_cluster take B).

#include "behz_sums.cuh"
#include "ntt_cluster.cuh"

enum {
  PRO_COPY = 0,
  PRO_TERNARY = 1,
  PRO_ADDNEG_GAUSS = 2,
  PRO_MONT = 3,
  PRO_ADDNEG = 4,
  PRO_DIGIT = 5,
  PRO_KSACC = 6
};

struct StageIO {
  const u64* x;   // (P, n) input polynomials (unused for PRO_TERNARY);
                  // PRO_DIGIT: (P / r, n) rows; PRO_KSACC: d^ (J, k, r, n)
  const int* d;   // (P / r, n) compact draw (PRO_TERNARY, PRO_ADDNEG_GAUSS)
  const u64* y;   // PRO_MONT: (ny, n) dyadic operand, row p % ny;
                  // PRO_ADDNEG: (P, n) e; PRO_KSACC: ksk (2, k, r, n)
  const int* e;   // (P / r, n) compact Gaussian added by the inverse, or null
  const u64* nu;  // PRO_DIGIT: (r,) floor(2^64 / q)
  const int* mod_idx;  // (P,) modulus of each polynomial (kernel 12), or
                       // null: p % r
  u64* out;       // (P, n)
  int pro, ny, r, logn;  // PRO_KSACC: ny = k, the number of digits
  int logc, shard;  // coefficient shard `shard` of 2^logc (0, 0: none)
};

NTT_HD int modulus_of(const StageIO& io, int p) {
  return io.mod_idx ? io.mod_idx[p] : p % io.r;
}

// The twiddle base C + c of a coefficient shard (1 unsharded).
NTT_HD int tw_base(const StageIO& io) { return (1 << io.logc) + io.shard; }

// Modulus mi's rows of the (r, C n) tables.
NTT_HD Twiddles stage_twiddles(const StageIO& io, Twiddles tw, int mi) {
  return twiddles_at(tw, mi, 1 << (io.logn + io.logc));
}

// A prologue that leaves a Montgomery factor 2^-64 for the inverse's end.
NTT_HD bool pro_mont(int pro) { return pro == PRO_MONT || pro == PRO_KSACC; }

NTT_HD u64 prologue(const StageIO& io, int p, int i, const ModConsts& c) {
  const size_t n = (size_t)1 << io.logn;
  const size_t at = (size_t)p * n + i;
  const size_t at_d = (size_t)(p / io.r) * n + i;
  switch (io.pro) {
    case PRO_TERNARY:
      return small_res(io.d[at_d], c.q);
    case PRO_ADDNEG_GAUSS:
      return add_neg_mod(io.x[at], small_res(io.d[at_d], c.q), c.q);
    case PRO_MONT:
      return mont_mul(io.x[at], io.y[(size_t)(p % io.ny) * n + i], c.q,
                      c.qinv);
    case PRO_ADDNEG:
      return add_neg_mod(io.x[at], io.y[at], c.q);
    case PRO_DIGIT:
      return mod_nu(io.x[at_d], c.q, io.nu[p % io.r]);
    case PRO_KSACC: {
      // p = (J 2 + h) r + mi; digit j of message J is row (J k + j) r + mi
      // of d^, key row (h k + j) r + mi
      const int k = io.ny, r = io.r, mi = p % r, h = (p / r) % 2;
      const size_t step = (size_t)r * n;
      const u64* dj = io.x + ((size_t)(p / (2 * r)) * k * r + mi) * n + i;
      const u64* kj = io.y + ((size_t)h * k * r + mi) * n + i;
      u64 acc = 0;
      for (int j = 0; j < k; ++j)
        acc = add_mod(acc, mont_mul(dj[j * step], kj[j * step], c.q, c.qinv),
                      c.q);
      return acc;
    }
    default:
      return io.x[at];
  }
}

// The inverse's last step on coefficient i of polynomial p.
NTT_HD u64 inv_finish(const StageIO& io, int p, int i, u64 v,
                      const ModConsts& c) {
  v = pro_mont(io.pro) ? mul_shoup(v, c.ninv, c.ninv_sh, c.q)
                       : mont_mul(v, c.ninv, c.q, c.qinv);
  if (io.e) {
    const size_t at_e = (size_t)(p / io.r) * ((size_t)1 << io.logn) + i;
    v = add_mod_gt(v, small_res(io.e[at_e], c.q), c.q);
  }
  return v;
}

// The phases of the cluster schedule (the note at the head of the file).
// Each runs on block j of polynomial p's cluster of B = 2^CL blocks, as
// thread tid of nt; peer[k] is block k's shared memory (distributed
// shared memory on the card, a host buffer in the host build), s the
// block's own.
template <int CL>
NTT_HD void fwd_phase_a(const StageIO& io, const Twiddles& tw, int p, int j,
                        int tid, int nt, u64* const* peer) {
  const int nb = 1 << (io.logn - CL);
  const int mi = modulus_of(io, p);
  const ModConsts c = load_consts(tw.consts, mi);
  const Twiddles t = stage_twiddles(io, tw, mi);
  const int base = tw_base(io);
  for (int i = j * nt + tid; i < nb; i += nt << CL) {
    u64 v[1 << CL];
#pragma unroll
    for (int k = 0; k < (1 << CL); ++k) v[k] = prologue(io, p, k * nb + i, c);
    cross_fwd<CL>(v, t, c.q, base);
#pragma unroll
    for (int k = 0; k < (1 << CL); ++k) peer[k][i] = v[k];
  }
}

template <int CL>
NTT_HD void fwd_phase_b(const StageIO& io, const Twiddles& tw, int p, int j,
                        int tid, int nt, u64* s) {
  const int logb = io.logn - CL, nb = 1 << logb;
  const int mi = modulus_of(io, p);
  const ModConsts c = load_consts(tw.consts, mi);
  const Twiddles t = stage_twiddles(io, tw, mi);
  ntt_fwd_tiled<STAGE_TILE>(s, logb, t, c.q, tid, nt,
                            (tw_base(io) << CL) + j);
  u64* ob = io.out + ((size_t)p << io.logn) + (size_t)j * nb;
  for (int i = tid; i < nb; i += nt) ob[i] = s[i];
}

template <int CL>
NTT_HD void inv_phase_a(const StageIO& io, const Twiddles& tw, int p, int j,
                        int tid, int nt, u64* s) {
  const int logb = io.logn - CL, nb = 1 << logb;
  const int mi = modulus_of(io, p);
  const ModConsts c = load_consts(tw.consts, mi);
  const Twiddles t = stage_twiddles(io, tw, mi);
  for (int i = tid; i < nb; i += nt) s[i] = prologue(io, p, j * nb + i, c);
  ntt_inv_tiled<STAGE_TILE>(s, logb, t, c.q, tid, nt,
                            (tw_base(io) << CL) + j);
}

template <int CL>
NTT_HD void inv_phase_b(const StageIO& io, const Twiddles& tw, int p, int j,
                        int tid, int nt, u64* const* peer) {
  const int nb = 1 << (io.logn - CL);
  const int mi = modulus_of(io, p);
  const ModConsts c = load_consts(tw.consts, mi);
  const Twiddles t = stage_twiddles(io, tw, mi);
  const int base = tw_base(io);
  u64* ob = io.out + ((size_t)p << io.logn);
  for (int i = j * nt + tid; i < nb; i += nt << CL) {
    u64 v[1 << CL];
#pragma unroll
    for (int k = 0; k < (1 << CL); ++k) v[k] = peer[k][i];
    cross_inv<CL>(v, t, c.q, base);
#pragma unroll
    for (int k = 0; k < (1 << CL); ++k)
      ob[k * nb + i] = inv_finish(io, p, k * nb + i, v[k], c);
  }
}

static StageIO stage_io(const void* x, const void* d, const void* y,
                        const void* e, const void* nu, void* out, int pro,
                        int ny, int r, int logn, const void* mod_idx = nullptr,
                        int logc = 0, int shard = 0) {
  StageIO io = {(const u64*)x,   (const int*)d,       (const u64*)y,
                (const int*)e,   (const u64*)nu,      (const int*)mod_idx,
                (u64*)out,       pro,                 ny,
                r,               logn,                logc,
                shard};
  return io;
}

static bool stage_args_ok(int pro, int P, int r, int ny, int logn,
                          const void* mod_idx, int logc, int shard) {
  return logn >= 1 && logn <= LOG_TRANSFORM_MAX && P >= 1 && r >= 1 &&
         (mod_idx ? pro == PRO_COPY : P % r == 0) && pro >= PRO_COPY &&
         pro <= PRO_KSACC && (!pro_mont(pro) || ny >= 1) &&
         (pro != PRO_KSACC || P % (2 * r) == 0) && logc >= 0 && logc <= 16 &&
         shard >= 0 && shard < (1 << logc);
}

// What each direction takes: the forward reads x or a draw, the inverse
// ends with n^-1 after a copy or a Montgomery prologue.
static bool forward_pro(int pro) {
  return pro == PRO_COPY || pro == PRO_TERNARY || pro == PRO_ADDNEG_GAUSS ||
         pro == PRO_ADDNEG || pro == PRO_DIGIT;
}

static bool inverse_pro(int pro) {
  return pro == PRO_COPY || pro == PRO_MONT || pro == PRO_KSACC;
}

// Glue of the coefficient-sharded transform (parallel/coef_kernels.py): one
// cross-shard stage on a shard's (P, n) polynomials, elementwise, with the
// partner shard's polynomials and the stage's one twiddle index w per
// modulus.  Not a TPU kernel: the JAX package runs these stages as XLA
// (parallel/sharded.py _cross_forward_stage / _cross_inverse_stage).  The
// shard on the u side of the pair keeps the butterfly's first output, the
// other its second: CT (u + w v, u - w v), GS (u + v, (u - v) w^-1), no
// halving (the local inverse folds the global n^-1).
struct CrossIO {
  const u64* x;
  const u64* partner;
  u64* out;
  int inverse, u_side, w, r, logn, logc;
};

NTT_HD void cross_body(long long k, CrossIO io, Twiddles tw) {
  const int mi = (int)(k >> io.logn) % io.r;
  const ModConsts c = load_consts(tw.consts, mi);
  const Twiddles t = twiddles_at(tw, mi, 1 << (io.logn + io.logc));
  u64 a = io.u_side ? io.x[k] : io.partner[k];
  u64 b = io.u_side ? io.partner[k] : io.x[k];
  if (io.inverse)
    gs_butterfly(a, b, t.ipsi[io.w], t.ipsi_sh[io.w], c.q);
  else
    ct_butterfly(a, b, t.psi[io.w], t.psi_sh[io.w], c.q);
  io.out[k] = io.u_side ? a : b;
}

static bool cross_args_ok(int w, int P, int r, int logn, int logc) {
  return logn >= 1 && logc >= 1 && logn + logc <= 30 && P >= 1 && r >= 1 &&
         P % r == 0 && w >= 1 && w < (1 << logc);
}

// Kernel 15 (bfv_tail.py:decrypt_fused, :507, pallas_call :544): the
// decrypt back half, INTT(x (.) sk) then the decrypt tail, in one launch.
// The TPU grid walks the r-1 residues in order and carries the two BEHZ
// sums in VMEM scratch; here blocks run in no order, so the tail waits for
// every residue's inverse behind a grid barrier, in one cooperative launch
// of rk clusters of B blocks (one per kept residue, B = 8 by the launchers'
// rule: 64 blocks at 32k_9q, 120 at 32k_16q):
//   1. the stage inverse's own phases with PRO_MONT (x * sk * 2^-64):
//      inv_phase_a (the local GS stages), a cluster barrier, inv_phase_b
//      (the cross stages in registers, the n^-1 Shoup) into the caller's
//      (rk, n) scratch (2 MB at 32k_9q: it stays in L2);
//   2. a grid barrier (cooperative_groups::this_grid().sync(): the launch
//      carries both the cluster dimension and the cooperative attribute);
//   3. K2's residue loop (behz_sums: K2's Shoup rows, DecTailConsts.k2_rows,
//      every row in turn) and the rounding over the n coefficients,
//      grid-strided over all rk B blocks' threads, into out.
// The launcher (run_cluster with COOP) checks with
// cudaOccupancyMaxActiveClusters that all rk clusters are resident at once
// (two blocks an SM where one is not enough, as every cluster kernel) and
// refuses with cudaErrorCooperativeLaunchTooLarge rather than fall back; a
// B whose n/B buffer passes 128 KB of a block (B = 1 at 2^15) is refused.
// Bound: device memory, 3 rk n u64 read and n written, as kernel 8 plus K2
// less the scratch's round trip; like kernel 8 its time is the latency of
// one cluster's stages, then the tail's.  The host build walks the clusters
// (walk_clusters), then runs the tail.
struct DecFusedArgs {
  const u64* c0;  // (r-1, n)
  u64* out;       // (n,)
  const u64* kr;  // DecTailConsts.k2_rows (r-1, 6)
  const u64* gl;  // DecTailConsts.glob (4,)
  int pow2;
  u64 t, neg_t, nu_t, inv_gt;
};

// WIDE: the tail's wide mod-t strategy (d.pow2 = 2, behz_sums.cuh), a
// template constant so that the other two compile as they did.
template <bool WIDE>
NTT_HD void dec_fused_tail(long long k, const StageIO& io,
                           const DecFusedArgs& d) {
  const int n = 1 << io.logn;
  d.out[k] = dec_round<WIDE>(
      behz_sums<WIDE>(0, (int)k, io.out, d.c0, d.kr, d.gl[0], io.r, n, d.pow2,
                      d.t, d.nu_t),
      d.gl, d.pow2, d.t, d.neg_t, d.nu_t, d.inv_gt);
}

#ifdef __CUDACC__

// One polynomial per cluster of 2^CL blocks (the head of the file), at
// least OCC blocks an SM (ClusterBound).
template <int CL, int OCC>
__global__ void __launch_bounds__(ClusterBound<CL, OCC>::threads,
                                  ClusterBound<CL, OCC>::blocks)
    k_stage_fwd_block(StageIO io, Twiddles tw) {
  extern __shared__ u64 smem[];
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int j = (int)cluster.block_rank(), p = (int)(blockIdx.x >> CL);
  u64* peer[1 << CL];
#pragma unroll
  for (int k = 0; k < (1 << CL); ++k)
    peer[k] = cluster.map_shared_rank(smem, k);
  cluster.sync();  // every block of the cluster has started
  fwd_phase_a<CL>(io, tw, p, j, threadIdx.x, blockDim.x, peer);
  cluster.sync();  // the cross stages' remote writes are visible
  fwd_phase_b<CL>(io, tw, p, j, threadIdx.x, blockDim.x, smem);
}

template <int CL, int OCC>
__global__ void __launch_bounds__(ClusterBound<CL, OCC>::threads,
                                  ClusterBound<CL, OCC>::blocks)
    k_stage_inv_block(StageIO io, Twiddles tw) {
  extern __shared__ u64 smem[];
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int j = (int)cluster.block_rank(), p = (int)(blockIdx.x >> CL);
  u64* peer[1 << CL];
#pragma unroll
  for (int k = 0; k < (1 << CL); ++k)
    peer[k] = cluster.map_shared_rank(smem, k);
  inv_phase_a<CL>(io, tw, p, j, threadIdx.x, blockDim.x, smem);
  cluster.sync();  // every block's local stages are done
  inv_phase_b<CL>(io, tw, p, j, threadIdx.x, blockDim.x, peer);
  cluster.sync();  // no block exits while another reads its shared memory
}

__global__ void k_cross_stage(CrossIO io, Twiddles tw, long long total) {
  const long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (k < total) cross_body(k, io, tw);
}

// Kernel 15: residue p's inverse on a cluster of 2^CL blocks, then, after
// the grid barrier, the tail over every thread of the grid.
template <int CL, int OCC, bool WIDE>
__global__ void __launch_bounds__(ClusterBound<CL, OCC>::threads,
                                  ClusterBound<CL, OCC>::blocks)
    k_decrypt_cluster(StageIO io, Twiddles tw, DecFusedArgs d) {
  extern __shared__ u64 smem[];
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int j = (int)cluster.block_rank(), p = (int)(blockIdx.x >> CL);
  u64* peer[1 << CL];
#pragma unroll
  for (int k = 0; k < (1 << CL); ++k)
    peer[k] = cluster.map_shared_rank(smem, k);
  inv_phase_a<CL>(io, tw, p, j, threadIdx.x, blockDim.x, smem);
  cluster.sync();  // every block's local stages are done
  inv_phase_b<CL>(io, tw, p, j, threadIdx.x, blockDim.x, peer);
  // every residue is in the scratch, and no block exits while a peer
  // reads its shared memory
  cooperative_groups::this_grid().sync();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long k = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       k < (1ll << io.logn); k += stride)
    dec_fused_tail<WIDE>(k, io, d);
}

template <int CL, bool WIDE>
static int run_decrypt(const StageIO& io, const Twiddles& tw,
                       const DecFusedArgs& d, void* stream) {
  return run_cluster<CL, u64, true>(k_decrypt_cluster<CL, 1, WIDE>,
                                    k_decrypt_cluster<CL, wide_occ(CL), WIDE>,
                                    io.r, io.logn, 1, stream, io, tw, d);
}

template <int CL>
static int run_forward(const StageIO& io, const Twiddles& tw, int P,
                       void* stream) {
  return run_cluster<CL>(k_stage_fwd_block<CL, 1>,
                         k_stage_fwd_block<CL, wide_occ(CL)>, P, io.logn, 1,
                         stream, io, tw);
}

template <int CL>
static int run_inverse(const StageIO& io, const Twiddles& tw, int P,
                       void* stream) {
  return run_cluster<CL>(k_stage_inv_block<CL, 1>,
                         k_stage_inv_block<CL, wide_occ(CL)>, P, io.logn, 1,
                         stream, io, tw);
}

template <typename K, typename IO>
static int launch_pairs(K kernel, long long total, void* stream, IO io,
                        Twiddles tw) {
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(io, tw,
                                                                  total);
  return (int)cudaGetLastError();
}

#else  // host build for the CPU tests: one thread per block, blocks in order

// Each cluster in turn (walk_clusters): phase A of its B blocks, then
// phase B of each.
template <int CL>
static int run_forward(const StageIO& io, const Twiddles& tw, int P, void*) {
  walk_clusters<CL>(P, 2, (size_t)1 << (io.logn - CL),
                    [&](int ph, int p, int j, u64* const* peer) {
                      if (ph == 0)
                        fwd_phase_a<CL>(io, tw, p, j, 0, 1, peer);
                      else
                        fwd_phase_b<CL>(io, tw, p, j, 0, 1, peer[j]);
                    });
  return 0;
}

template <int CL>
static int run_inverse(const StageIO& io, const Twiddles& tw, int P, void*) {
  walk_clusters<CL>(P, 2, (size_t)1 << (io.logn - CL),
                    [&](int ph, int p, int j, u64* const* peer) {
                      if (ph == 0)
                        inv_phase_a<CL>(io, tw, p, j, 0, 1, peer[j]);
                      else
                        inv_phase_b<CL>(io, tw, p, j, 0, 1, peer);
                    });
  return 0;
}

// Kernel 15: every residue's cluster, then the tail.
template <int CL, bool WIDE>
static int run_decrypt(const StageIO& io, const Twiddles& tw,
                       const DecFusedArgs& d, void*) {
  run_inverse<CL>(io, tw, io.r, nullptr);
  for (long long k = 0; k < (1ll << io.logn); ++k)
    dec_fused_tail<WIDE>(k, io, d);
  return 0;
}

#endif

// One direction's launch at cluster size 2^cl.
static int run_stage(bool inverse, const StageIO& io, const Twiddles& tw,
                     int P, int cl, void* stream) {
  typedef int (*Run)(const StageIO&, const Twiddles&, int, void*);
  static const Run runs[2][4] = {
      {run_forward<0>, run_forward<1>, run_forward<2>, run_forward<3>},
      {run_inverse<0>, run_inverse<1>, run_inverse<2>, run_inverse<3>}};
  return runs[inverse][cl](io, tw, P, stream);
}

// The cluster size B (a power of two up to 8) the launchers take for
// polynomials of 2^logn points, or 0 where no B fits.
extern "C" int ntt_stage_cluster_size(int logn) {
  if (logn < 1 || logn > LOG_TRANSFORM_MAX) return 0;
  return 1 << stage_cluster_log(logn);
}

// x, d, y, nu: prologue inputs; out (P, n).  pro: forward_pro().  mod_idx:
// (P,) int32 moduli or null; logc, shard: the coefficient shard (0, 0).
// cluster: B, or 0 for ntt_stage_cluster_size's.
extern "C" int ntt_stage_forward_cluster(
    const void* x, const void* d, const void* y, const void* nu, void* out,
    const void* psi, const void* psi_sh, const void* ipsi,
    const void* ipsi_sh, const void* consts, int pro, int P, int r, int logn,
    const void* mod_idx, int logc, int shard, int cluster, void* stream) {
  const int cl = cluster_log(cluster, logn);
  if (!stage_args_ok(pro, P, r, 1, logn, mod_idx, logc, shard) ||
      !forward_pro(pro) || cl < 0)
    return NTT_EINVAL;
  const StageIO io = stage_io(x, d, y, nullptr, nu, out, pro, 1, r, logn,
                              mod_idx, logc, shard);
  return run_stage(false, io, make_tw(psi, psi_sh, ipsi, ipsi_sh, consts),
                   P, cl, stream);
}

extern "C" int ntt_stage_forward(const void* x, const void* d, const void* y,
                                 const void* nu, void* out, const void* psi,
                                 const void* psi_sh, const void* ipsi,
                                 const void* ipsi_sh, const void* consts,
                                 int pro, int P, int r, int logn,
                                 const void* mod_idx, int logc, int shard,
                                 void* stream) {
  return ntt_stage_forward_cluster(x, d, y, nu, out, psi, psi_sh, ipsi,
                                   ipsi_sh, consts, pro, P, r, logn, mod_idx,
                                   logc, shard, 0, stream);
}

// x, y, e: prologue and epilogue inputs; out (P, n).  pro: inverse_pro();
// ny: PRO_MONT's y rows, PRO_KSACC's digit count k.  mod_idx, logc, shard,
// cluster as the forward's (no e with mod_idx).
extern "C" int ntt_stage_inverse_cluster(
    const void* x, const void* y, const void* e, void* out, const void* psi,
    const void* psi_sh, const void* ipsi, const void* ipsi_sh,
    const void* consts, int pro, int ny, int P, int r, int logn,
    const void* mod_idx, int logc, int shard, int cluster, void* stream) {
  const int cl = cluster_log(cluster, logn);
  if (!stage_args_ok(pro, P, r, ny, logn, mod_idx, logc, shard) ||
      !inverse_pro(pro) || (mod_idx && e) || cl < 0)
    return NTT_EINVAL;
  const StageIO io = stage_io(x, nullptr, y, e, nullptr, out, pro, ny, r,
                              logn, mod_idx, logc, shard);
  return run_stage(true, io, make_tw(psi, psi_sh, ipsi, ipsi_sh, consts),
                   P, cl, stream);
}

extern "C" int ntt_stage_inverse(const void* x, const void* y, const void* e,
                                 void* out, const void* psi,
                                 const void* psi_sh, const void* ipsi,
                                 const void* ipsi_sh, const void* consts,
                                 int pro, int ny, int P, int r, int logn,
                                 const void* mod_idx, int logc, int shard,
                                 void* stream) {
  return ntt_stage_inverse_cluster(x, y, e, out, psi, psi_sh, ipsi, ipsi_sh,
                                   consts, pro, ny, P, r, logn, mod_idx, logc,
                                   shard, 0, stream);
}

#ifdef __CUDACC__

// One cross-shard stage of a shard's (P, n) polynomials x with its
// partner's, into out; w: the stage's twiddle index, the tables the full
// (r, 2^logc n) ones.
extern "C" int ntt_cross_stage(const void* x, const void* partner, void* out,
                               const void* psi, const void* psi_sh,
                               const void* ipsi, const void* ipsi_sh,
                               const void* consts, int inverse, int u_side,
                               int w, int P, int r, int logn, int logc,
                               void* stream) {
  if (!cross_args_ok(w, P, r, logn, logc)) return (int)cudaErrorInvalidValue;
  const CrossIO io = {(const u64*)x, (const u64*)partner, (u64*)out,
                      inverse,       u_side,              w,
                      r,             logn,                logc};
  return launch_pairs(k_cross_stage, (long long)P << logn, stream, io,
                      make_tw(psi, psi_sh, ipsi, ipsi_sh, consts));
}

#else  // host build

extern "C" int ntt_cross_stage(const void* x, const void* partner, void* out,
                               const void* psi, const void* psi_sh,
                               const void* ipsi, const void* ipsi_sh,
                               const void* consts, int inverse, int u_side,
                               int w, int P, int r, int logn, int logc,
                               void*) {
  if (!cross_args_ok(w, P, r, logn, logc)) return 1;
  const CrossIO io = {(const u64*)x, (const u64*)partner, (u64*)out,
                      inverse,       u_side,              w,
                      r,             logn,                logc};
  const Twiddles tw = make_tw(psi, psi_sh, ipsi, ipsi_sh, consts);
  for (long long k = 0; k < ((long long)P << logn); ++k) cross_body(k, io, tw);
  return 0;
}

#endif

// Kernel 15: x, sk, c0 (rk, n), scratch (rk, n), out (n,), the rk kept
// moduli's tables, DecTailConsts' k2_rows and glob, its mod-t strategy
// (pow2: 1 pow2 t, 0 odd t < 2^31, 2 wide, decrypt_tail.cu);
// cluster: B, or 0 for ntt_stage_cluster_size's.
extern "C" int ntt_decrypt_fused(const void* x, const void* sk, const void* c0,
                                 void* scratch, void* out, const void* psi,
                                 const void* psi_sh, const void* ipsi,
                                 const void* ipsi_sh, const void* consts,
                                 const void* kr, const void* gl, int rk,
                                 int logn, int pow2, u64 t, u64 neg_t,
                                 u64 nu_t, u64 inv_gt, int cluster,
                                 void* stream) {
  const int cl = cluster_log(cluster, logn);
  if (rk < 1 || cl < 0 || pow2 < 0 || pow2 > 2) return NTT_EINVAL;
  const StageIO io = stage_io(x, nullptr, sk, nullptr, nullptr, scratch,
                              PRO_MONT, rk, rk, logn);
  const DecFusedArgs d = {(const u64*)c0, (u64*)out, (const u64*)kr,
                          (const u64*)gl, pow2,      t,
                          neg_t,          nu_t,      inv_gt};
  typedef int (*Run)(const StageIO&, const Twiddles&, const DecFusedArgs&,
                     void*);
  static const Run runs[2][4] = {
      {run_decrypt<0, false>, run_decrypt<1, false>, run_decrypt<2, false>,
       run_decrypt<3, false>},
      {run_decrypt<0, true>, run_decrypt<1, true>, run_decrypt<2, true>,
       run_decrypt<3, true>}};
  return runs[pow2 == 2][cl](io, make_tw(psi, psi_sh, ipsi, ipsi_sh, consts),
                             d, stream);
}
